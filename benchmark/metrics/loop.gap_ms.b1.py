"""``loop.gap_ms.b1``: ``loop.gap_ms`` in the batch-1 cells, where it moves
``pairs_per_s.b1``."""

from benchmark.spec import reader

read = reader("loop.gap_ms")
