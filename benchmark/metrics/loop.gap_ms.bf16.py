"""``loop.gap_ms.bf16``: ``loop.gap_ms`` in the bfloat16 batch-8 cells, where it moves
``pairs_per_s.bf16``."""

from benchmark.spec import reader

read = reader("loop.gap_ms")
