"""``pipeline.data_wait_ms.b1``: ``pipeline.data_wait_ms`` in the batch-1 cells, where it moves
``pairs_per_s.b1``."""

from benchmark.spec import reader

read = reader("pipeline.data_wait_ms")
