"""``pipeline.data_wait_ms.bf16``: ``pipeline.data_wait_ms`` in the bfloat16 batch-8 cells, where it moves
``pairs_per_s.bf16``."""

from benchmark.spec import reader

read = reader("pipeline.data_wait_ms")
