"""``step.device_ms.b1``: ``step.device_ms`` in the batch-1 cells, where it moves
``pairs_per_s.b1``."""

from benchmark.spec import reader

read = reader("step.device_ms")
