"""``step.mfu.b1``: ``step.mfu`` in the batch-1 cells, where it moves
``pairs_per_s.b1``."""

from benchmark.spec import reader

read = reader("step.mfu")
