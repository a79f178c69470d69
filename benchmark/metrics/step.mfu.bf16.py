"""``step.mfu.bf16``: ``step.mfu`` in the bfloat16 batch-8 cells, where it moves
``pairs_per_s.bf16``."""

from benchmark.spec import reader

read = reader("step.mfu")
