"""``field.roofline.bf16``: ``field.roofline`` in the bfloat16 batch-8 cells, where it moves
``pairs_per_s.bf16``."""

from benchmark.spec import reader

read = reader("field.roofline")
