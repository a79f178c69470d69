"""``field.roofline.b1``: ``field.roofline`` in the batch-1 cells, where it moves
``pairs_per_s.b1``."""

from benchmark.spec import reader

read = reader("field.roofline")
