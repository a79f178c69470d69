"""``depth_net.roofline.bf16``: ``depth_net.roofline`` in the bfloat16 batch-8 cells, where it moves
``pairs_per_s.bf16``."""

from benchmark.spec import reader

read = reader("depth_net.roofline")
