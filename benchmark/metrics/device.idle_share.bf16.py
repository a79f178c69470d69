"""``device.idle_share.bf16``: ``device.idle_share`` in the bfloat16 batch-8 cells, where it moves
``pairs_per_s.bf16``."""

from benchmark.spec import reader

read = reader("device.idle_share")
