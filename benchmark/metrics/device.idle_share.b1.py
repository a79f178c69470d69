"""``device.idle_share.b1``: ``device.idle_share`` in the batch-1 cells, where it moves
``pairs_per_s.b1``."""

from benchmark.spec import reader

read = reader("device.idle_share")
