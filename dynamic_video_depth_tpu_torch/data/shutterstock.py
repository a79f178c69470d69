"""ShutterStock track dataset (counterpart of
``dynamic_video_depth_tpu/data/shutterstock.py``; reference
datasets/shutterstock.py).

The DAVIS reader with the ShutterStock data root. An integer ``track_id``
selects a track by its index among the sorted track directories
(reference datasets/shutterstock.py:40-43), modulo their number; the
options then carry the track's name.
"""

from __future__ import annotations

from glob import glob
from os.path import basename, join

from . import davis_sequence


class Dataset(davis_sequence.Dataset):
    data_root = "./datafiles/shutterstock"

    def __init__(self, opt, mode: str = "train"):
        track = opt.track_id
        if track.isdigit():
            root = opt.data_root or self.data_root
            names = [basename(t) for t in
                     sorted(glob(join(root, self.frame_prefix, "*")))]
            if names:
                opt.track_id = names[int(track) % len(names)]
        super().__init__(opt, mode)
