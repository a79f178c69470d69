"""DAVIS track dataset (counterpart of
``dynamic_video_depth_tpu/data/davis_sequence.py``; reference
datasets/davis_sequence.py).

Train mode reads the packed per-pair ``.pt`` batches of the chosen gaps;
vali mode reads the per-frame ``.npz`` files. Each training sample carries
its Euler step count (the gap in time units) under ``steps``.

The flags of JAX ``data/davis_sequence.py:27-42``: ``--repeat`` makes a
train set of ``len(file_list) * repeat`` samples, index ``i`` the file
``i % len(file_list)``, or ``i % capat`` under ``--overfit``; ``--cache``
keeps each sample in host memory after its first read, keyed by that
reduced index; ``--select`` is parsed and selects nothing, as there.
"""

from __future__ import annotations

import re
from glob import glob
from os.path import join

import numpy as np

from .base import BaseDataset
from .batches import frame_batch_from_npz, load_packed_pt, pair_batch_from_packed


class Dataset(BaseDataset):
    data_root = "./datafiles/davis_processed"
    frame_prefix = "frames_midas"
    seq_prefix = "sequences_select_pairs_midas"

    @classmethod
    def add_arguments(cls, parser):
        a = parser.add_argument
        a("--track_id", default="train", type=str, help="the track id to load")
        a("--gaps", type=str, default="1,2,3,4", help="gaps for sequences")
        a("--subsample", action="store_true",
          help="subsample the video in time")
        a("--data_root", type=str, default=None,
          help="override the dataset's default datafiles root")
        a("--cache", action="store_true", help="cache the data into ram")
        a("--overfit", action="store_true",
          help="overfit and see if things works")
        a("--capat", type=int, default=1,
          help="number of samples to overfit to")
        a("--repeat", type=int, default=1, help="number of repeatition")
        a("--select", action="store_true",
          help="kept for the reference's command lines; selects nothing")
        return parser

    def __init__(self, opt, mode: str = "train"):
        super().__init__(opt, mode)
        self._cache = {} if getattr(opt, "cache", False) else None
        data_root = opt.data_root or self.data_root
        self.unit = 2.0 if opt.subsample else 1.0
        frame_dir = join(data_root, self.frame_prefix, opt.track_id)
        frames = sorted(glob(join(frame_dir, "*.npz")))
        self.n_frames = float(len(frames))
        if mode == "train":
            sub = "subsample" if opt.subsample else "001"
            data_path = join(data_root, self.seq_prefix, opt.track_id, sub)
            self.file_list = []
            for g in (int(x) for x in opt.gaps.split(",")):
                self.file_list += sorted(
                    glob(join(data_path, f"shuffle_False_gap_{g:02d}_*.pt")))
        else:
            self.file_list = frames

    def __len__(self):
        if self.mode != "train":
            return len(self.file_list)
        return len(self.file_list) * getattr(self.opt, "repeat", 1)

    def gap_of(self, idx: int) -> int:
        m = re.search(r"gap_(\d+)_",
                      self.file_list[idx % len(self.file_list)])
        return int(m.group(1)) if m else 1

    def __getitem__(self, idx: int):
        if getattr(self.opt, "overfit", False):
            idx = idx % self.opt.capat
        else:
            idx = idx % len(self.file_list)
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        path = self.file_list[idx]
        if self.mode == "train":
            batch = pair_batch_from_packed(load_packed_pt(path),
                                           self.n_frames, self.unit)
            batch["steps"] = max(int(round(self.gap_of(idx) / self.unit)), 1)
        else:
            raw = dict(np.load(path, allow_pickle=True))
            batch = frame_batch_from_npz(raw, idx, self.n_frames, self.unit)
        batch["pair_path"] = path
        if self._cache is not None:
            self._cache[idx] = batch
        return batch
