"""Dataset base class (counterpart of ``dynamic_video_depth_tpu/data/
base.py``; reference datasets/base_dataset.py:20-34).

A dataset is an indexable of numpy batch dicts; device placement and
pipelining live in ``prefetch``. Each dataset adds its own flags through
``add_arguments``."""

from __future__ import annotations


class BaseDataset:
    @classmethod
    def add_arguments(cls, parser):
        return parser

    def __init__(self, opt, mode: str = "train"):
        if mode not in ("train", "vali"):
            raise ValueError(f"mode {mode!r}")
        self.opt = opt
        self.mode = mode

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError
