"""Coloured stage banners and seeding (counterpart of
``dynamic_video_depth_tpu/utils/printing.py``; reference
util/util_print.py:17-30, util/util_loadlib.py:64-78)."""

from __future__ import annotations

import random

import numpy as np
import torch

_CYAN = "\033[96m"
_BOLD = "\033[1m"
_END = "\033[0m"


def str_stage(msg: str) -> str:
    return f"{_BOLD}{_CYAN}==>{_END} {msg}"


def print_stage(msg: str):
    print(str_stage(msg))


def set_manual_seed(seed: int) -> None:
    """Seed Python's and numpy's global generators and torch's default ones
    (``torch.manual_seed``; no other CUDA state is touched). The nets draw
    their initial weights from a generator of their own, seeded from
    ``--manual_seed`` by the step."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
