"""MannequinChallenge inception-hourglass depth net (counterpart of
``dynamic_video_depth_tpu/models/hourglass.py``; reference
third_party/hourglass.py).

The plain reference structure in NCHW: each inception is a 1x1 branch plus
(1x1 -> k x k) branches with affine-free batch norms, concatenated; each
level sums two branch programs. The JAX package's TPU layouts (space-to-depth
regions, merged reducer convs) are not carried over. Batch norms always run
on their frozen running statistics (the reference keeps the depth net in
``eval()`` for the whole optimization); ``forward`` enforces it.

Public layout: images ``[B,H,W,3]`` in, depth ``[B,H,W]`` out (``exp`` of
the prediction). Keys follow the reference checkpoint
(``net_depth.seq.0.weight``, ``net_depth.seq.3.list.0.1.convs.2.3.weight``,
...), the JAX package's flax paths with ``__`` read as ``.``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import init_module, lecun_normal

# Inception branch configs (reference third_party/hourglass.py:60-158):
# (out,) for the 1x1 branch, (kernel, reduce, out) for the others.
_E = ((64,), (3, 32, 64), (5, 32, 64), (7, 32, 64))        # 256 out
_F = ((64,), (3, 64, 64), (7, 64, 64), (11, 64, 64))       # 256 out
_G = ((32,), (3, 32, 32), (5, 32, 32), (7, 32, 32))        # 128 out
_BC2 = ((32,), (3, 64, 32), (7, 64, 32), (11, 64, 32))     # 128 out
_A4 = ((32,), (3, 64, 32), (5, 64, 32), (7, 64, 32))       # 128 out
_A16 = ((16,), (3, 32, 16), (7, 32, 16), (11, 32, 16))     # 64 out
_A = ((16,), (3, 64, 16), (7, 64, 16), (11, 64, 16))       # 64 out

# Per-level branch programs, in the reference's ModuleList order.
_STAGES = {
    1: (
        (("inc", _E), ("inc", _E)),
        (("pool",), ("inc", _E), ("inc", _E), ("inc", _E), ("up",)),
    ),
    2: (
        (("inc", _E), ("inc", _F)),
        (("pool",), ("inc", _E), ("inc", _E), ("stage", 1), ("inc", _E),
         ("inc", _F), ("up",)),
    ),
    3: (
        (("pool",), ("inc", _G), ("inc", _E), ("stage", 2), ("inc", _E),
         ("inc", _G), ("up",)),
        (("inc", _G), ("inc", _BC2)),
    ),
    4: (
        (("pool",), ("inc", _G), ("inc", _G), ("stage", 3), ("inc", _A4),
         ("inc", _A16), ("up",)),
        (("inc", _A),),
    ),
}


def _out_width(config) -> int:
    return sum(cfg[-1] for cfg in config)


class Inception(nn.Module):
    """(reference third_party/hourglass.py:21-57)"""

    def __init__(self, n_in: int, config):
        super().__init__()
        branches = [nn.Sequential(nn.Conv2d(n_in, config[0][0], 1),
                                  nn.BatchNorm2d(config[0][0], affine=False),
                                  nn.ReLU())]
        for kernel, reduce, out in config[1:]:
            branches.append(nn.Sequential(
                nn.Conv2d(n_in, reduce, 1),
                nn.BatchNorm2d(reduce, affine=False),
                nn.ReLU(),
                nn.Conv2d(reduce, out, kernel, padding=(kernel - 1) // 2),
                nn.BatchNorm2d(out, affine=False),
                nn.ReLU(),
            ))
        self.convs = nn.ModuleList(branches)

    def forward(self, x):
        return torch.cat([branch(x) for branch in self.convs], dim=1)


class Stage(nn.Module):
    """One hourglass level: the sum of two branch programs (reference
    Channels1..Channels4)."""

    def __init__(self, level: int, n_in: int):
        super().__init__()
        programs = []
        for program in _STAGES[level]:
            width = n_in
            ops = []
            for op in program:
                if op[0] == "pool":
                    ops.append(nn.AvgPool2d(2))
                elif op[0] == "up":
                    ops.append(nn.UpsamplingBilinear2d(scale_factor=2))
                elif op[0] == "inc":
                    ops.append(Inception(width, op[1]))
                    width = _out_width(op[1])
                else:
                    ops.append(Stage(op[1], width))
                    width = ops[-1].n_out
            programs.append(nn.Sequential(*ops))
        self.n_out = width
        self.list = nn.ModuleList(programs)

    def forward(self, x):
        return self.list[0](x) + self.list[1](x)


class HourglassModel(nn.Module):
    """(reference third_party/hourglass.py:161-188). H and W must be
    divisible by 16 (four 2x poolings)."""

    def __init__(self, noexp: bool = False):
        super().__init__()
        self.noexp = noexp
        self.seq = nn.Sequential(
            nn.Conv2d(3, 128, 7, padding=3),
            nn.BatchNorm2d(128),
            nn.ReLU(),
            Stage(4, 128),
        )
        self.pred_layer = nn.Conv2d(64, 1, 3, padding=1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError("the depth net runs in eval mode only: its "
                               "batch norms use frozen statistics")
        pred = self.pred_layer(self.seq(img.permute(0, 3, 1, 2)))[:, 0]
        return pred if self.noexp else torch.exp(pred)


class HourglassModelEmbed(nn.Module):
    """(reference third_party/hourglass.py:191-212). The per-frame
    embedding of the reference is vestigial (its ``forward`` ignores it):
    ``use_embedding`` and ``n_embedding`` are kept as constructor flags
    without a parameter, as in the JAX package (``--use_embedding``)."""

    def __init__(self, noexp: bool = False, use_embedding: bool = False,
                 n_embedding: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_embedding = use_embedding
        self.n_embedding = n_embedding
        self.net_depth = HourglassModel(noexp=noexp)
        init_module(self, lecun_normal(), generator)
        self.eval()

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.net_depth(img)
