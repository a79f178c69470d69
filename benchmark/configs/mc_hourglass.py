"""Plain reference of the MannequinChallenge hourglass (Li et al., CVPR
2019; google/mannequinchallenge ``models/hourglass.py``): the inception
hourglass at full width, in float32 NCHW ``torch.nn`` layers, sized by
``mc_hourglass.json``.

Each inception module is a 1x1 branch beside (1x1 reduce -> k x k) branches,
each conv followed by an affine-free batch norm and a ReLU, concatenated;
each of the four levels sums two branch programs (average pool, inceptions,
the next level, bilinear 2x upsampling with aligned corners). A 7x7 stem
(128 channels, batch norm, ReLU) leads in and a 3x3 conv to one channel
leads out; the depth ``[B,H,W]`` is the exponential of that output. Batch
norms use their running statistics. Parameter names are the reference
checkpoint's (``net_depth.seq.0.weight``, ``net_depth.seq.3.list.0.1.
convs.2.3.weight``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Inception(nn.Module):
    def __init__(self, n_in, config):
        super().__init__()
        (out0,), rest = config[0], config[1:]
        branches = [nn.Sequential(nn.Conv2d(n_in, out0, 1),
                                  nn.BatchNorm2d(out0, affine=False),
                                  nn.ReLU())]
        for kernel, reduce, out in rest:
            branches.append(nn.Sequential(
                nn.Conv2d(n_in, reduce, 1),
                nn.BatchNorm2d(reduce, affine=False), nn.ReLU(),
                nn.Conv2d(reduce, out, kernel, padding=(kernel - 1) // 2),
                nn.BatchNorm2d(out, affine=False), nn.ReLU()))
        self.convs = nn.ModuleList(branches)

    def forward(self, x):
        return torch.cat([b(x) for b in self.convs], dim=1)


class Up(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=True)


class Level(nn.Module):
    def __init__(self, level, n_in, cfg):
        super().__init__()
        programs = []
        for program in cfg["levels"][str(level)]:
            width, ops = n_in, []
            for op in program:
                if op[0] == "pool":
                    ops.append(nn.AvgPool2d(2))
                elif op[0] == "up":
                    ops.append(Up())
                elif op[0] == "inc":
                    block = cfg["inceptions"][op[1]]
                    ops.append(Inception(width, block))
                    width = sum(b[-1] for b in block)
                else:
                    ops.append(Level(op[1], width, cfg))
                    width = ops[-1].n_out
            programs.append(nn.Sequential(*ops))
        self.n_out = width
        self.list = nn.ModuleList(programs)

    def forward(self, x):
        return self.list[0](x) + self.list[1](x)


class Hourglass(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        stem = cfg["stem_channels"]
        self.seq = nn.Sequential(nn.Conv2d(3, stem, 7, padding=3),
                                 nn.BatchNorm2d(stem), nn.ReLU(),
                                 Level(4, stem, cfg))
        self.pred_layer = nn.Conv2d(self.seq[3].n_out, 1, 3, padding=1)

    def forward(self, img):
        pred = self.pred_layer(self.seq(img.permute(0, 3, 1, 2)))[:, 0]
        return torch.exp(pred)


class HourglassNet(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.net_depth = Hourglass(cfg)
        self.eval()

    def forward(self, img):
        return self.net_depth(img)


def build(cfg) -> nn.Module:
    return HourglassNet(cfg)
