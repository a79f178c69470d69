"""MiDaS monocular depth net (counterpart of
``dynamic_video_depth_tpu/models/midas.py``; reference third_party/MiDaS.py
and third_party/midas_blocks.py).

A ResNeXt101-32x8d encoder (stages of 3, 4, 23 and 3 bottlenecks, grouped
3x3 convs of 32 groups) and a RefineNet-style decoder, in NCHW with plain
grouped ``nn.Conv2d``: the JAX package's block-diagonal densification of the
grouped convs is a TPU matrix-unit workaround and is not carried over. Batch
norms always run on their frozen running statistics (the reference keeps the
depth net in ``eval()`` for the whole optimization); ``forward`` enforces it.

Public layout: images ``[B,H,W,3]`` in [0, 1] (H and W multiples of 32),
depth ``[B,H,W]`` out, ``10000 / clamp(inverse depth, 1e-2)``.

Keys follow the torch checkpoint (``pretrained.layer1.0`` is the stem conv,
``pretrained.layer1.4.<i>`` the stage-1 blocks, ``scratch.refinenet4.
resConfUnit2.conv1``, ``scratch.output_conv.4``), the JAX package's flax
paths with ``__`` read as ``.``. As in the JAX package, a fusion block with
one input (``refinenet4``) has no ``resConfUnit1``.

``mask_branch`` and ``freeze_backbone`` give the reference's MidasNet_mod
(third_party/MiDaS.py:44-161), as the JAX module does: a sigmoid mask head
``scratch.output_conv_mask.{0,2,4}`` on the decoder's last path (the net
then returns ``(depth, mask)``), and a backbone whose outputs carry no
gradient (the backbone runs under ``torch.no_grad``, the counterpart of
``stop_gradient``: its parameters get none). The train step uses neither.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.resize import resize_bicubic, upsample2x_nchw
from .blocks import init_module, lecun_normal

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
LAYERS = (3, 4, 23, 3)


class Bottleneck(nn.Module):
    """ResNeXt bottleneck (groups 32, width 8 per group per 64 planes)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 groups: int = 32, base_width: int = 8):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.relu = nn.ReLU()
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


def _stage(inplanes: int, planes: int, blocks: int, stride: int):
    layers = [Bottleneck(inplanes, planes, stride)]
    layers += [Bottleneck(planes * 4, planes) for _ in range(blocks - 1)]
    return nn.Sequential(*layers)


class ResNeXt101Backbone(nn.Module):
    """The encoder, returning the four stage outputs. The stem sits at
    ``layer1.0`` (conv) / ``layer1.1`` (bn) and the stage-1 blocks at
    ``layer1.4`` (reference third_party/midas_blocks.py:35-46)."""

    def __init__(self, layers=LAYERS):
        super().__init__()
        self.layer1 = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            nn.BatchNorm2d(64), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1),
            _stage(64, 64, layers[0], 1))
        self.layer2 = _stage(256, 128, layers[1], 2)
        self.layer3 = _stage(512, 256, layers[2], 2)
        self.layer4 = _stage(1024, 512, layers[3], 2)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        l1 = self.layer1(x)
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        return l1, l2, l3, self.layer4(l3)


class ResidualConvUnit(nn.Module):
    """(reference third_party/midas_blocks.py:102-135; MiDaS v3.0
    ``ResidualConvUnit_custom``). With ``relu_skip`` the skip adds
    ``relu(x)``, not ``x``: MiDaS v2's ``ReLU(inplace=True)`` overwrites
    ``x`` before the add, and its pretrained weights bake that in. The DPT's
    unit (``relu_skip=False``) has a non-inplace ReLU and adds ``x``."""

    def __init__(self, features: int, relu_skip: bool = True):
        super().__init__()
        self.relu_skip = relu_skip
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        res = torch.relu(x)
        out = self.conv2(torch.relu(self.conv1(res)))
        return out + (res if self.relu_skip else x)


class FeatureFusionBlock(nn.Module):
    """(reference third_party/midas_blocks.py:138-168; MiDaS v3.0
    ``FeatureFusionBlock_custom`` with ``relu_skip=False, out_conv=True``:
    its units add ``x`` and a 1x1 ``out_conv`` follows the upsample)."""

    def __init__(self, features: int, two_inputs: bool,
                 relu_skip: bool = True, out_conv: bool = False):
        super().__init__()
        if two_inputs:
            self.resConfUnit1 = ResidualConvUnit(features, relu_skip)
        self.resConfUnit2 = ResidualConvUnit(features, relu_skip)
        self.out_conv = nn.Conv2d(features, features, 1) if out_conv \
            else None

    def forward(self, *xs):
        out = xs[0]
        if len(xs) == 2:
            out = out + self.resConfUnit1(xs[1])
        out = upsample2x_nchw(self.resConfUnit2(out), align_corners=True)
        return out if self.out_conv is None else self.out_conv(out)


class _Upsample2x(nn.Module):
    """The output head's bilinear 2x."""

    def __init__(self, align_corners: bool):
        super().__init__()
        self.align_corners = align_corners

    def forward(self, x):
        return upsample2x_nchw(x, align_corners=self.align_corners)


def output_head(features: int, mid: int, last: nn.Module,
                align_corners: bool = False) -> nn.Sequential:
    """3x3 -> ``mid``, bilinear 2x, 3x3 -> 32, ReLU, 1x1 -> 1, ``last``:
    MiDaS v2's depth head (``output_conv``, ``mid`` 128, the upsample
    without aligned corners) and mask head (``output_conv_mask``), and the
    DPT's depth head (``mid = features // 2``, aligned corners)."""
    return nn.Sequential(
        nn.Conv2d(features, mid, 3, padding=1), _Upsample2x(align_corners),
        nn.Conv2d(mid, 32, 3, padding=1), nn.ReLU(),
        nn.Conv2d(32, 1, 1), last)


class _Scratch(nn.Module):
    def __init__(self, features: int, non_negative: bool,
                 mask_branch: bool):
        super().__init__()
        f = features
        for i, c in enumerate((256, 512, 1024, 2048), 1):
            setattr(self, f"layer{i}_rn",
                    nn.Conv2d(c, f, 3, padding=1, bias=False))
        self.refinenet4 = FeatureFusionBlock(f, two_inputs=False)
        self.refinenet3 = FeatureFusionBlock(f, two_inputs=True)
        self.refinenet2 = FeatureFusionBlock(f, two_inputs=True)
        self.refinenet1 = FeatureFusionBlock(f, two_inputs=True)
        self.output_conv = output_head(
            f, 128, nn.ReLU() if non_negative else nn.Identity())
        if mask_branch:
            self.output_conv_mask = output_head(f, 128, nn.Sigmoid())


class MidasNet(nn.Module):
    """MiDaS v2.1-style depth net (reference third_party/MiDaS.py:164-246).
    ``normalize_input`` applies the ImageNet normalization the train step
    uses; ``resize`` runs the net at that size (bicubic, align_corners) and
    resizes the depth back (and the mask). ``mask_branch`` and
    ``freeze_backbone``: MidasNet_mod (the module docstring)."""

    def __init__(self, features: int = 256, non_negative: bool = True,
                 normalize_input: bool = True,
                 resize: Optional[Tuple[int, int]] = None,
                 mask_branch: bool = False, freeze_backbone: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize_input = normalize_input
        self.resize = resize
        self.mask_branch = mask_branch
        self.freeze_backbone = freeze_backbone
        self.pretrained = ResNeXt101Backbone()
        self.scratch = _Scratch(features, non_negative, mask_branch)
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD),
                             persistent=False)
        init_module(self, lecun_normal(), generator)
        self.eval()

    def forward(self, img: torch.Tensor):
        if self.training:
            raise RuntimeError("the depth net runs in eval mode only: its "
                               "batch norms use frozen statistics")
        x = img
        if self.normalize_input:
            x = (x - self.mean) / self.std
        orig_hw = x.shape[1:3]
        if self.resize is not None:
            x = resize_bicubic(x, self.resize, align_corners=True)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_backbone):
            l1, l2, l3, l4 = self.pretrained(x.permute(0, 3, 1, 2))
        s = self.scratch
        path4 = s.refinenet4(s.layer4_rn(l4))
        path3 = s.refinenet3(path4, s.layer3_rn(l3))
        path2 = s.refinenet2(path3, s.layer2_rn(l2))
        path1 = s.refinenet1(path2, s.layer1_rn(l1))
        out = 10000.0 / torch.clamp(s.output_conv(path1), min=1e-2)
        outs = [out]
        if self.mask_branch:
            outs.append(s.output_conv_mask(path1))
        outs = [o.permute(0, 2, 3, 1) for o in outs]
        if self.resize is not None:
            outs = [resize_bicubic(o, orig_hw, align_corners=True)
                    for o in outs]
        if self.mask_branch:
            return outs[0][..., 0], outs[1][..., 0]
        return outs[0][..., 0]
