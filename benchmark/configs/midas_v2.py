"""Plain reference of MiDaS v2 (Ranftl et al., TPAMI 2020; isl-org/MiDaS
v2.0 ``MidasNet``): a ResNeXt101-32x8d encoder and a RefineNet decoder, in
float32 NCHW ``torch.nn`` layers, sized by ``midas_v2.json``.

Images ``[B,H,W,3]`` in [0, 1] are normalized with the ImageNet mean and
deviation; the depth ``[B,H,W]`` is ``10000 / clamp(inverse depth,
1e-2)``, as the reference repository's ``third_party/MiDaS.py`` and
``third_party/midas_blocks.py`` compute it. Two details follow that code:
a residual unit's skip adds ``relu(x)`` (the original's in-place ReLU
overwrites ``x`` before the add), and the one-input fusion block has no
first residual unit. Batch norms use their running statistics (the depth
net stays in ``eval()`` for the whole optimization). Parameter names are
the torch checkpoint's (``pretrained.layer1.0.weight``, ``scratch.
output_conv.4.bias``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride, groups, base_width):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * 4
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


def stage(inplanes, planes, blocks, stride, groups, base_width):
    return nn.Sequential(
        Bottleneck(inplanes, planes, stride, groups, base_width),
        *[Bottleneck(planes * 4, planes, 1, groups, base_width)
          for _ in range(blocks - 1)])


class Encoder(nn.Module):
    def __init__(self, layers, groups, base_width):
        super().__init__()
        kw = dict(groups=groups, base_width=base_width)
        self.layer1 = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            nn.BatchNorm2d(64), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1),
            stage(64, 64, layers[0], 1, **kw))
        self.layer2 = stage(256, 128, layers[1], 2, **kw)
        self.layer3 = stage(512, 256, layers[2], 2, **kw)
        self.layer4 = stage(1024, 512, layers[3], 2, **kw)


class ResidualConvUnit(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        x = F.relu(x)
        return self.conv2(F.relu(self.conv1(x))) + x


class FusionBlock(nn.Module):
    def __init__(self, features, two_inputs):
        super().__init__()
        if two_inputs:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, *xs):
        out = xs[0]
        if len(xs) == 2:
            out = out + self.resConfUnit1(xs[1])
        out = self.resConfUnit2(out)
        return F.interpolate(out, scale_factor=2, mode="bilinear",
                             align_corners=True)


class Upsample(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)


class Decoder(nn.Module):
    def __init__(self, features):
        super().__init__()
        for i, c in enumerate((256, 512, 1024, 2048), 1):
            setattr(self, f"layer{i}_rn",
                    nn.Conv2d(c, features, 3, padding=1, bias=False))
        self.refinenet4 = FusionBlock(features, False)
        self.refinenet3 = FusionBlock(features, True)
        self.refinenet2 = FusionBlock(features, True)
        self.refinenet1 = FusionBlock(features, True)
        self.output_conv = nn.Sequential(
            nn.Conv2d(features, 128, 3, padding=1), Upsample(),
            nn.Conv2d(128, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU())


class MidasV2(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.pretrained = Encoder(cfg["layers"], cfg["groups"],
                                  cfg["width_per_group"])
        self.scratch = Decoder(cfg["features"])
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.eval()

    def forward(self, img):
        x = ((img - self.mean) / self.std).permute(0, 3, 1, 2)
        e = self.pretrained
        l1 = e.layer1(x)
        l2 = e.layer2(l1)
        l3 = e.layer3(l2)
        l4 = e.layer4(l3)
        s = self.scratch
        path = s.refinenet4(s.layer4_rn(l4))
        path = s.refinenet3(path, s.layer3_rn(l3))
        path = s.refinenet2(path, s.layer2_rn(l2))
        path = s.refinenet1(path, s.layer1_rn(l1))
        out = 10000.0 / torch.clamp(s.output_conv(path), min=1e-2)
        return out[:, 0]


def build(cfg) -> nn.Module:
    return MidasV2(cfg)
