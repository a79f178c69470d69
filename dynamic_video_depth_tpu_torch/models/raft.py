"""RAFT optical flow (counterpart of ``dynamic_video_depth_tpu/models/
raft.py``; Teed & Deng, ECCV 2020), the compute of preprocessing stage 2.

Feature and context encoders at 1/8 resolution, an all-pairs correlation
pyramid, a ConvGRU update operator and convex upsampling. The nets run in
NCHW with plain ``nn.Conv2d``; the public functions keep the JAX package's
channel-last layouts so that the tests compare like with like.

Keys follow the official checkpoint with its ``module.`` prefix removed
(``fnet.layer2.0.conv1``, ``cnet.norm1.running_mean``,
``update_block.gru.convz1``, ``update_block.mask.0``), which are the JAX
package's flax paths with ``__`` read as ``.``; ``runtime/weights.py``
carries either across with ``strict=True``.

- The all-pairs product ``[N, C] @ [C, N] / sqrt(C)`` is ``torch.matmul``
  and the pyramid pooling ``F.avg_pool2d`` (2x2, floor), as the JAX package
  leaves both to XLA.
- The lookup of every iteration is ``ops/cuda/corr_kernel.py``: the
  hand-written kernel on a CUDA tensor, its plain gather on the CPU.
- The flow is upsampled once, after the last iteration; the JAX package
  upsamples on every iteration and keeps the last, which is the same value.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.corr_kernel import lookup_correlation
from .blocks import init_module, lecun_normal


def _norm(kind: str, planes: int) -> nn.Module:
    if kind == "instance":  # no parameters, no running statistics
        return nn.InstanceNorm2d(planes)
    if kind == "batch":
        return nn.BatchNorm2d(planes)
    raise ValueError(kind)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride),
                _norm(norm, planes))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Instance norm for ``fnet``, batch norm (frozen statistics) for
    ``cnet``."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm, 1),
                                    ResidualBlock(64, 64, norm, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm, 2),
                                    ResidualBlock(96, 96, norm, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm, 2),
                                    ResidualBlock(128, 128, norm, 1))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


def correlation_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                        num_levels: int = 4) -> List[torch.Tensor]:
    """All-pairs correlation and its average-pooled pyramid: ``fmap*
    [B, H, W, C]`` -> levels ``[B, H W, H / 2^l, W / 2^l]``."""
    b, h, w, c = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, h * w, c),
                        fmap2.reshape(b, h * w, c).transpose(1, 2))
    corr = (corr / float(c) ** 0.5).reshape(b * h * w, 1, h, w)
    pyramid = [corr.reshape(b, h * w, h, w)]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr.reshape(b, h * w, corr.shape[2], corr.shape[3]))
    return pyramid


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int = 4 * 81):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """Separable (1x5 then 5x1) ConvGRU of the basic update block."""

    def __init__(self, hidden: int = 128, input_dim: int = 128 + 128):
        super().__init__()
        total = hidden + input_dim
        for suffix, kernel, pad in (("1", (1, 5), (0, 2)),
                                    ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{suffix}",
                        nn.Conv2d(total, hidden, kernel, padding=pad))

    def _pass(self, h, x, suffix: str):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
        r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
        q = torch.tanh(getattr(self, f"convq{suffix}")(
            torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        return self._pass(self._pass(h, x, "1"), x, "2")


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, h):
        return self.conv2(F.relu(self.conv1(h)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden, input_dim=128 + hidden)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(nn.Conv2d(hidden, 256, 3, padding=1),
                                  nn.ReLU(), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        """NCHW in and out: ``(net, 0.25 * mask, delta)``."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8x convex-combination upsampling: ``flow [B, H, W, 2]``, ``mask
    [B, H, W, 576]`` -> ``[B, 8H, 8W, 2]``."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, 8, 8), dim=3)
    pad = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    neighbors = torch.stack([pad[:, i:i + h, j:j + w]
                             for i in range(3) for j in range(3)], dim=3)
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", mask, neighbors)
    # (b, h, w, u, v, c) -> (b, h, u, w, v, c): row 8h + u, column 8w + v
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


class RAFT(nn.Module):
    """The full network. ``forward(image1, image2, iters)`` takes images
    ``[B, H, W, 3]`` in [0, 255] (H, W multiples of 8) and returns the
    1/8-resolution flow ``[B, H/8, W/8, 2]`` and the upsampled flow ``[B, H,
    W, 2]``. It runs in eval mode only: ``cnet``'s batch norms use their
    frozen statistics."""

    def __init__(self, hidden_dim: int = 128, context_dim: int = 128,
                 corr_levels: int = 4, corr_radius: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.update_block = BasicUpdateBlock(hidden_dim)
        init_module(self, lecun_normal(), generator)
        self.eval()

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 20):
        if self.training:
            raise RuntimeError("RAFT runs in eval mode only: its batch norms "
                               "use frozen statistics")
        if iters < 1:
            raise ValueError(f"iters={iters}: RAFT needs at least one")
        image1 = (2.0 * (image1 / 255.0) - 1.0).permute(0, 3, 1, 2)
        image2 = (2.0 * (image2 / 255.0) - 1.0).permute(0, 3, 1, 2)
        b = image1.shape[0]
        fmaps = self.fnet(torch.cat([image1, image2], dim=0))
        fmaps = fmaps.permute(0, 2, 3, 1)
        pyramid = correlation_pyramid(fmaps[:b], fmaps[b:], self.corr_levels)

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])

        h8, w8 = fmaps.shape[1:3]
        ys, xs = torch.meshgrid(
            torch.arange(h8, dtype=image1.dtype, device=image1.device),
            torch.arange(w8, dtype=image1.dtype, device=image1.device),
            indexing="ij")
        coords0 = torch.stack([xs, ys], dim=-1)[None].expand(b, -1, -1, -1)
        coords1 = coords0
        for _ in range(iters):
            corr = lookup_correlation(pyramid, coords1, self.corr_radius)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, mask, delta = self.update_block(
                net, inp, corr.permute(0, 3, 1, 2), flow)
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
        flow8 = coords1 - coords0
        return flow8, convex_upsample(flow8, mask.permute(0, 2, 3, 1))
