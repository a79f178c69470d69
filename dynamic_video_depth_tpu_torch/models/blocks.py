"""Reusable network blocks and initializers (counterpart of
``dynamic_video_depth_tpu/models/blocks.py``; reference networks/blocks.py).

Every initializer takes an explicit ``torch.Generator``, so a run's random
weights follow from its seed alone. The leaky-relu 0.2 of the scene-flow
field lives with its one user, ``ops/cuda/mlp_kernel.py``.

``ConvBlock``, ``DoubleConvBlock`` and ``ResConv2DBlock`` run on NCHW
tensors (the nets' layout; the JAX modules are channel-last). Their keys follow the JAX
package's flax paths with ``__`` read as ``.`` (``model.0.conv.weight``,
``norm.running_mean``, ``act.weight``; a weight-normed conv's scale is
``wn.weight``), so ``runtime/weights.py`` carries the JAX parameters over.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.embedding import periodic_embed

Init = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def fans(weight: torch.Tensor):
    """(fan_in, fan_out) of a Linear ``[out, in]`` or Conv ``[out, in, kh,
    kw]`` weight, as torch's init functions count them."""
    receptive = math.prod(weight.shape[2:]) if weight.dim() > 2 else 1
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def kaiming_normal_torch(a: float = 0.0) -> Init:
    """torch's ``kaiming_normal_(mode='fan_in')`` for leaky-relu slope ``a``:
    N(0, 2 / ((1 + a^2) fan_in))."""

    def init(w, generator=None):
        std = math.sqrt(2.0 / (1.0 + a * a) / fans(w)[0])
        with torch.no_grad():
            return w.normal_(0.0, std, generator=generator)

    return init


def lecun_normal() -> Init:
    """N(0, 1 / fan_in): the JAX package's default conv/dense init."""

    def init(w, generator=None):
        with torch.no_grad():
            return w.normal_(0.0, 1.0 / math.sqrt(fans(w)[0]),
                             generator=generator)

    return init


def get_initializer(init_type: str, init_param: float = 0.02,
                    a: float = 0.0) -> Init:
    """Weight-init registry (reference models/netinterface.py
    ``init_weight``): 'normal' = N(0, init_param); 'xavier' =
    xavier_normal_(gain=init_param); 'kaiming' = kaiming_normal_(a, fan_in);
    'orth' = orthogonal_(gain=init_param)."""
    if init_type == "kaiming":
        return kaiming_normal_torch(a)
    if init_type not in ("normal", "xavier", "orth"):
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")

    def init(w, generator=None):
        with torch.no_grad():
            if init_type == "normal":
                return w.normal_(0.0, init_param, generator=generator)
            if init_type == "xavier":
                fi, fo = fans(w)
                std = init_param * math.sqrt(2.0 / (fi + fo))
                return w.normal_(0.0, std, generator=generator)
            return nn.init.orthogonal_(w, gain=init_param,
                                       generator=generator)

    return init


def init_module(module: nn.Module, weight_init: Init,
                generator: Optional[torch.Generator]) -> nn.Module:
    """Draw every Conv/Linear weight of ``module`` from ``weight_init`` (in
    module order) and zero their biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            weight_init(m.weight, generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
    return module


class PReLU(nn.Module):
    """Learnable PReLU, torch ``nn.PReLU()`` semantics: one shared slope,
    initialized 0.25 (reference networks/blocks.py:90-91)."""

    def __init__(self, init_slope: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init_slope))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry (reference networks/blocks.py:83-96); 'prelu'
    has a parameter and is built by ``ConvBlock`` itself."""
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, 0.2)
    if name.startswith("lrelu:"):  # parameterized slope, e.g. 'lrelu:0.01'
        slope = float(name.split(":", 1)[1])
        return lambda x: F.leaky_relu(x, slope)
    if name == "selu":
        return F.selu
    if name == "tanh":
        return torch.tanh
    if name == "none":
        return lambda x: x
    raise ValueError(f"Unsupported activation: {name}")


class PeriodicEmbed(nn.Module):
    """Fourier feature embedding, channel-last (reference
    networks/blocks.py:19-34; ``ops/embedding.py::periodic_embed``)."""

    def __init__(self, max_freq: int = 5, n_freq: int = 4,
                 linspace: bool = True):
        super().__init__()
        self.max_freq, self.n_freq, self.linspace = max_freq, n_freq, linspace

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return periodic_embed(x, self.max_freq, self.n_freq, self.linspace)


class _Scale(nn.Module):
    """The per-output-channel scale of a weight-normed conv."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))


class _ChannelAffine(nn.Module):
    """A layer norm's scale and bias over the channel axis."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))


NORMS = ("none", "batch", "inst", "ln", "weight")


class ConvBlock(nn.Module):
    """Padding, conv, norm, activation (reference Conv2dBlock,
    networks/blocks.py:50-102).

    Reflect or zero padding is applied before a VALID conv, as the
    reference does. Norms: 'none', 'batch' (frozen running statistics),
    'inst' (per-channel over space, no affine), 'ln' (over channels, with
    scale and bias), 'weight' (the conv weight over its per-output-channel
    L2 norm, times a learned scale); the epsilons are the JAX modules'
    (flax's 1e-5 for batch, 1e-6 for instance and layer norm, 1e-12 for the
    weight norm)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 norm: str = "none", activation: str = "relu",
                 pad_type: str = "zero", use_bias: bool = True,
                 kernel_init: Optional[Init] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"Unsupported norm: {norm}")
        if pad_type not in ("reflect", "zero"):
            raise ValueError(f"Unsupported pad_type: {pad_type}")
        self.padding, self.pad_type = padding, pad_type
        self.norm_type, self.activation = norm, activation
        self.conv = nn.Conv2d(in_channels, features, kernel_size,
                              stride=stride, dilation=dilation, bias=use_bias)
        (kernel_init or kaiming_normal_torch(0.2))(self.conv.weight,
                                                    generator)
        if use_bias:
            with torch.no_grad():
                self.conv.bias.zero_()
        if norm == "weight":
            self.wn = _Scale(features)
        elif norm == "batch":
            self.norm = nn.BatchNorm2d(features, eps=1e-5)
        elif norm == "ln":
            self.norm = _ChannelAffine(features)
        self.act = PReLU() if activation == "prelu" else None
        self._act = None if activation == "prelu" else get_activation(
            activation)

    def _weight(self) -> torch.Tensor:
        v = self.conv.weight
        if self.norm_type != "weight":
            return v
        ss = (v * v).sum(dim=(1, 2, 3), keepdim=True)
        return v * torch.rsqrt(ss + 1e-12) * self.wn.weight[:, None, None,
                                                             None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding > 0:
            p = self.padding
            mode = "reflect" if self.pad_type == "reflect" else "constant"
            x = F.pad(x, (p, p, p, p), mode=mode)
        conv = self.conv
        x = F.conv2d(x, self._weight(), conv.bias, conv.stride, 0,
                     conv.dilation)
        if self.norm_type == "batch":  # running statistics in any mode
            n = self.norm
            x = F.batch_norm(x, n.running_mean, n.running_var, n.weight,
                             n.bias, training=False, eps=n.eps)
        elif self.norm_type == "inst":
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
            x = (x - mean) * torch.rsqrt(var + 1e-6)
        elif self.norm_type == "ln":
            mean = x.mean(dim=1, keepdim=True)
            var = (x - mean).square().mean(dim=1, keepdim=True)
            x = (x - mean) * torch.rsqrt(var + 1e-6)
            x = (x * self.norm.weight[:, None, None]
                 + self.norm.bias[:, None, None])
        return self.act(x) if self.act is not None else self._act(x)


class DoubleConvBlock(nn.Module):
    """Two stacked ``ConvBlock``s of the same settings (reference
    DoubleConv2dBlock, networks/blocks.py:37-47)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 generator: Optional[torch.Generator] = None, **kw):
        super().__init__()
        self.model = nn.ModuleList([
            ConvBlock(in_channels, features, kernel_size,
                      generator=generator, **kw),
            ConvBlock(features, features, kernel_size, generator=generator,
                      **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model[1](self.model[0](x))


class ResConv2DBlock(nn.Module):
    """``DoubleConvBlock``'s two ``ConvBlock``s plus a skip: the input
    itself, or a learned 1x1 ``ConvBlock`` (padding 0) when the widths
    differ (reference ResConv2DBlock, networks/blocks.py:102-123, which
    never ran: the JAX package's working form, keys ``model.{0,1}`` and
    ``skip``)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None, **kw):
        super().__init__()
        self.skip = None
        if in_channels != features:
            self.skip = ConvBlock(in_channels, features, 1,
                                  generator=generator, **dict(kw, padding=0))
        self.model = nn.ModuleList([
            ConvBlock(in_channels, features, kernel_size,
                      generator=generator, **kw),
            ConvBlock(features, features, kernel_size, generator=generator,
                      **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.skip is None else self.skip(x)
        return self.model[1](self.model[0](x)) + res
