"""Dense MLPs, plain and Fourier-embedded with a periodic skip concat
(counterpart of ``dynamic_video_depth_tpu/models/mlp.py``; reference
networks/MLP.py:20-82). Library modules: no path of the package uses them,
and no kernel runs behind them.

Keys follow the JAX modules' names (``model.0.linear.weight``,
``layer_000.linear.weight``); weights are drawn as the JAX package's
default dense init (N(0, 1/fan_in)), biases are zero (the embedded MLP's
output bias ``init_val`` when given).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import PeriodicEmbed, get_activation, init_module, lecun_normal


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.linear = nn.Linear(n_in, n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class MLP(nn.Module):
    """``depth`` hidden layers of ``width`` and an output layer (reference
    networks/MLP.py:52-63); ``in_ch`` is the input's last axis."""

    def __init__(self, in_ch: int, out_ch: int = 3, depth: int = 3,
                 width: int = 64, activation: str = "relu",
                 output_activation: str = "none",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_ch] + [width] * depth + [out_ch]
        self.model = nn.ModuleList(
            _Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.act = get_activation(activation)
        self.output_act = get_activation(output_activation)
        init_module(self, lecun_normal(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.model[:-1]:
            x = self.act(layer(x))
        return self.output_act(self.model[-1](x))


class EmbeddedMLP(nn.Module):
    """Power-of-two Fourier embedding, then ``depth`` hidden layers and an
    output layer, the embedding concatenated again before every
    ``skip``-th inner layer (reference EmbededMLP, networks/MLP.py:20-49);
    leaky-relu 0.01 (torch's default slope) by default."""

    def __init__(self, in_ch: int, out_ch: int = 3, depth: int = 3,
                 width: int = 64, n_freq: int = 8, skip: int = 3,
                 activation: str = "lrelu:0.01",
                 output_activation: str = "none",
                 init_val: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip = skip
        self.embed = PeriodicEmbed(max_freq=n_freq, n_freq=n_freq,
                                   linspace=False)
        n_embed = in_ch * (1 + 2 * n_freq)
        self.n_layers = n_layers = depth + 1
        n = n_embed
        for idl in range(n_layers):
            if self._concat(idl):
                n += n_embed
            n_out = out_ch if idl == n_layers - 1 else width
            setattr(self, f"layer_{idl:03d}", _Dense(n, n_out))
            n = n_out
        self.act = get_activation(activation)
        self.output_act = get_activation(output_activation)
        init_module(self, lecun_normal(), generator)
        if init_val is not None:
            with torch.no_grad():
                self.get_submodule(
                    f"layer_{n_layers - 1:03d}").linear.bias.fill_(init_val)

    def _concat(self, idl: int) -> bool:
        return idl % self.skip == 0 and 0 < idl < self.n_layers - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = embed = self.embed(x)
        for idl in range(self.n_layers):
            if self._concat(idl):
                x = torch.cat([x, embed], dim=-1)
            x = getattr(self, f"layer_{idl:03d}")(x)
            x = (self.output_act(x) if idl == self.n_layers - 1
                 else self.act(x))
        return x
