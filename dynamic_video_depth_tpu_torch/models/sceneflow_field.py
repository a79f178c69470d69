"""Scene-flow field network (counterpart of
``dynamic_video_depth_tpu/models/sceneflow_field.py``).

A coordinate MLP: Fourier-embed the world point and time, then
``n_layers + 2`` dense layers (132 -> 256 -> 256 x4 -> 3 at the canonical
width) with leaky-relu 0.2 between them. The whole query runs through the
embedded-MLP kernel (``ops/cuda/mlp_kernel.py``) on a CUDA tensor and its
plain version on a CPU tensor; ``chain`` runs a whole Euler integration
through kernel C (``ops/cuda/chain_kernel.py``). Parameter keys follow the
reference's ``convs.<i>.conv.{weight,bias}`` (the JAX package's
``convs__<i>__conv``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.cuda.chain_kernel import mlp_embed_chain
from ..ops.cuda.mlp_kernel import mlp_embed
from .blocks import get_initializer, init_module


class _Layer(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.conv = nn.Linear(n_in, n_out)


class SceneFlowFieldNet(nn.Module):
    """Maps world points ``[..., 3]`` (+ time ``[..., 1]``) to scene-flow
    vectors ``[..., output_dim]``."""

    def __init__(self, time_dependent: bool = True, n_freq_xyz: int = 0,
                 n_freq_t: int = 0, output_dim: int = 3, net_width: int = 32,
                 n_layers: int = 3, init_type: str = "kaiming",
                 init_param: float = 0.01,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.time_dependent = time_dependent
        self.n_freq_xyz = n_freq_xyz
        self.n_freq_t = n_freq_t
        width = 3 * (1 + 2 * n_freq_xyz)
        if time_dependent:
            width += 1 + 2 * n_freq_t
        dims = [width] + [net_width] * (n_layers + 1) + [output_dim]
        self.convs = nn.ModuleList(
            _Layer(a, b) for a, b in zip(dims[:-1], dims[1:]))
        init_module(self, get_initializer(init_type, init_param, a=0.2),
                    generator)

    def forward(self, pts: torch.Tensor,
                ts: Optional[torch.Tensor] = None) -> torch.Tensor:
        if ts is None:
            if self.time_dependent:
                raise ValueError("time_dependent net requires a time input")
            ts = torch.zeros_like(pts[..., :1])
        lead = pts.shape[:-1]
        layers = [layer.conv for layer in self.convs]
        out = mlp_embed(pts.reshape(-1, 3), ts.reshape(-1, 1),
                        [l.weight for l in layers], [l.bias for l in layers],
                        self.n_freq_xyz, self.n_freq_t, self.time_dependent)
        return out.reshape(*lead, -1)

    def chain(self, pts: torch.Tensor, ts: torch.Tensor, dt: torch.Tensor,
              n_steps: int, n_evals: int, sf_div: float):
        """Euler-integrate the field from ``pts [N,3]``, ``ts``/``dt [N,1]``
        (zeros for a time-independent field) over ``n_evals`` evaluations,
        each divided by ``sf_div``: ``(sum of the first n_steps, first,
        second)`` evaluation, each ``[N,3]``."""
        layers = [layer.conv for layer in self.convs]
        return mlp_embed_chain(pts, ts, dt, [l.weight for l in layers],
                               [l.bias for l in layers], self.n_freq_xyz,
                               self.n_freq_t, self.time_dependent, n_steps,
                               n_evals, sf_div)
