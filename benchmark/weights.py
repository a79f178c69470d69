"""The weights of a run, made on the device from the seed.

Every convolution or dense weight is drawn from one ``torch.randn`` call of
a generator on the device, seeded with the run's seed, and scaled to
``N(0, gain^2 / fan_in)`` (``gain`` from the configuration's ``init``: 1 for
the depth net, as the port's LeCun init; ``sqrt(2 / 1.04)`` for the field,
torch's Kaiming init for leaky-ReLU 0.2); biases are 0 and batch norms are
at identity (weight 1, bias 0, mean 0, variance 1). ``init.set`` then fixes
single leaves (MiDaS's output bias). The leaves and their shapes come from
the plain reference nets, so the program must hold exactly the published
architecture to load them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

def field_shapes(field: dict) -> Dict[str, tuple]:
    """The scene-flow field's leaves: ``convs.<i>.conv.{weight,bias}``."""
    width = 3 * (1 + 2 * field["n_freq_xyz"])
    if field["time_dependent"]:
        width += 1 + 2 * field["n_freq_t"]
    dims = ([width] + [field["net_width"]] * (field["n_layers"] + 1)
            + [field["output_dim"]])
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"convs.{i}.conv.weight"] = (b, a)
        out[f"convs.{i}.conv.bias"] = (b,)
    return out


def _leaf_plan(depth_net: nn.Module, field: dict):
    """``(key, shape, kind)`` for every leaf: kind ``'draw'`` (a weight),
    ``'zero'`` or ``'one'``."""
    plan = []
    for name, mod in depth_net.named_modules():
        prefix = f"depth.{name}." if name else "depth."
        own = dict(mod.named_parameters(recurse=False))
        own.update(mod.named_buffers(recurse=False))
        state = mod.state_dict(keep_vars=True)
        for leaf, t in own.items():
            if leaf not in state:  # a buffer the checkpoint does not hold
                continue
            if isinstance(mod, nn.BatchNorm2d):
                kind = "one" if leaf in ("weight", "running_var") else "zero"
            elif leaf == "weight" and t.dim() >= 2:
                kind = "draw"
            else:
                kind = "zero"
            plan.append((prefix + leaf, tuple(t.shape), kind, t.dtype))
    for key, shape in field_shapes(field).items():
        plan.append(("field." + key, shape,
                     "draw" if key.endswith("weight") else "zero",
                     torch.float32))
    return plan


def make_weights(config: dict, depth_net: nn.Module, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """``{'depth.<key>': ..., 'field.<key>': ...}`` on ``device``."""
    plan = _leaf_plan(depth_net, config["field"])
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s, kind, _ in plan if kind == "draw")
    draws = torch.randn(total, generator=gen, device=device)
    gains = config["init"]
    out, offset = {}, 0
    for key, shape, kind, dtype in plan:
        if kind == "draw":
            n = math.prod(shape)
            fan_in = math.prod(shape[1:])
            gain = gains["field_weight_gain" if key.startswith("field.")
                         else "depth_weight_gain"]
            out[key] = (draws[offset:offset + n] * (gain / math.sqrt(fan_in))
                        ).view(shape)
            offset += n
        elif kind == "one":
            out[key] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
    for key, value in gains["set"].items():
        out["depth." + key].fill_(value)
    return out


def split(weights: Dict[str, torch.Tensor], prefix: str):
    """The state dict of one net: ``prefix`` (``'depth.'``, ``'field.'``)
    taken off the keys."""
    return {k[len(prefix):]: v for k, v in weights.items()
            if k.startswith(prefix)}
