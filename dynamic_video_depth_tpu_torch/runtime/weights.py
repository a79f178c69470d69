"""Carry weights between the JAX package and the port.

The JAX package names its flax modules after the reference's torch keys
with ``.`` written as ``__`` (``dynamic_video_depth_tpu/models/
torch_port.py``). This module maps a flax variable tree, given as nested
dicts of numpy arrays, to a torch state dict of the port and back:

- path ``('net_depth', 'seq__0', 'kernel')`` <-> key ``net_depth.seq.0.weight``;
- conv kernels HWIO <-> OIHW (a grouped kernel ``[kh, kw, cin/g, cout]``
  <-> ``[cout, cin/g, kh, kw]``), dense kernels ``[in, out]`` <-> Linear
  ``[out, in]``;
- batch norm ``scale``/``bias`` <-> ``weight``/``bias`` and batch stats
  ``mean``/``var`` <-> ``running_mean``/``running_var``.

Neither direction imports jax: the caller converts arrays to numpy.

``bias_midas_output`` is a fixture helper for random-weight MiDaS runs.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Mapping[tuple, Any]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def torch_key(path: Tuple[str, ...]) -> str:
    """Flax variable path -> torch state-dict key."""
    *mods, leaf = path
    if leaf not in _LEAF_TO_TORCH:
        raise KeyError(f"unknown flax leaf {leaf!r} at {path}")
    return ".".join(mods).replace("__", ".") + "." + _LEAF_TO_TORCH[leaf]


def _to_torch_layout(value: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel":
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if value.ndim == 2:
            return value.T  # [in, out] -> [out, in]
    return value


def _to_flax_layout(value: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel":
        if value.ndim == 4:
            return value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        if value.ndim == 2:
            return value.T
    return value


def flax_to_state_dict(variables: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` -> torch state dict (float32,
    contiguous). Keys the flax tree has no counterpart for (batch norms'
    ``num_batches_tracked``) are not produced; ``load_flax`` adds them."""
    sd = {}
    for tree in variables.values():
        for path, value in _flatten(tree).items():
            arr = _to_torch_layout(np.asarray(value, np.float32), path[-1])
            sd[torch_key(path)] = torch.tensor(arr)
    return sd


def load_flax(module: nn.Module, variables: Mapping[str, Mapping]) -> nn.Module:
    """Load JAX-package variables into a port module with ``strict=True``;
    every parameter and buffer must be covered (batch-norm step counters,
    which flax does not keep, are taken from the module itself)."""
    sd = flax_to_state_dict(variables)
    for key, value in module.state_dict().items():
        if key.endswith("num_batches_tracked") and key not in sd:
            sd[key] = value
    module.load_state_dict(sd, strict=True)
    return module


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor],
                       template: Mapping[str, Mapping]) -> Dict[str, Dict]:
    """Torch state dict -> flax variables shaped like ``template`` (e.g. the
    JAX module's ``init``). Every template leaf must find its key, and every
    key but the batch-norm step counters must be used."""
    out, used = {}, set()
    for collection, tree in template.items():
        flat = {}
        for path, leaf in _flatten(tree).items():
            key = torch_key(path)
            if key not in state_dict:
                raise KeyError(f"state dict has no {key!r} for {path}")
            value = state_dict[key].detach().cpu().numpy()
            value = _to_flax_layout(value, path[-1])
            if tuple(value.shape) != tuple(np.shape(leaf)):
                raise ValueError(f"{key}: shape {value.shape} does not fit "
                                 f"{tuple(np.shape(leaf))}")
            flat[path] = np.ascontiguousarray(value)
            used.add(key)
        out[collection] = _unflatten(flat)
    extra = [k for k in state_dict
             if k not in used and not k.endswith("num_batches_tracked")]
    if extra:
        raise KeyError(f"state dict keys with no flax leaf: {extra[:5]}")
    return out


MIDAS_OUTPUT_BIAS = "scratch.output_conv.4.bias"


def bias_midas_output(net: nn.Module, bias: float = 200.0) -> nn.Module:
    """Set the MiDaS output conv's bias to ``bias`` so that a net with
    random weights predicts depth near ``10000 / bias`` (about 50 at 200).

    Random MiDaS weights put the output near 0, so the depth
    ``10000 / clamp(out, 1e-2)`` is about 1e6 and every pixel fails the MiDaS
    far-field masks (``< 100``): the loss is exactly 0 and nothing trains.
    For test fixtures and smoke runs only; the trainer never calls it (a
    pretrained checkpoint puts the depth in range)."""
    with torch.no_grad():
        net.state_dict()[MIDAS_OUTPUT_BIAS].fill_(bias)
    return net
