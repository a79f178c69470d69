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
  ``mean``/``var`` <-> ``running_mean``/``running_var``;
- a PReLU's ``weight`` <-> ``weight``, and a flax ``WeightNorm``'s scale,
  whose leaf is the wrapped variable's path (``('wn', 'conv/kernel/
  scale')``), by its last part: ``wn.weight``.

Every net of the port loads this way: the depth nets, the scene-flow field
and ``FCNUnet``, and the library ``MLP`` and ``EmbeddedMLP``.

Neither direction imports jax: the caller converts arrays to numpy.

``load_raft_checkpoint`` and ``load_midas_checkpoint`` read the pretrained
torch files of preprocessing, ``load_pretrained_depth`` those of the
trainer's depth net. ``bias_midas_output`` is a fixture helper for
random-weight MiDaS runs.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "weight": "weight",
                  "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}


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
    leaf = leaf.rsplit("/", 1)[-1]  # a WeightNorm scale: 'conv/kernel/scale'
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


# The pretrained depth checkpoints, where the JAX package looks for them
# (train/scene_flow_motion_field.py; reference configs/__init__.py:15-16).
# Preprocessing stage 1 and the trainer load them when the file exists and
# otherwise run random weights.
MIDAS_PRETRAIN_PATH = os.environ.get(
    "DVD_MIDAS_CKPT", "./pretrained_depth_ckpt/midas_cpkt.pt")
DEPTH_PRETRAIN_PATH = os.environ.get(
    "DVD_HOURGLASS_CKPT",
    "./pretrained_depth_ckpt/best_depth_Ours_Bilinear_inc_3_net_G.pth")

# Keys of the pretrained depth files that no module of the port (nor of the
# JAX package) consumes: batch-norm step counters, MiDaS's
# refinenet4.resConfUnit1 (built but never called by the reference,
# third_party/midas_blocks.py:152-160) and the hourglass's
# uncertainty_layer (built, unused in forward, third_party/hourglass.py:
# 172-188).
PRETRAINED_LEFTOVERS = ("num_batches", "refinenet4.resConfUnit1",
                        "uncertainty_layer")
# The DPT-Large file (MiDaS v3.0 ``dpt_large``; no counterpart in the JAX
# package), and what of it ``models/dpt.py`` does not build beside the
# leftovers above: the ViT's final norm and classifier head, which MiDaS's
# forward never reads.
DPT_PRETRAIN_PATH = os.environ.get(
    "DVD_DPT_CKPT", "./pretrained_depth_ckpt/dpt_large-midas-2f21e586.pt")
DPT_LEFTOVERS = PRETRAINED_LEFTOVERS + ("pretrained.model.norm.",
                                        "pretrained.model.head.")


def _load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "optimizer" in state and "model" in state:  # the MiDaS wrapper
        state = state["model"]
    if isinstance(state.get("state_dict"), dict):
        state = state["state_dict"]
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def load_midas_checkpoint(net: nn.Module, path: str) -> nn.Module:
    """Load a MiDaS torch checkpoint by the port's keys, as the JAX
    package's ``port_torch_variables``: every parameter and buffer of ``net``
    (batch-norm step counters aside) must be in the file; keys the net does
    not have are left unused."""
    sd = _load_torch_file(path)
    own = net.state_dict()
    missing = [k for k in own
               if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"MiDaS checkpoint {path} lacks {missing[:5]}")
    net.load_state_dict({k: sd.get(k, v) for k, v in own.items()},
                        strict=True)
    return net


def load_pretrained_depth(net: nn.Module, path: str, midas: bool,
                          unused=PRETRAINED_LEFTOVERS) -> nn.Module:
    """Load the pretrained MiDaS or DPT (``midas``: the file's keys are the
    net's) or hourglass depth checkpoint into the trainer's depth net (JAX
    train/scene_flow_motion_field.py:217-251). The hourglass file holds the
    inner net's keys, nested here under ``net_depth.``. Every parameter and
    buffer of ``net`` (step counters aside) must be in the file, and a key
    of the file that ``net`` does not consume raises unless it holds one of
    ``unused`` (``PRETRAINED_LEFTOVERS``, the DPT's ``DPT_LEFTOVERS``): a
    weight dropped without notice would spoil every result."""
    sd = _load_torch_file(path)
    if not midas:
        sd = {"net_depth." + k: v for k, v in sd.items()}
    own = net.state_dict()
    leftovers = [k for k in sd if k not in own
                 and not any(a in k for a in unused)]
    if leftovers:
        raise KeyError(f"depth checkpoint keys not consumed by the port "
                       f"(layout drift?): {leftovers[:5]}")
    missing = [k for k in own
               if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"depth checkpoint {path} lacks {missing[:5]}")
    net.load_state_dict({k: sd.get(k, v) for k, v in own.items()},
                        strict=True)
    return net


def load_raft_checkpoint(net: nn.Module, path: str) -> nn.Module:
    """Load a RAFT checkpoint in the official layout (saved from
    ``nn.DataParallel``: every key prefixed ``module.``) with
    ``strict=True``. A key the port does not consume raises, apart from
    the batch norms' ``num_batches_tracked`` (the JAX package's
    ``preprocess/flows.py`` rule)."""
    sd = {k.removeprefix("module."): v
          for k, v in _load_torch_file(path).items()}
    own = net.state_dict()
    leftovers = [k for k in sd
                 if k not in own and not k.endswith("num_batches_tracked")]
    if leftovers:
        raise KeyError(f"RAFT checkpoint keys not consumed by the port "
                       f"(layout drift?): {leftovers[:5]}")
    for key, value in own.items():
        if key.endswith("num_batches_tracked"):
            sd.setdefault(key, value)
    net.load_state_dict({k: v for k, v in sd.items() if k in own},
                        strict=True)  # raises on a key the file lacks
    return net
