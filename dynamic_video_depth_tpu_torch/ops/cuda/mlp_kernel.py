"""Kernel B: the Fourier-embedded scene-flow MLP, forward and backward.

Replaces ``dynamic_video_depth_tpu/ops/pallas/mlp_kernel.py::
fused_mlp_embed`` and ``_fused_mlp_embed_bwd``. The CUDA source is
``csrc/mlp_embed.cu``; the plain version, ``mlp_embed_plain``, is
``ops/embedding.py::sceneflow_features`` followed by the dense stack.

Weights use the torch ``nn.Linear`` layout (``[out, in]``). Dispatch: a CPU
tensor takes the plain version (the CPU oracle); a CUDA tensor launches the
kernel or raises. There is no other route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..embedding import sceneflow_embed_consts, sceneflow_features
from . import build

LIBRARY = "dvd_mlp_embed"
SOURCES = ("mlp_embed.cu", "mlp_tile.cuh")
FLAGS = ()
REPLACES = "dynamic_video_depth_tpu/ops/pallas/mlp_kernel.py:343"
SLOPE = 0.2  # leaky-relu negative slope (reference networks/blocks.py)
MAX_LAYERS = 8
MAX_WIDTH = 256
# launches of each kernel since the last reset
launches = {"mlp_fwd": 0, "mlp_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def device_type(t: torch.Tensor) -> str:
    return t.device.type


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, SLOPE * x)


def mlp_embed_plain(pts, ts, weights, biases, n_freq_xyz: int, n_freq_t: int,
                    time_dependent: bool) -> torch.Tensor:
    """``pts [N,3], ts [N,1] -> [N, out]``: the embedding, then the dense
    stack with leaky-relu 0.2 on all but the last layer."""
    h = sceneflow_features(pts, ts, n_freq_xyz, n_freq_t, time_dependent)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = F.linear(h, w, b)
        if i < len(weights) - 1:
            h = leaky(h)
    return h


@functools.lru_cache(maxsize=None)
def embed_consts(n_freq_xyz: int, n_freq_t: int, time_dependent: bool,
                 device: torch.device) -> torch.Tensor:
    """The kernel's constant table ``[7, C0]``: rows fx[0..2], ft, raw,
    cos_m, sin_m (``ops/embedding.py::sceneflow_embed_consts``)."""
    fx, ft, raw, cosm, sinm = sceneflow_embed_consts(n_freq_xyz, n_freq_t,
                                                     time_dependent)
    table = np.concatenate([fx, ft, raw, cosm, sinm], axis=0)
    return torch.from_numpy(np.ascontiguousarray(table)).to(device)


def _lib():
    lib = build.load_library(LIBRARY, SOURCES, FLAGS)
    if not getattr(lib, "_dvd_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dvd_mlp_fwd.argtypes = [p, p, p, p, p, p, i, p, i, p]
        lib.dvd_mlp_bwd.argtypes = [p, p, p, p, p, p, i, p, p, p, p, p, p,
                                    p, p, i, i, p]
        lib.dvd_mlp_fwd.restype = i
        lib.dvd_mlp_bwd.restype = i
        lib._dvd_typed = True
    return lib


def ptr_array(ts: Sequence[torch.Tensor]):
    """A C array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def check_inputs(pts, ts, consts, weights, biases) -> list:
    """Shapes, devices and types of a field query on the card; returns the
    layer widths ``[C0, ..., out]``."""
    n = pts.shape[0]
    if pts.shape != (n, 3) or ts.shape != (n, 1):
        raise ValueError(f"mlp kernel: pts {tuple(pts.shape)} / ts "
                         f"{tuple(ts.shape)} are not [N,3] / [N,1]")
    if not 1 <= len(weights) <= MAX_LAYERS or len(weights) != len(biases):
        raise ValueError(f"mlp kernel: takes 1..{MAX_LAYERS} layers")
    dims = [consts.shape[1]]
    for w, b in zip(weights, biases):
        if w.shape[1] != dims[-1] or b.shape != (w.shape[0],) \
                or w.shape[0] > MAX_WIDTH or w.shape[1] > MAX_WIDTH:
            raise ValueError(f"mlp kernel: layer {tuple(w.shape)} does not "
                             f"chain from width {dims[-1]} (max {MAX_WIDTH})")
        dims.append(w.shape[0])
    for t in (pts, ts, consts, *weights, *biases):
        if device_type(t) != "cuda":
            raise RuntimeError(f"mlp kernel: a tensor is on {t.device}, "
                               "not a CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"mlp kernel: needs float32, got {t.dtype}")
        if t.device != pts.device:
            raise RuntimeError("mlp kernel: tensors on different devices")
    return dims


def mlp_forward_cuda(pts, ts, consts, weights, biases) -> torch.Tensor:
    """Launch the forward kernel on the current stream."""
    dims = check_inputs(pts, ts, consts, weights, biases)
    pts, ts = pts.contiguous(), ts.contiguous()
    weights = [w.contiguous() for w in weights]
    biases = [b.contiguous() for b in biases]
    n = pts.shape[0]
    out = torch.empty((n, dims[-1]), device=pts.device, dtype=torch.float32)
    rc = _lib().dvd_mlp_fwd(
        pts.data_ptr(), ts.data_ptr(), consts.data_ptr(), ptr_array(weights),
        ptr_array(biases), (ctypes.c_int * len(dims))(*dims), len(weights),
        out.data_ptr(), n, stream_handle(pts.device))
    build.check(rc, "dvd_mlp_fwd")
    launches["mlp_fwd"] += 1
    return out


def split_count(n: int) -> int:
    """Point chunks of the weight-gradient reduction: enough blocks to fill
    the card at the slice's size, no more than 64 partial sums."""
    return max(1, min(64, -(-n // 1024)))


def backward_scratch(n: int, dims, device):
    """The backward's scratch: every layer's inputs ``A_l [n, dims[l]]`` and
    output gradients ``dZ_l [n, dims[l+1]]``, and the weight-gradient
    partial sums ``[S, max_l dims[l+1] (dims[l] + 1)]``."""
    f32 = dict(device=device, dtype=torch.float32)
    layers = range(len(dims) - 1)
    acts = [torch.empty((n, dims[i]), **f32) for i in layers]
    dzs = [torch.empty((n, dims[i + 1]), **f32) for i in layers]
    part = max(dims[i + 1] * (dims[i] + 1) for i in layers)
    return acts, dzs, torch.empty((split_count(n), part), **f32)


def mlp_backward_cuda(pts, ts, consts, weights, biases, g):
    """Launch the backward kernels; returns ``(dpts, dts, dWs, dbs)``."""
    dims = check_inputs(pts, ts, consts, weights, biases)
    pts, ts, g = pts.contiguous(), ts.contiguous(), g.contiguous()
    weights = [w.contiguous() for w in weights]
    biases = [b.contiguous() for b in biases]
    if g.shape != (pts.shape[0], dims[-1]) or g.dtype != torch.float32 \
            or g.device != pts.device:
        raise ValueError(f"mlp kernel: gradient {tuple(g.shape)} "
                         f"{g.dtype} does not match the output")
    n = pts.shape[0]
    dev = pts.device
    f32 = dict(device=dev, dtype=torch.float32)
    dpts = torch.empty((n, 3), **f32)
    dts = torch.empty((n, 1), **f32)
    dws = [torch.empty_like(w) for w in weights]
    dbs = [torch.empty_like(b) for b in biases]
    acts, dzs, partial = backward_scratch(n, dims, dev)
    rc = _lib().dvd_mlp_bwd(
        pts.data_ptr(), ts.data_ptr(), consts.data_ptr(), ptr_array(weights),
        ptr_array(biases), (ctypes.c_int * len(dims))(*dims), len(weights),
        g.data_ptr(), dpts.data_ptr(), dts.data_ptr(), ptr_array(dws),
        ptr_array(dbs), ptr_array(acts), ptr_array(dzs), partial.data_ptr(),
        partial.shape[0], n, stream_handle(dev))
    build.check(rc, "dvd_mlp_bwd")
    launches["mlp_bwd"] += 1
    return dpts, dts, dws, dbs


class _MlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, ts, consts, *params):
        n_layers = len(params) // 2
        weights, biases = params[:n_layers], params[n_layers:]
        ctx.save_for_backward(pts, ts, consts, *params)
        return mlp_forward_cuda(pts, ts, consts, weights, biases)

    @staticmethod
    def backward(ctx, g):
        pts, ts, consts, *params = ctx.saved_tensors
        n_layers = len(params) // 2
        dpts, dts, dws, dbs = mlp_backward_cuda(
            pts, ts, consts, params[:n_layers], params[n_layers:], g)
        return (dpts, dts, None, *dws, *dbs)


def mlp_embed(pts, ts, weights, biases, n_freq_xyz: int, n_freq_t: int,
              time_dependent: bool) -> torch.Tensor:
    """One scene-flow field query: ``pts [N,3], ts [N,1] -> [N, out]``.
    For a time-independent field ``ts`` is ignored (pass zeros)."""
    if device_type(pts) == "cpu":
        return mlp_embed_plain(pts, ts, weights, biases, n_freq_xyz,
                               n_freq_t, time_dependent)
    consts = embed_consts(n_freq_xyz, n_freq_t, time_dependent, pts.device)
    return _MlpFn.apply(pts, ts, consts, *weights, *biases)
