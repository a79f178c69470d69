"""Kernel A: the bilinear backward warp, forward and source gradient.

Replaces ``dynamic_video_depth_tpu/ops/pallas/warp_kernel.py::
fused_backward_warp`` (its forward and ``_warp_bwd``). The CUDA source is
``csrc/warp.cu``; the plain version is ``ops/grid_sample.py::
backward_warp``, which this module re-exports as ``backward_warp_plain``.

Dispatch: a CPU tensor takes the plain version (the CPU oracle); a CUDA
tensor launches the kernel or raises. There is no other route.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..grid_sample import backward_warp as backward_warp_plain
from . import build

LIBRARY = "dvd_warp"
SOURCES = ("warp.cu",)
FLAGS = ()
REPLACES = "dynamic_video_depth_tpu/ops/pallas/warp_kernel.py:257"
# launches of each kernel since the last reset (the forward and the
# backward count separately)
launches = {"warp_fwd": 0, "warp_bwd": 0}
# the same launches by channel count: (kernel, C) -> launches; C=4 takes
# the vector path of the forward, other C the scalar one
variants = collections.Counter()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    variants.clear()


def device_type(t: torch.Tensor) -> str:
    return t.device.type


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _lib():
    lib = build.load_library(LIBRARY, SOURCES, FLAGS)
    if not getattr(lib, "_dvd_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dvd_warp_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.dvd_warp_bwd.argtypes = [p, p, p, i, i, i, i, p]
        lib.dvd_warp_fwd.restype = i
        lib.dvd_warp_bwd.restype = i
        lib._dvd_typed = True
    return lib


def _check(src: torch.Tensor, flow: torch.Tensor) -> None:
    if src.dim() != 4 or flow.shape != src.shape[:3] + (2,):
        raise ValueError(f"warp: src {tuple(src.shape)} / flow "
                         f"{tuple(flow.shape)} are not [B,H,W,C] / [B,H,W,2]")
    for name, t in (("src", src), ("flow", flow)):
        if device_type(t) != "cuda":
            raise RuntimeError(f"warp kernel: {name} is on {t.device}, "
                               "not a CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"warp kernel: {name} must be float32, "
                            f"got {t.dtype}")
    if src.device != flow.device:
        raise RuntimeError("warp kernel: src and flow on different devices")


def warp_forward_cuda(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on the current stream."""
    _check(src, flow)
    src, flow = src.contiguous(), flow.contiguous()
    b, h, w, c = src.shape
    out = torch.empty_like(src)
    vec = int(c == 4 and src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    rc = _lib().dvd_warp_fwd(src.data_ptr(), flow.data_ptr(), out.data_ptr(),
                             b, h, w, c, vec, stream_handle(src.device))
    build.check(rc, "dvd_warp_fwd")
    launches["warp_fwd"] += 1
    variants["warp_fwd", c] += 1
    return out


def warp_backward_cuda(g: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Launch the scatter kernel: the source gradient of the warp."""
    _check(g, flow)
    g, flow = g.contiguous(), flow.contiguous()
    b, h, w, c = g.shape
    dsrc = torch.empty_like(g)
    rc = _lib().dvd_warp_bwd(g.data_ptr(), flow.data_ptr(), dsrc.data_ptr(),
                             b, h, w, c, stream_handle(g.device))
    build.check(rc, "dvd_warp_bwd")
    launches["warp_bwd"] += 1
    variants["warp_bwd", c] += 1
    return dsrc


class _WarpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, flow):
        ctx.save_for_backward(flow)
        return warp_forward_cuda(src, flow)

    @staticmethod
    def backward(ctx, g):
        (flow,) = ctx.saved_tensors
        return warp_backward_cuda(g, flow), None


def backward_warp(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``src [B,H,W,C]`` by ``flow [B,H,W,2]``; differentiable
    with respect to ``src`` only (the flow is observed data)."""
    if device_type(src) == "cpu" and device_type(flow) == "cpu":
        return backward_warp_plain(src, flow.detach())
    return _WarpFn.apply(src, flow.detach())
