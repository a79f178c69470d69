"""Kernel A: the bilinear backward warp, forward and source gradient.

Replaces ``dynamic_video_depth_tpu/ops/pallas/warp_kernel.py::
fused_backward_warp`` (its forward and ``_warp_bwd``). The CUDA source is
``csrc/warp.cu``; the plain version is ``ops/grid_sample.py::
backward_warp``, which this module re-exports as ``backward_warp_plain``.

Dispatch: a CPU tensor takes the plain version (the CPU oracle); a CUDA
tensor launches the kernel or raises. There is no other route.

The tile map (``TILE``, ``WINDOW``, ``window_rows``, ``window_plan``)
mirrors the kernel's: a block owns a 32x8 tile of output pixels, a warp one
row of it, and in the backward each warp accumulates its taps in a private
48x4-pixel source window in shared memory, placed at the row's smallest
taps, before adding it to the image; taps outside the window, and all the
taps of a row whose targets may collide, go straight to the image. The
launch path does only comparisons for checks that pass and binds the
library once.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..grid_sample import backward_warp as backward_warp_plain
from . import build

LIBRARY = "dvd_warp"
SOURCES = ("warp.cu",)
FLAGS = ()
REPLACES = "dynamic_video_depth_tpu/ops/pallas/warp_kernel.py:257"
TILE = (32, 8)       # output pixels of a block (x, y); a warp is one row
WINDOW = (48, 4)     # a warp's source window in the backward (x, y), pixels
WINDOW_FLOATS = 12032  # the block's 8 windows' shared memory at most: 47 KB
# launches of each kernel since the last reset (the forward and the
# backward count separately), and the same launches by channel count
launches = {"warp_fwd": 0, "warp_bwd": 0}
_fwd_by_c, _bwd_by_c = {}, {}
_by_channels = {"warp_fwd": _fwd_by_c, "warp_bwd": _bwd_by_c}
_F32 = torch.float32
_LIB = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
        _by_channels[k].clear()


def launch_variants() -> collections.Counter:
    """Launches since the last reset keyed ``(kernel, C)``: C = 4 and C = 3
    take the vector paths, other C the per-channel loop."""
    return collections.Counter({(k, c): n for k, by_c in _by_channels.items()
                                for c, n in by_c.items()})


def device_type(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else t.device.type


def stream_handle(index: int) -> int:
    """The current CUDA stream of device ``index``, as an integer."""
    return torch._C._cuda_getCurrentRawStream(index)


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load_library(LIBRARY, SOURCES, FLAGS)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dvd_warp_fwd.argtypes = [p, p, p, i, i, i, i, p]
        lib.dvd_warp_bwd.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.dvd_warp_fwd.restype = i
        lib.dvd_warp_bwd.restype = i
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def window_rows(c: int) -> int:
    """Rows of a warp's window at ``c`` channels (a slot of 4 floats a pixel
    at c = 3): ``WINDOW[1]``, fewer where the block's 8 windows pass 47 KB
    (c > 7), none past c = 31 (every tap then goes straight to the
    image)."""
    slot = 4 if c == 3 else c
    return min(WINDOW[1], WINDOW_FLOATS // (TILE[1] * WINDOW[0] * slot))


def window_plan(flow: torch.Tensor, c: int) -> tuple:
    """Where the backward puts each warp's window and how it adds into it,
    as the kernel decides: ``(origins [B, H, tiles_x, 2], steps [B, H,
    tiles_x])`` for the warp of each tile row. The window starts at the
    row's smallest top-left tap (x and y apart), clamped so that it lies in
    the image where the image is large enough. ``steps`` is the least of
    1, 2 and 4 for which the row's top-left taps, keyed column-major in
    window coordinates, strictly increase along the pixels of each residue
    class (column mod steps), and 0 (every tap straight to the image) where
    none does or a tap is clamped onto its neighbour."""
    b, h, w, _ = flow.shape
    rows, lanes = window_rows(c), TILE[0]
    tiles = -(-w // lanes)
    pad = tiles * lanes - w
    xs = torch.arange(w, device=flow.device)
    ys = torch.arange(h, device=flow.device)[:, None]
    x0 = torch.floor((xs + flow[..., 0]).clamp(0.0, w - 1.0)).long()
    y0 = torch.floor((ys + flow[..., 1]).clamp(0.0, h - 1.0)).long()

    def by_row(t, fill):  # [B, H, W] -> [B, H, tiles, lanes], padded
        return torch.cat([t, torch.full((b, h, pad), fill, dtype=t.dtype,
                                        device=t.device)], -1).view(
                                            b, h, tiles, lanes)

    far = torch.iinfo(torch.int64).max // 4
    ox = by_row(x0, far).amin(-1).clamp(max=max(w - WINDOW[0], 0))
    oy = by_row(y0, far).amin(-1).clamp(max=max(h - rows, 0))
    key = by_row(x0, 0) - ox[..., None]
    key = key * max(rows, 1) + by_row(y0, 0) - oy[..., None]
    # the lanes past the image's edge pass every comparison, as in the kernel
    key = torch.where(by_row(torch.ones_like(x0, dtype=torch.bool), False),
                      key, far + torch.arange(lanes, device=flow.device))
    free = by_row((x0 < w - 1) & (y0 < h - 1), True).all(-1) & (rows > 0)
    steps = torch.zeros_like(ox)
    for s in (4, 2, 1):
        ok = (key[..., s:] > key[..., :-s]).all(-1) & free
        steps = torch.where(ok, s, steps)
    return torch.stack([ox, oy], -1), steps


def _checked(x: torch.Tensor, flow: torch.Tensor, what: str) -> tuple:
    """``(B, H, W, C, device index)`` of ``x [B,H,W,C]`` and ``flow
    [B,H,W,2]``, both float32 on one CUDA device; raises otherwise. Checks
    that pass cost comparisons only."""
    shape = x.shape
    if len(shape) == 4:
        b, h, w, c = shape
        if (x.dtype == _F32 and flow.dtype == _F32
                and flow.shape == (b, h, w, 2) and device_type(x) == "cuda"
                and device_type(flow) == "cuda"):
            index = x.get_device()
            if flow.get_device() == index:
                return b, h, w, c, index
    if len(shape) != 4 or flow.shape != shape[:3] + (2,):
        raise ValueError(f"warp: {what} {tuple(shape)} / flow "
                         f"{tuple(flow.shape)} are not [B,H,W,C] / [B,H,W,2]")
    for name, t in ((what, x), ("flow", flow)):
        if device_type(t) != "cuda":
            raise RuntimeError(f"warp kernel: {name} is on {t.device}, "
                               "not a CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"warp kernel: {name} must be float32, "
                            f"got {t.dtype}")
    raise RuntimeError("warp kernel: src and flow on different devices")


def warp_forward_cuda(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on the current stream."""
    b, h, w, c, index = _checked(src, flow, "src")
    if not src.is_contiguous():
        src = src.contiguous()
    if not flow.is_contiguous():
        flow = flow.contiguous()
    out = torch.empty_like(src)
    rc = _lib().dvd_warp_fwd(src.data_ptr(), flow.data_ptr(), out.data_ptr(),
                             b, h, w, c, stream_handle(index))
    if rc:
        build.check(rc, "dvd_warp_fwd")
    launches["warp_fwd"] += 1
    _fwd_by_c[c] = _fwd_by_c.get(c, 0) + 1
    return out


def warp_backward_cuda(g: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Launch the scatter kernel: the source gradient of the warp."""
    b, h, w, c, index = _checked(g, flow, "g")
    if not g.is_contiguous():
        g = g.contiguous()
    if not flow.is_contiguous():
        flow = flow.contiguous()
    dsrc = torch.empty_like(g)
    rc = _lib().dvd_warp_bwd(g.data_ptr(), flow.data_ptr(), dsrc.data_ptr(),
                             b, h, w, c, window_rows(c), stream_handle(index))
    if rc:
        build.check(rc, "dvd_warp_bwd")
    launches["warp_bwd"] += 1
    _bwd_by_c[c] = _bwd_by_c.get(c, 0) + 1
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
