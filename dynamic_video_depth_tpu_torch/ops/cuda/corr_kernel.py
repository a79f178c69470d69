"""The RAFT correlation-pyramid lookup, forward only.

Replaces ``dynamic_video_depth_tpu/ops/pallas/correlation.py::
fused_lookup_correlation``. The CUDA source is ``csrc/corr_lookup.cu``; the
plain version, ``lookup_correlation_plain``, is a direct gather of the four
bilinear taps written from the same formula (not the JAX package's dense
tent einsums, and not ``F.grid_sample``, whose coordinate normalisation
rounds on its own).

Semantics, as ``dynamic_video_depth_tpu/models/raft.py::lookup_correlation``:
level ``l`` samples ``clamp(c / 2^l + offset)`` per axis (the continuous
coordinate is clamped at the border before the taps), the window index is
dy-major and the levels are concatenated in order.

Dispatch: a CPU tensor takes the plain version (the CPU oracle); a CUDA
tensor launches the kernel or raises. There is no other route. Nothing
differentiates through the lookup (RAFT runs for inference only).

The launch path does only comparisons for checks that pass, binds the
library once and keeps the ctypes arrays of the level shapes and pointers
per pyramid shape, so that the 20 lookups of a RAFT call build none.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Sequence

import torch

from . import build

LIBRARY = "dvd_corr"
SOURCES = ("corr_lookup.cu",)
FLAGS = ()
REPLACES = "dynamic_video_depth_tpu/ops/pallas/correlation.py:157"
MAX_LEVELS = 8
MAX_RADIUS = 7  # the kernel's compile-time radii
_F32 = torch.float32
_LIB = None
# per level shapes ((Hl, Wl), ...): (pointer array, heights, widths)
_ARRAYS = {}
# launches since the last reset
launches = {"corr_lookup": 0}
# the same launches by (radius, levels): (kernel, r, L) -> launches
variants = collections.Counter()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    variants.clear()


def device_type(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else t.device.type


def stream_handle(index: int) -> int:
    """The current CUDA stream of device ``index``, as an integer."""
    return torch._C._cuda_getCurrentRawStream(index)


def lookup_correlation_plain(pyramid: Sequence[torch.Tensor],
                             coords: torch.Tensor,
                             radius: int = 4) -> torch.Tensor:
    """``pyramid`` (levels ``[B, N, Hl, Wl]``, N = H W), ``coords [B, H, W,
    2]`` (x, y) -> ``[B, H, W, L (2r+1)^2]``."""
    b, h, w, _ = coords.shape
    n, k = h * w, 2 * radius + 1
    offsets = torch.arange(-radius, radius + 1, dtype=coords.dtype,
                           device=coords.device)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        c = coords.reshape(b, n, 2) / (2.0 ** lvl)
        y = torch.clamp(c[..., 1:2] + offsets, 0.0, hl - 1.0)  # [B, N, K] dy
        x = torch.clamp(c[..., 0:1] + offsets, 0.0, wl - 1.0)  # [B, N, K] dx
        y0, x0 = torch.floor(y), torch.floor(x)
        fy, fx = (y - y0)[..., :, None], (x - x0)[..., None, :]
        iy0, ix0 = y0.long(), x0.long()
        iy1 = torch.clamp(iy0 + 1, max=hl - 1)
        ix1 = torch.clamp(ix0 + 1, max=wl - 1)
        flat = corr.reshape(b, n, hl * wl)

        def tap(iy, ix):
            idx = (iy[..., :, None] * wl + ix[..., None, :]).reshape(b, n, -1)
            return torch.gather(flat, 2, idx).reshape(b, n, k, k)

        win = ((1.0 - fy) * (1.0 - fx) * tap(iy0, ix0)
               + (1.0 - fy) * fx * tap(iy0, ix1)
               + fy * (1.0 - fx) * tap(iy1, ix0)
               + fy * fx * tap(iy1, ix1))
        out.append(win.reshape(b, h, w, k * k))
    return torch.cat(out, dim=-1)


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load_library(LIBRARY, SOURCES, FLAGS)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dvd_corr_lookup.argtypes = [p, p, p, i, p, i, i, i, p, p]
        lib.dvd_corr_lookup.restype = i
        _LIB = lib
    return _LIB


def _checked(pyramid, coords, radius: int) -> tuple:
    """``(B, H, W, device index)`` of ``coords [B,H,W,2]`` and the levels
    ``[B, H W, Hl, Wl]``, all float32 on one CUDA device; raises otherwise.
    Checks that pass cost comparisons only."""
    shape = coords.shape
    if len(shape) == 4 and shape[3] == 2 and 1 <= len(pyramid) <= MAX_LEVELS \
            and 0 <= radius <= MAX_RADIUS:
        b, h, w, _ = shape
        index = coords.get_device()
        if coords.dtype == _F32 and device_type(coords) == "cuda" and all(
                c.dim() == 4 and c.shape[0] == b and c.shape[1] == h * w
                and c.dtype == _F32 and device_type(c) == "cuda"
                and c.get_device() == index for c in pyramid):
            return b, h, w, index
    if len(shape) != 4 or shape[-1] != 2:
        raise ValueError(f"corr lookup: coords {tuple(shape)} is not "
                         "[B,H,W,2]")
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"corr lookup: takes 1..{MAX_LEVELS} levels")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"corr lookup kernel: radius {radius} is not in "
                         f"0..{MAX_RADIUS}")
    b, h, w, _ = shape
    for corr in pyramid:
        if corr.dim() != 4 or corr.shape[:2] != (b, h * w):
            raise ValueError(f"corr lookup: level {tuple(corr.shape)} is not "
                             f"[{b}, {h * w}, Hl, Wl]")
    for t in (coords, *pyramid):
        if device_type(t) != "cuda":
            raise RuntimeError(f"corr lookup kernel: a tensor is on "
                               f"{t.device}, not a CUDA device")
        if t.dtype != _F32:
            raise TypeError(f"corr lookup kernel: needs float32, got "
                            f"{t.dtype}")
    raise RuntimeError("corr lookup kernel: tensors on different devices")


def _arrays(levels) -> tuple:
    """The ctypes arrays of the levels' pointers, heights and widths; those
    of the shapes are kept per pyramid shape and the pointers filled in."""
    key = tuple(c.shape[2:] for c in levels)
    arrays = _ARRAYS.get(key)
    if arrays is None:
        ints = ctypes.c_int * len(key)
        arrays = ((ctypes.c_void_p * len(key))(),
                  ints(*(s[0] for s in key)), ints(*(s[1] for s in key)))
        _ARRAYS[key] = arrays
    for i, c in enumerate(levels):
        arrays[0][i] = c.data_ptr()
    return arrays


def lookup_forward_cuda(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                        radius: int = 4) -> torch.Tensor:
    """Launch the lookup kernel on the current stream."""
    b, h, w, index = _checked(pyramid, coords, radius)
    levels = [c if c.is_contiguous() else c.contiguous() for c in pyramid]
    if not coords.is_contiguous():
        coords = coords.contiguous()
    n_levels = len(levels)
    k = 2 * radius + 1
    out = torch.empty((b, h, w, n_levels * k * k), device=coords.device,
                      dtype=_F32)
    ptrs, heights, widths = _arrays(levels)
    rc = _lib().dvd_corr_lookup(ptrs, heights, widths, n_levels,
                                coords.data_ptr(), b, h * w, radius,
                                out.data_ptr(), stream_handle(index))
    if rc:
        build.check(rc, "dvd_corr_lookup")
    launches["corr_lookup"] += 1
    variants["corr_lookup", radius, n_levels] += 1
    return out


def lookup_correlation(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                       radius: int = 4) -> torch.Tensor:
    """Sample each pyramid level in a ``(2r+1)^2`` window around
    ``coords``: ``[B, H, W, L (2r+1)^2]``."""
    if device_type(coords) == "cpu":
        return lookup_correlation_plain(pyramid, coords, radius)
    return lookup_forward_cuda(pyramid, coords, radius)
