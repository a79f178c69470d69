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
# launches since the last reset
launches = {"corr_lookup": 0}
# the same launches by (radius, levels): (kernel, r, L) -> launches
variants = collections.Counter()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    variants.clear()


def device_type(t: torch.Tensor) -> str:
    return t.device.type


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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
    lib = build.load_library(LIBRARY, SOURCES, FLAGS)
    if not getattr(lib, "_dvd_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dvd_corr_lookup.argtypes = [p, p, p, i, p, i, i, i, p, p]
        lib.dvd_corr_lookup.restype = i
        lib._dvd_typed = True
    return lib


def _check(pyramid, coords) -> None:
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"corr lookup: coords {tuple(coords.shape)} is not "
                         "[B,H,W,2]")
    b, h, w, _ = coords.shape
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"corr lookup: takes 1..{MAX_LEVELS} levels")
    for corr in pyramid:
        if corr.dim() != 4 or corr.shape[:2] != (b, h * w):
            raise ValueError(f"corr lookup: level {tuple(corr.shape)} is not "
                             f"[{b}, {h * w}, Hl, Wl]")
    for t in (coords, *pyramid):
        if device_type(t) != "cuda":
            raise RuntimeError(f"corr lookup kernel: a tensor is on "
                               f"{t.device}, not a CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"corr lookup kernel: needs float32, got "
                            f"{t.dtype}")
        if t.device != coords.device:
            raise RuntimeError("corr lookup kernel: tensors on different "
                               "devices")


def lookup_forward_cuda(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                        radius: int = 4) -> torch.Tensor:
    """Launch the lookup kernel on the current stream."""
    _check(pyramid, coords)
    levels = [c.contiguous() for c in pyramid]
    coords = coords.contiguous()
    b, h, w, _ = coords.shape
    n_levels = len(levels)
    k = 2 * radius + 1
    out = torch.empty((b, h, w, n_levels * k * k), device=coords.device,
                      dtype=torch.float32)
    ints = ctypes.c_int * n_levels
    rc = _lib().dvd_corr_lookup(
        (ctypes.c_void_p * n_levels)(*(c.data_ptr() for c in levels)),
        ints(*(c.shape[2] for c in levels)), ints(*(c.shape[3] for c in levels)),
        n_levels, coords.data_ptr(), b, h * w, radius, out.data_ptr(),
        stream_handle(coords.device))
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
