"""Kernel C: the Euler chain of scene-flow field evaluations, whose backward
is one hand-written kernel over all evaluations.

Replaces ``dynamic_video_depth_tpu/ops/pallas/mlp_kernel.py::
fused_mlp_embed_chain`` (its backward ``_chain_bwd`` / ``_bwd_chain_kernel``).
The forward is the JAX split: kernel B's forward once per evaluation plus
the advects, stashing the advected points. The backward is
``csrc/mlp_chain.cu``. The plain version, ``chain_plain``, is ``_chain_xla``
in torch, differentiated by autograd.

Dispatch: a CPU tensor takes the plain version (the CPU oracle); a CUDA
tensor launches the kernels or raises. There is no other route.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import build
from .mlp_kernel import (backward_scratch, check_inputs, device_type,
                         embed_consts, mlp_embed_plain, mlp_forward_cuda,
                         ptr_array, stream_handle)

LIBRARY = "dvd_mlp_chain"
SOURCES = ("mlp_chain.cu", "mlp_tile.cuh")
FLAGS = ()
REPLACES = "dynamic_video_depth_tpu/ops/pallas/mlp_kernel.py:772"
# launches of the chain backward since the last reset (one per backward
# pass, which runs every evaluation); the forward's launches count as
# kernel B's ``mlp_fwd``
launches = {"chain_bwd": 0}
# the same launches by chain: ("chain_bwd", n_steps, n_evals) -> launches
variants = collections.Counter()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    variants.clear()


def chain_plain(pts, ts, dt, weights, biases, n_freq_xyz: int, n_freq_t: int,
                time_dependent: bool, n_steps: int, n_evals: int,
                sf_div: float):
    """``(acc, f0, f1)``, each ``[N, 3]``: ``n_evals`` field evaluations
    ``sf_k = field(p_k, t_k) / sf_div`` with ``p += sf``, ``t += dt`` after
    every evaluation but the last; ``acc`` sums the first ``n_steps``.
    ``f1`` is zeros when ``n_evals < 2``."""
    p, t = pts, ts
    acc = torch.zeros_like(pts)
    f0 = f1 = None
    for k in range(n_evals):
        sf = mlp_embed_plain(p, t, weights, biases, n_freq_xyz, n_freq_t,
                             time_dependent) / sf_div
        if k == 0:
            f0 = sf
        if k == 1:
            f1 = sf
        if k < n_steps:
            acc = acc + sf
        if k + 1 < n_evals:
            p = p + sf
            t = t + dt
    return acc, f0, torch.zeros_like(acc) if f1 is None else f1


def _lib():
    lib = build.load_library(LIBRARY, SOURCES, FLAGS)
    if not getattr(lib, "_dvd_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dvd_chain_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, p,
                                      i, i, f, p, p, p, p, p, p, p, p, i, i,
                                      p]
        lib.dvd_chain_bwd.restype = i
        lib._dvd_typed = True
    return lib


def chain_forward_cuda(pts, ts, dt, consts, weights, biases, n_steps: int,
                       n_evals: int, sf_div: float):
    """``(acc, f0, f1, stash)``: kernel B's forward per evaluation, the
    advects in torch; ``stash [K-1, N, 3]`` holds ``p_1 .. p_{K-1}``."""
    n = pts.shape[0]
    stash = torch.empty((max(n_evals - 1, 0), n, 3), device=pts.device,
                        dtype=torch.float32)
    p, t = pts, ts
    acc = torch.zeros_like(pts)
    f0 = f1 = None
    for k in range(n_evals):
        sf = mlp_forward_cuda(p, t, consts, weights, biases) / sf_div
        if k == 0:
            f0 = sf
        if k == 1:
            f1 = sf
        if k < n_steps:
            acc = acc + sf
        if k + 1 < n_evals:
            p = torch.add(p, sf, out=stash[k])
            t = t + dt
    return acc, f0, torch.zeros_like(acc) if f1 is None else f1, stash


def chain_backward_cuda(pts, ts, dt, consts, weights, biases, stash, gacc,
                        g0, g1, n_steps: int, n_evals: int, sf_div: float):
    """Launch the chain backward; returns ``(dpts, dts, ddt, dWs, dbs)``."""
    dims = check_inputs(pts, ts, consts, weights, biases)
    n = pts.shape[0]
    if dims[-1] != 3:
        raise ValueError(f"chain kernel: the field must output 3 values, "
                         f"not {dims[-1]}")
    if not 0 <= n_steps <= n_evals or n_evals < 1:
        raise ValueError(f"chain kernel: n_steps={n_steps}, "
                         f"n_evals={n_evals}")
    dev = pts.device
    f32 = dict(device=dev, dtype=torch.float32)
    if stash.shape != (max(n_evals - 1, 0), n, 3):
        raise ValueError(f"chain kernel: stash {tuple(stash.shape)}")
    for name, x, shape in (("dt", dt, (n, 1)), ("gacc", gacc, (n, 3)),
                           ("g0", g0, (n, 3)), ("g1", g1, (n, 3)),
                           ("stash", stash, stash.shape)):
        if x.shape != shape or x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"chain kernel: {name} {tuple(x.shape)} "
                             f"{x.dtype} on {x.device} does not fit")
    pts, ts, dt, stash, gacc, g0, g1 = (
        x.contiguous() for x in (pts, ts, dt, stash, gacc, g0, g1))
    weights = [w.contiguous() for w in weights]
    biases = [b.contiguous() for b in biases]
    dpts = torch.empty((n, 3), **f32)
    dts = torch.empty((n, 1), **f32)
    ddt = torch.empty((n, 1), **f32)
    dws = [torch.empty_like(w) for w in weights]
    dbs = [torch.empty_like(b) for b in biases]
    acts, dzs, partial, packed = backward_scratch(n, dims, dev)
    rc = _lib().dvd_chain_bwd(
        pts.data_ptr(), stash.data_ptr(), ts.data_ptr(), dt.data_ptr(),
        gacc.data_ptr(), g0.data_ptr(), g1.data_ptr(), consts.data_ptr(),
        ptr_array(weights), ptr_array(biases),
        (ctypes.c_int * len(dims))(*dims), len(weights), packed.data_ptr(),
        n_steps, n_evals, float(sf_div), dpts.data_ptr(), dts.data_ptr(),
        ddt.data_ptr(), ptr_array(dws), ptr_array(dbs), ptr_array(acts),
        ptr_array(dzs), partial.data_ptr(), partial.shape[0], n,
        stream_handle(dev))
    build.check(rc, "dvd_chain_bwd")
    launches["chain_bwd"] += 1
    variants["chain_bwd", n_steps, n_evals] += 1
    return dpts, dts, ddt, dws, dbs


class _ChainFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, ts, dt, consts, n_steps, n_evals, sf_div, *params):
        n_layers = len(params) // 2
        weights, biases = params[:n_layers], params[n_layers:]
        acc, f0, f1, stash = chain_forward_cuda(
            pts, ts, dt, consts, weights, biases, n_steps, n_evals, sf_div)
        ctx.save_for_backward(pts, ts, dt, consts, stash, *params)
        ctx.chain = (n_steps, n_evals, sf_div)
        return acc, f0, f1

    @staticmethod
    def backward(ctx, gacc, g0, g1):
        pts, ts, dt, consts, stash, *params = ctx.saved_tensors
        n_layers = len(params) // 2
        gacc, g0, g1 = (torch.zeros_like(pts) if g is None else g
                        for g in (gacc, g0, g1))
        dpts, dts, ddt, dws, dbs = chain_backward_cuda(
            pts, ts, dt, consts, params[:n_layers], params[n_layers:], stash,
            gacc, g0, g1, *ctx.chain)
        return (dpts, dts, ddt, None, None, None, None, *dws, *dbs)


def mlp_embed_chain(pts, ts, dt, weights, biases, n_freq_xyz: int,
                    n_freq_t: int, time_dependent: bool, n_steps: int,
                    n_evals: int, sf_div: float):
    """Euler-integrate the field over ``n_evals`` evaluations from
    ``pts [N,3]``, ``ts``/``dt [N,1]``: ``(acc, f0, f1)`` as
    ``chain_plain``. For a time-independent field pass zeros for ``ts`` and
    ``dt``."""
    if device_type(pts) == "cpu":
        return chain_plain(pts, ts, dt, weights, biases, n_freq_xyz, n_freq_t,
                           time_dependent, n_steps, n_evals, sf_div)
    consts = embed_consts(n_freq_xyz, n_freq_t, time_dependent, pts.device)
    return _ChainFn.apply(pts, ts, dt, consts, n_steps, n_evals,
                          float(sf_div), *weights, *biases)
