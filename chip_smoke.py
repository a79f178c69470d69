#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.
``--warp_only [--repo <checkout>]`` builds and times kernel A alone (for
the package of another checkout: a before/after on one card) and prints no
result.

1. Builds the hand-written kernels (``dynamic_video_depth_tpu_torch/csrc``),
   one nvcc per library, all at once, and prints the card's name and power
   limit and the launch floor (``[floor]``: an empty kernel through ctypes).
2. Holds every kernel against its plain PyTorch version on the card, at the
   main paths' shapes, and times both: the warp (A) at 224x384 with 4
   channels (the depth warp) and 3 (the fused loss's point warp), at the
   synthetic track's gap-2 and gap-8 flows and at random +-60 px flows,
   with the host time of 1,000 calls (``[host]``); the embedded MLP (B) at
   224x384; the Euler-chain backward (C) at 86,016
   points for (n_steps, n_evals) = (1, 2), (2, 2), (4, 4) and (8, 8), the
   chains of gaps 1, 2, 4 and 8; the projection-loss forward and backward
   (D) at 224x384 and 320x576 in the use_disp, MiDaS, warm-up and main
   configurations; the RAFT correlation lookup at 288x512 (B = 2, a 36x64
   grid, four levels, r = 4); fused_mlp forward and backward at 86,016
   points, 132 -> 256 -> 256 x4 -> 3 (on no path, as in the JAX package).
3. Drives the flagship configuration through the trainer's entry
   (``dynamic_video_depth_tpu_torch.train``, ``--midas --device cuda``, the
   fused paths on by default): MiDaS at full width with the fixture's biased
   output conv, 224x384, batch 1, a warm-up epoch then a main epoch over
   gaps 1, 2 and 4. It checks the losses (the main loss above 0: the
   far-field masks are live), that the depth net stayed fixed during
   warm-up, that both nets moved, that the path launched every kernel,
   the warp at 3 channels among them, and that it launched the warp and
   the chain only at channel counts and chains that phase 2 checked.
4. Drives the hourglass slice through the same entry with the fused paths
   off (``--use_pallas_sf_chain off --use_pallas_loss off``): kernels A and
   B per evaluation, over gaps 1 and 2, with the same checks and the
   inference output.
5. Preprocesses a synthetic raw track (8 frames at 448x768, in memory)
   through stages 1-3: MiDaS depth and calibration, RAFT at 288x512 with 20
   iterations over gaps 1, 2 and 4 (the lookup kernel on every iteration,
   only at the variant phase 2 checked), the packing; checks every artifact,
   loads every packed pair and takes one hourglass train step on one; holds
   stage 2's post-processing on the card against the CPU on flows of a
   known shift at full size (masks neither all 0 nor all 1); times the
   stages and profiles one RAFT call.
6. Runs RAFT at 64x96 with 3 iterations on the card and on the CPU from the
   same weights and compares the flows.
7. Runs a warm-up and a main step of the hourglass slice on a small input
   on the card (fused paths) and on the CPU (plain, unfused) and compares
   the losses.

Phase 1 also counts the tensor-core instructions (HMMA, HGMMA) in the two
MLP libraries and the warp's shared atomics and global reductions with
``cuobjdump -sass`` where the toolkit has it, and
measures the rate of the MLP tiles' instruction alone (``MMA_LOOP``).
Phase 2's gradient checks of the MLP kernels (``mlp_bwd``, ``chain_bwd``,
``dense_bwd``) zero the cotangents of the points whose hidden
pre-activations lie within roundoff of 0 (``flip_points``: there two right
float32 computations may take different leaky-relu slopes) on both sides,
and print the share excluded; ``TOL`` is not loosened for it. Each
``[kernel]`` line gives the kernel's bound (bytes over 3.35 TB/s, or the
3xTF32 tensor-core bound, 3 x FLOPs over 495 TFLOP/s, for the MLP kernels,
with their f32-FMA bound share and achieved TFLOP/s) and a library
yardstick: ``F.grid_sample`` and its autograd backward for the warp, the
cuBLAS-backed plain stack for the MLP kernels, none for the loss and the
lookup. Each line also gives the device time of every CUDA kernel that
one call launches (``torch.profiler``; for the warp, the library call's
too): for the MLP kernels the point kernel against the weight-gradient
pass, for the small kernels the device time beside the per-call time,
which their host-side launch path bounds.

Prints one JSON line with the kernels' results, then the card's name and
power limit, then ``{"ok": true, "device": {...}}`` last. Exits nonzero,
printing no result, when any phase fails or no CUDA device is present. It
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 224, 384
N_PTS = H * W
WIDE = (320, 576)
# tolerances: max |kernel - plain| / max |plain| per tensor, and for the
# four sums of the loss forward |kernel - plain| / |plain| per sum (PERF.md
# section 6 gives each kernel's reading on the card beside its tolerance)
TOL = {"warp_fwd": 1e-6, "warp_bwd": 1e-5, "mlp_fwd": 1e-4, "mlp_bwd": 1e-5,
       "chain_fwd": 1e-5, "chain_bwd": 1e-5, "loss_fwd": 1e-5,
       "loss_bwd": 1e-5, "dense_fwd": 1e-4, "dense_bwd": 1e-5,
       "corr_lookup": 1e-6}
CHAINS = ((1, 2), (2, 2), (4, 4), (8, 8))  # (n_steps, n_evals) of gaps 1-8
# A leaky-relu pre-activation within roundoff of 0 takes either slope in
# two right float32 computations that sum in different orders (the
# kernels' tensor-core order against cuBLAS's), which moves a max-based
# gradient check past TOL. The gradient checks zero the cotangents of the
# points with |z| < FLIP_TAU * max |z| at any hidden layer of the plain
# forward (every evaluation of a chain), on both sides: those points then
# add exactly 0 to every gradient. Forward checks are not masked.
FLIP_TAU = 2e-6
# peaks of one H100 SXM (NVIDIA's H100 datasheet): float32 FMAs
# outside the tensor cores, TF32 tensor cores (dense), device memory
F32_FLOPS, TF32_FLOPS, HBM_BYTES = 67e12, 495e12, 3.35e12
SOURCE = {"warp_fwd": "warp.cu", "warp_bwd": "warp.cu",
          "mlp_fwd": "mlp_embed.cu", "mlp_bwd": "mlp_embed.cu",
          "chain_bwd": "mlp_chain.cu", "loss_fwd": "projection_loss.cu",
          "loss_bwd": "projection_loss.cu", "dense_fwd": "mlp_embed.cu",
          "dense_bwd": "mlp_embed.cu", "corr_lookup": "corr_lookup.cu"}
PALLAS = "dynamic_video_depth_tpu/ops/pallas/"
REPLACES = {"warp_fwd": PALLAS + "warp_kernel.py:257",
            "warp_bwd": PALLAS + "warp_kernel.py:295",
            "mlp_fwd": PALLAS + "mlp_kernel.py:343",
            "mlp_bwd": PALLAS + "mlp_kernel.py:405",
            "chain_bwd": PALLAS + "mlp_kernel.py:772",
            "loss_fwd": PALLAS + "loss_kernel.py:317",
            "loss_bwd": PALLAS + "loss_kernel.py:353",
            "dense_fwd": PALLAS + "mlp_kernel.py:134",
            "dense_bwd": PALLAS + "mlp_kernel.py:184",
            "corr_lookup": PALLAS + "correlation.py:157"}
# kernels each path must launch; fused_mlp (dense_*) is on no path, as in
# the JAX package, and is held in phase 2 only
HOURGLASS_KERNELS = ("warp_fwd", "warp_bwd", "mlp_fwd", "mlp_bwd")
MIDAS_KERNELS = HOURGLASS_KERNELS + ("chain_bwd", "loss_fwd", "loss_bwd")
PREPROCESS_KERNELS = ("corr_lookup",)
# RAFT at 288x512: a 36x64 grid at 1/8, four levels, radius 4; both
# directions of one pair in one batch
RAFT_GRID = (36, 64)
RAFT_LEVELS, RAFT_RADIUS = 4, 4
# the synthetic raw track of the preprocessing phase (multiples of 32 for
# MiDaS at the raw resolution)
RAW_FRAMES, RAW_HW, PRE_GAPS = 8, (448, 768), (1, 2, 4)
# the ceiling of the instruction the MLP tiles use: a loop of TF32
# mma.sync.m16n8k8 on register operands, 16 independent accumulators a warp,
# 4 blocks of 512 threads per SM; prints TFLOP/s
MMA_LOOP = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void loop(float* out, int iters) {
  float c[16][4] = {};
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(it), "r"(j));
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int threads = 512, blocks = 4 * sms, iters = 4096;
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  loop<<<blocks, threads>>>(out, iters);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  loop<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * 16 * 8 * 8 * 16.0 * iters * (threads / 32) * blocks;
  printf("%.1f\n", flops / ms / 1e9);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""
# the launch floor: an empty kernel, one block, launched through ctypes as
# the kernels' wrappers launch theirs
EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int dvd_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split(fn, reps: int = 3, tries: int = 3) -> str:
    """The device time of each CUDA kernel that ``fn`` launches, per call
    (``torch.profiler`` over ``reps`` calls): "name ms xlaunches, ...". The
    profiler may record fewer launches of a short kernel than ran, so a
    kernel's time per call is its mean time per recorded launch times its
    launches per call (the recorded count over ``reps``, rounded, at least
    1). A profile that records no device activity (seen once on the
    lookup) is taken again, up to ``tries`` times."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.self_device_time_total <= 0):
                continue
            n = max(1, round(e.count / reps))
            rows.append((e.self_device_time_total / 1e3 / e.count * n, n,
                         e.key.replace("(anonymous namespace)::", "")
                         .replace("void ", "").split("(")[0]))
        rows.sort(reverse=True)
        if rows:
            return ", ".join(f"{name} {ms:.4f} ms x{n}"
                             for ms, n, name in rows)
    return "none recorded by the profiler"


def rel_err(a, b) -> tuple:
    """(max abs error, max abs error / max |reference|)."""
    err = (a - b).abs().max().item()
    return err, err / max(b.abs().max().item(), 1e-30)


def rel_err_each(a, b) -> tuple:
    """(max abs error, max over elements of |a - b| / |b|)."""
    diff = (a - b).abs()
    return (diff.max().item(),
            (diff / b.abs().clamp_min(1e-30)).max().item())


def flip_points(feats, weights, biases, tau: float = FLIP_TAU):
    """Bool ``[N]``: the points whose pre-activation at some hidden layer of
    the dense stack (leaky-relu 0.2), for any of ``feats`` (one ``[N, C0]``
    feature set per evaluation), has ``|z| < tau * max |z|`` of that layer
    and evaluation."""
    import torch
    import torch.nn.functional as F

    near = torch.zeros(feats[0].shape[0], dtype=torch.bool,
                       device=feats[0].device)
    with torch.no_grad():
        for h in feats:
            for w, b in zip(weights[:-1], biases[:-1]):
                z = F.linear(h, w, b)
                near |= (z.abs() < tau * z.abs().max()).any(1)
                h = torch.where(z >= 0, z, 0.2 * z)
    return near


def chain_features(pts, ts, dt, weights, biases, n_freq_xyz: int,
                   n_freq_t: int, time_dependent: bool, n_evals: int,
                   sf_div: float) -> list:
    """The features of every evaluation of the plain chain
    (``chain_kernel.chain_plain``), with its advects."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import mlp_kernel
    from dynamic_video_depth_tpu_torch.ops.embedding import sceneflow_features

    feats, p, t = [], pts, ts
    with torch.no_grad():
        for k in range(n_evals):
            feats.append(sceneflow_features(p, t, n_freq_xyz, n_freq_t,
                                            time_dependent))
            if k + 1 < n_evals:
                p = p + mlp_kernel.fused_mlp_plain(feats[-1], weights,
                                                   biases) / sf_div
                t = t + dt
    return feats


def zero_rows(near, *gs) -> list:
    """``gs`` with the rows of the ``near`` points set to exactly 0."""
    import torch

    return [torch.where(near[:, None], torch.zeros_like(g), g) for g in gs]


def lookup_taps(coords, shapes, radius: int) -> int:
    """Distinct pyramid values that the lookup at ``coords [B, H, W, 2]``
    weighs, over the levels of ``shapes`` ((Hl, Wl) each): per point and
    level the rows times the columns its window's taps fall on (each point
    has a volume row of its own), clamping at the borders as the lookup
    does, and a tap of weight 0 (a coordinate on the grid) not counted."""
    import torch

    offsets = torch.arange(-radius, radius + 1, dtype=coords.dtype,
                           device=coords.device)
    c = coords.reshape(-1, 2)
    total = 0
    for lvl, (hl, wl) in enumerate(shapes):
        counts = []
        for axis, size in ((1, hl), (0, wl)):
            x = torch.clamp(c[:, axis:axis + 1] / 2.0 ** lvl + offsets, 0.0,
                            size - 1.0)
            x0 = torch.floor(x)
            x1 = torch.where(x > x0, torch.clamp(x0 + 1, max=size - 1.0), x0)
            s = torch.sort(torch.cat([x0, x1], 1), 1).values
            counts.append(1 + (s[:, 1:] != s[:, :-1]).sum(1))
        total += int((counts[0] * counts[1]).sum())
    return total


def mlp_flops(dims, n: int) -> float:
    """Float32 operations of one forward of the dense stack on n points (a
    multiply-add counts 2; the embedding and the activations not)."""
    return 2.0 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def build_mma_loop() -> str:
    """Compile ``MMA_LOOP`` into the kernels' build directory; its path."""
    from dynamic_video_depth_tpu_torch.ops.cuda import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "mma_loop.cu"
    src.write_text(MMA_LOOP)
    exe = build.BUILD_DIR / "mma_loop"
    subprocess.run([build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(exe), str(src)], check=True,
                   capture_output=True, timeout=300)
    return str(exe)


def sass_opcode(line: str) -> str:
    """The opcode of one ``cuobjdump -sass`` instruction line
    ("/*0070*/  @P0 RED.E.ADD.F32... ;  /* 0x... */" -> "RED.E.ADD.F32..."),
    "" for any other line."""
    if "*/" not in line:
        return ""
    tokens = line.split("*/", 1)[1].split()
    if tokens and tokens[0].startswith("@"):
        tokens = tokens[1:]
    return tokens[0] if tokens and not tokens[0].startswith("/*") else ""


def build_empty() -> str:
    """Compile ``EMPTY`` into a shared library in the kernels' build
    directory; its path."""
    from dynamic_video_depth_tpu_torch.ops.cuda import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "empty.cu"
    src.write_text(EMPTY)
    lib = build.BUILD_DIR / "libempty.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, timeout=300)
    return str(lib)


def launch_floor(path: str) -> dict:
    """The empty kernel's device time (``device_split``), its per-call time
    (``time_ms``) and the host time of one launch (``host_us``), launched
    through ctypes on the current stream as kernel A's wrapper launches."""
    import ctypes

    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import warp_kernel

    fn = ctypes.CDLL(path).dvd_empty
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        if fn(warp_kernel.stream_handle(0)) != 0:
            fail("the empty kernel did not launch")

    floor = {"split": device_split(launch, reps=20), "ms": time_ms(launch),
             "host_us": host_us(launch)}
    print(f"[floor] empty kernel (1 block of 32 threads) through ctypes: "
          f"device {floor['split']}; per call {floor['ms']:.4f} ms; host "
          f"{floor['host_us']:.2f} µs per launch (1,000 back to back)",
          flush=True)
    return floor


def phase_build(modules=None):
    """Build every kernel library at once (one nvcc each) and print the
    compiler's register and spill report; measure the launch floor and the
    ceiling of the MLP tiles' MMA instruction. ``modules`` limits the build
    to those kernel modules, and then nothing else is measured."""
    from dynamic_video_depth_tpu_torch.ops.cuda import KERNEL_MODULES, build

    only = modules is not None
    modules = KERNEL_MODULES if modules is None else modules
    with ThreadPoolExecutor(len(modules) + 2) as pool:
        extra = [] if only else [pool.submit(build_mma_loop),
                                 pool.submit(build_empty)]
        for future in [pool.submit(mod._lib) for mod in modules]:
            future.result()
        paths = [f.result() for f in extra]
    for mod in modules:
        report = build.library_path(mod.LIBRARY, mod.SOURCES,
                                    mod.FLAGS).with_suffix(".ptxas.txt")
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {mod.LIBRARY}] {line.strip()}")
    if only:
        return
    launch_floor(paths[1])
    rate = subprocess.run([paths[0]], check=True, capture_output=True,
                          text=True, timeout=120).stdout.strip()
    print(f"[mma] mma.sync.m16n8k8 TF32, operands in registers, 16 "
          f"accumulators a warp: {rate} TFLOP/s", flush=True)
    # instructions counted per library: the MLP tiles' tensor-core ops, the
    # warp's shared-memory atomics and global reductions
    counted = {"dvd_mlp_embed": ("HMMA", "HGMMA"),
               "dvd_mlp_chain": ("HMMA", "HGMMA"),
               "dvd_warp": ("ATOMS", "REDG", "ATOMG")}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for mod in KERNEL_MODULES:
        if mod.LIBRARY not in counted:
            continue
        lib = build.library_path(mod.LIBRARY, mod.SOURCES, mod.FLAGS)
        try:
            sass = subprocess.run([tool, "-sass", str(lib)],
                                  capture_output=True, text=True,
                                  timeout=120).stdout
        except (OSError, subprocess.SubprocessError) as exc:
            print(f"[sass {mod.LIBRARY}] could not look: {exc}")
            continue
        if not sass:
            print(f"[sass {mod.LIBRARY}] could not look: cuobjdump gave "
                  "nothing")
            continue
        found = collections.Counter(
            op for op in map(sass_opcode, sass.splitlines())
            if op.split(".")[0] in counted[mod.LIBRARY])
        print(f"[sass {mod.LIBRARY}] {dict(sorted(found.items()))} "
              f"(cuobjdump -sass)")


def report(results: dict, name: str, err: tuple, ms: float,
           plain_ms: float, what: str = "", variant: tuple = (),
           flops: float = 0.0, nbytes: float = 0.0,
           library_ms=None, excluded=None, split: str = "") -> None:
    """Print one comparison, fail past the tolerance, and keep the worst
    error and the first timing of each kernel with its bound; ``variant``
    names the branch checked, as ``ops.cuda.launch_variants`` keys it.
    ``flops`` are the float32 operations of a matrix-product kernel (its
    bound is 3xTF32 on the tensor cores, and its f32-FMA bound is printed
    too), ``nbytes`` the bytes a kernel must move (each input read once,
    each output written once); ``excluded`` the share of points whose
    cotangents the flip mask zeroed; ``split`` the device time of each
    CUDA kernel of one call (``device_split``)."""
    ok = err[1] <= TOL[name]
    bytes_ms = 1e3 * nbytes / HBM_BYTES
    ops_ms = 1e3 * 3.0 * flops / TF32_FLOPS
    bound_ms, bound_by = ((ops_ms, "operations") if ops_ms > bytes_ms
                          else (bytes_ms, "bytes"))
    extra = f", bound {bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%})"
    if flops:
        f32_ms = 1e3 * flops / F32_FLOPS
        extra += (f", {flops / ms / 1e9:.2f} TFLOP/s: {f32_ms / ms:.1%} of "
                  f"the f32-FMA bound {f32_ms:.4f} ms, {ops_ms / ms:.1%} of "
                  f"the 3xTF32 bound")
    if library_ms is not None:
        extra += f", library {library_ms:.4f} ms"
    if excluded is not None:
        extra += f"; flip mask excluded {excluded:.3%} of points"
    if split:
        extra += f"; device time per call: {split}"
    print(f"[kernel] {name}{what}: max_abs_err {err[0]:.3e} rel {err[1]:.3e} "
          f"(tol {TOL[name]:.0e}) {'ok' if ok else 'FAIL'}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms{extra}", flush=True)
    if not ok:
        fail(f"{name}{what} disagrees with its plain version: rel "
             f"{err[1]:.3e}")
    if name in results:
        old = results[name]
        results[name] = dict(old, err=max(old["err"], err[0]))
    else:
        results[name] = {"err": err[0], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms}
    if variant:
        results.setdefault("checked", set()).add((name, *variant))


def field_weights(gen, dev):
    from dynamic_video_depth_tpu_torch.models import SceneFlowFieldNet

    net = SceneFlowFieldNet(time_dependent=True, n_freq_xyz=16, n_freq_t=16,
                            net_width=256, n_layers=4, generator=gen).to(dev)
    return ([l.conv.weight.detach() for l in net.convs],
            [l.conv.bias.detach() for l in net.convs])


def field_points(gen, dev, n: int = N_PTS):
    import torch

    pts = torch.cat([2.0 * torch.rand(n, 2, generator=gen) - 1.0,
                     2.0 + 2.0 * torch.rand(n, 1, generator=gen)], 1)
    return pts.to(dev), torch.rand(n, 1, generator=gen).to(dev)


def time_ms_pair(fn, other, reps: int = 200) -> tuple:
    """Median per-call times in ms of ``fn`` and ``other``, as ``time_ms``
    takes them, in alternating calls: the host path of a small kernel
    spreads by microseconds over a run, and alternating shares the drift."""
    import torch

    times = ([], [])
    for i in range(2 * (reps + 3)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        (other if i % 2 else fn)()
        end.record()
        torch.cuda.synchronize()
        if i >= 6:
            times[i % 2].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def host_us(fn, calls: int = 1000) -> float:
    """Host time of one call in µs: ``calls`` calls enqueued back to back,
    host clock, one synchronize at the end."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t) / calls


def track_flows(h: int, w: int, gap: int, n: int = 1):
    """``flow_1_2 [n, h, w, 2]`` (CPU) of the first ``n`` pairs at ``gap``
    of the synthetic track with a moving object (``data/synthetic.py``, 10
    frames): exact depth-induced flows, smooth but for the object's edges,
    the traffic the train step warps by."""
    import torch

    from dynamic_video_depth_tpu_torch.data.synthetic import make_track

    with tempfile.TemporaryDirectory() as root:
        _, seq_dir = make_track(root, h=h, w=w, n_frames=10, gaps=(gap,),
                                moving_object=True)
        return torch.cat([torch.load(os.path.join(
            seq_dir, f"shuffle_False_gap_{gap:02d}_sequence_{i:05d}.pt"))[
                "flow_1_2"].float() for i in range(n)])


def random_flow(b: int, h: int, w: int, seed: int = 0):
    """Independent +-60 px flows per pixel (CPU), sending samples past every
    border, with a first row whose targets land exactly on x = W-1: the
    warp's worst case and correctness check."""
    import torch

    flow = 60.0 * torch.randn(b, h, w, 2,
                              generator=torch.Generator().manual_seed(seed))
    flow[:, 0, :, 0] = (w - 1) - torch.arange(w, dtype=torch.float32)
    return flow


def warp_flows(dev) -> dict:
    """The flows kernel A is timed at, [1, 224, 384, 2] on the card: the
    synthetic track's first gap-2 and gap-8 pair, and the random ±60 px
    flow."""
    return {"gap2": track_flows(H, W, 2).to(dev),
            "gap8": track_flows(H, W, 8).to(dev),
            "random60": random_flow(1, H, W).to(dev)}


def window_share(warp_kernel, flow, c: int) -> tuple:
    """The share of the warp backward's taps (four per pixel) that land in
    their warp's window, and the shares of the warps (tile rows) that add
    in 0 (no window), 1, 2 and 4 sub-steps (``warp_kernel.window_plan``)."""
    import torch

    _, h, w, _ = flow.shape
    xs = torch.arange(w, device=flow.device)
    ys = torch.arange(h, device=flow.device)[:, None]
    org, plan = warp_kernel.window_plan(flow, c)
    seg = xs // warp_kernel.TILE[0]
    org, steps = org[:, :, seg], plan[:, :, seg]
    x0 = torch.floor((xs + flow[..., 0]).clamp(0.0, w - 1.0)).long()
    y0 = torch.floor((ys + flow[..., 1]).clamp(0.0, h - 1.0)).long()
    size = (warp_kernel.WINDOW[0], warp_kernel.window_rows(c))
    inside = []
    for tx in (x0, (x0 + 1).clamp(max=w - 1)):
        for ty in (y0, (y0 + 1).clamp(max=h - 1)):
            lx, ly = tx - org[..., 0], ty - org[..., 1]
            inside.append((steps > 0) & (lx >= 0) & (lx < size[0])
                          & (ly >= 0) & (ly < size[1]))
    rows = [(plan == k).float().mean().item() for k in (0, 1, 2, 4)]
    return torch.stack(inside).float().mean().item(), rows


def phase_kernel_a(dev, results: dict) -> None:
    """Kernel A against its plain version at [1, 224, 384, C] for the depth
    warp's C = 4 and the fused loss's C = 3, at every flow of
    ``warp_flows`` (the gap-2 reading first: it is the JSON line's ``ms``);
    the library yardstick is ``F.grid_sample`` and its autograd backward.
    Then the host time of 1,000 back-to-back calls of each direction beside
    the library's, at the gap-2 flow."""
    import torch
    import torch.nn.functional as F

    from dynamic_video_depth_tpu_torch.ops.cuda import warp_kernel

    gen = torch.Generator().manual_seed(1)
    flows = warp_flows(dev)
    xs = torch.arange(W, device=dev, dtype=torch.float32)
    ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    for c in (4, 3):
        src = torch.randn(1, H, W, c, generator=gen).to(dev)
        g = torch.randn(1, H, W, c, generator=gen).to(dev)
        src_nchw = src.permute(0, 3, 1, 2).contiguous()
        g_nchw = g.permute(0, 3, 1, 2).contiguous()
        nbytes = 4.0 * H * W * (2 * c + 2)
        host = {}
        for name, flow in flows.items():
            out_k = warp_kernel.warp_forward_cuda(src, flow)
            out_p = warp_kernel.backward_warp_plain(src, flow)
            src_p = src.clone().requires_grad_(True)
            (warp_kernel.backward_warp_plain(src_p, flow) * g).sum().backward()
            dsrc_k = warp_kernel.warp_backward_cuda(g, flow)
            torch.cuda.synchronize()

            def plain_bwd():
                s = src.clone().requires_grad_(True)
                (warp_kernel.backward_warp_plain(s, flow) * g).sum().backward()

            # the library yardstick: grid_sample on NCHW, prepared untimed
            grid = torch.stack([2.0 * (xs + flow[..., 0]) / (W - 1) - 1.0,
                                2.0 * (ys + flow[..., 1]) / (H - 1) - 1.0],
                               -1)
            lib_src = src_nchw.clone().requires_grad_(True)
            lib_out = F.grid_sample(lib_src, grid, align_corners=True,
                                    padding_mode="border")

            def lib_fwd():
                return F.grid_sample(src_nchw, grid, align_corners=True,
                                     padding_mode="border")

            def lib_bwd():
                return torch.autograd.grad(lib_out, lib_src, g_nchw,
                                           retain_graph=True)

            def fwd():
                return warp_kernel.warp_forward_cuda(src, flow)

            def bwd():
                return warp_kernel.warp_backward_cuda(g, flow)

            what = f" [1,{H},{W},{c}] flow={name}"
            if hasattr(warp_kernel, "window_plan"):  # not the parent's
                share, rows = window_share(warp_kernel, flow, c)
                what += (f" (taps in a window {share:.2%}; rows by steps "
                         f"0/1/2/4: "
                         f"{'/'.join(f'{r:.1%}' for r in rows)})")
            fwd_ms, lib_fwd_ms = time_ms_pair(fwd, lib_fwd)
            bwd_ms, lib_bwd_ms = time_ms_pair(bwd, lib_bwd)
            report(results, "warp_fwd", rel_err(out_k, out_p), fwd_ms,
                   time_ms(lambda: warp_kernel.backward_warp_plain(src, flow)),
                   what, (c,), nbytes=nbytes, library_ms=lib_fwd_ms,
                   split=f"{device_split(fwd, reps=10)}; library "
                         f"{device_split(lib_fwd, reps=10)}")
            report(results, "warp_bwd", rel_err(dsrc_k, src_p.grad), bwd_ms,
                   time_ms(plain_bwd), what, (c,), nbytes=nbytes,
                   library_ms=lib_bwd_ms,
                   split=f"{device_split(bwd, reps=10)}; library "
                         f"{device_split(lib_bwd, reps=10)}")
            if name == "gap2":
                host = {"warp_fwd": (host_us(fwd), host_us(lib_fwd)),
                        "warp_bwd": (host_us(bwd), host_us(lib_bwd))}
        for kernel, (ours, lib) in host.items():
            lib_name = "F.grid_sample" + " backward" * (kernel == "warp_bwd")
            print(f"[host] {kernel} [1,{H},{W},{c}] flow=gap2: {ours:.2f} µs "
                  f"per call, {lib_name} {lib:.2f} µs (1,000 calls back to "
                  f"back, one sync)", flush=True)


def phase_kernel_b(dev, results: dict) -> None:
    """Kernel B against its plain version at 224x384."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import mlp_kernel
    from dynamic_video_depth_tpu_torch.ops.embedding import sceneflow_features

    gen = torch.Generator().manual_seed(0)

    # kernel B at N = 224 * 384 with the canonical field's random weights
    ws, bs = field_weights(gen, dev)
    dims = [ws[0].shape[1]] + [w.shape[0] for w in ws]
    pts, ts = field_points(gen, dev)
    gm = torch.randn(N_PTS, 3, generator=gen).to(dev)
    consts = mlp_kernel.embed_consts(16, 16, True, dev)
    near = flip_points(
        [sceneflow_features(pts, ts, 16, 16, True)], ws, bs)
    gm, = zero_rows(near, gm)
    fwd_k = mlp_kernel.mlp_forward_cuda(pts, ts, consts, ws, bs)
    dpts_k, dts_k, dws_k, dbs_k = mlp_kernel.mlp_backward_cuda(
        pts, ts, consts, ws, bs, gm)

    def plain_fwd():
        return mlp_kernel.mlp_embed_plain(pts, ts, ws, bs, 16, 16, True)

    def plain_grads():
        leaves = [t.clone().requires_grad_(True) for t in (pts, ts, *ws, *bs)]
        out = mlp_kernel.mlp_embed_plain(leaves[0], leaves[1], leaves[2:8],
                                         leaves[8:], 16, 16, True)
        (out * gm).sum().backward()
        return [t.grad for t in leaves]

    grads_p = plain_grads()
    grads_k = [dpts_k, dts_k, *dws_k, *dbs_k]
    torch.cuda.synchronize()
    bwd_err = max((rel_err(k, p) for k, p in zip(grads_k, grads_p)),
                  key=lambda e: e[1])
    # the MLP rows' library yardstick is the cuBLAS-backed plain stack
    fwd_plain_ms = time_ms(plain_fwd)
    bwd_plain_ms = time_ms(plain_grads, reps=10)
    report(results, "mlp_fwd", rel_err(fwd_k, plain_fwd()),
           time_ms(lambda: mlp_kernel.mlp_forward_cuda(pts, ts, consts, ws,
                                                       bs)),
           fwd_plain_ms, flops=mlp_flops(dims, N_PTS),
           library_ms=fwd_plain_ms, split=device_split(
               lambda: mlp_kernel.mlp_forward_cuda(pts, ts, consts, ws, bs)))
    report(results, "mlp_bwd", bwd_err,
           time_ms(lambda: mlp_kernel.mlp_backward_cuda(
               pts, ts, consts, ws, bs, gm), reps=10),
           bwd_plain_ms, flops=3 * mlp_flops(dims, N_PTS),
           library_ms=bwd_plain_ms, excluded=near.float().mean().item(),
           split=device_split(lambda: mlp_kernel.mlp_backward_cuda(
               pts, ts, consts, ws, bs, gm)))


def phase_kernel_c(dev, results: dict) -> None:
    """Kernel C at N = 86,016, full width, for every (n_steps, n_evals) of
    ``CHAINS``: the chain's values and every gradient against autograd of
    the plain chain; times of the backward alone (kernel C vs autograd's
    backward of the plain chain)."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import chain_kernel, mlp_kernel

    gen = torch.Generator().manual_seed(2)
    ws, bs = field_weights(gen, dev)
    pts, ts = field_points(gen, dev)
    dt = torch.full((N_PTS, 1), 1.0 / 6.0, device=dev)
    consts = mlp_kernel.embed_consts(16, 16, True, dev)
    dims = [ws[0].shape[1]] + [w.shape[0] for w in ws]
    gs_all = [(torch.randn(N_PTS, 3, generator=gen) / N_PTS).to(dev)
              for _ in range(3)]
    for n_steps, n_evals in CHAINS:
        args = (n_steps, n_evals, 100.0)
        acc, f0, f1, stash = chain_kernel.chain_forward_cuda(
            pts, ts, dt, consts, ws, bs, *args)
        near = flip_points(chain_features(pts, ts, dt, ws, bs, 16, 16, True,
                                          n_evals, 100.0), ws, bs)
        gs = zero_rows(near, *gs_all)

        def kernel_bwd():
            return chain_kernel.chain_backward_cuda(
                pts, ts, dt, consts, ws, bs, stash, *gs, *args)

        got = kernel_bwd()
        leaves = [t.clone().requires_grad_(True)
                  for t in (pts, ts, dt, *ws, *bs)]
        outs = chain_kernel.chain_plain(leaves[0], leaves[1], leaves[2],
                                        leaves[3:9], leaves[9:], 16, 16,
                                        True, *args)

        def plain_bwd():
            return torch.autograd.grad(outs, leaves, gs, retain_graph=True)

        want = plain_bwd()
        torch.cuda.synchronize()
        what = f" (n_steps, n_evals) = ({n_steps}, {n_evals})"
        fwd_err = max((rel_err(a, b) for a, b in zip((acc, f0, f1), outs)),
                      key=lambda e: e[1])
        print(f"[kernel] chain_fwd{what}: max_abs_err {fwd_err[0]:.3e} rel "
              f"{fwd_err[1]:.3e} (tol {TOL['chain_fwd']:.0e})", flush=True)
        if fwd_err[1] > TOL["chain_fwd"]:
            fail(f"chain forward{what}: rel {fwd_err[1]:.3e}")
        got = [got[0], got[1], got[2], *got[3], *got[4]]
        plain_ms = time_ms(plain_bwd, reps=5)
        report(results, "chain_bwd",
               max((rel_err(a, b) for a, b in zip(got, want)),
                   key=lambda e: e[1]),
               time_ms(kernel_bwd, reps=5), plain_ms, what,
               (n_steps, n_evals), flops=3 * n_evals * mlp_flops(dims, N_PTS),
               library_ms=plain_ms, excluded=near.float().mean().item(),
               split=device_split(kernel_bwd))
        del outs, want, leaves


def loss_inputs(dev, h: int, w: int):
    """Projection-loss inputs on the card: world points a few metres out,
    dead pixels behind camera 2, warped z under the 1e-3 clip, far-field
    pixels for the MiDaS masks."""
    import torch

    gen = torch.Generator().manual_seed(h)
    gp1 = torch.randn(1, h, w, 3, generator=gen) * 0.5
    gp1[..., 2] += 3.0
    w3 = torch.randn(1, h, w, 3, generator=gen) * 0.5
    w3[..., 2] += 3.0
    sf = torch.randn(1, h, w, 3, generator=gen) * 0.05
    gp1[:, :8, :8, 2] = -5.0
    sf[:, :8, :8, 2] = 0.0
    w3[:, 8:12, :16, 2] = torch.rand(1, 4, 16, generator=gen) * 1e-3
    w3[:, 20:24, 20:40, 2] = 150.0
    depth = torch.rand(1, h, w, generator=gen) * 5.0 + 0.5
    depth[:, 30:34, :50] = 120.0
    cam = torch.zeros(1, 24)
    cam[:, 0:9] = torch.eye(3).reshape(9)
    cam[:, 9:12] = torch.randn(1, 3, generator=gen) * 0.1
    cam[:, 12:21] = torch.tensor([0.8 * w, 0, w / 2, 0, 0.8 * w, h / 2,
                                  0, 0, 1.0])
    data = (torch.randn(1, h, w, 2, generator=gen) * 2.0,
            torch.rand(1, h, w, generator=gen), depth, cam)
    return [t.to(dev) for t in (gp1, w3, sf, *data)]


def phase_kernel_d(dev, results: dict) -> None:
    """Kernel D forward and backward at [1,224,384] and [1,320,576] in the
    use_disp + MiDaS main, the same in warm-up, the disparity-ratio and the
    plain-residual configurations."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import loss_kernel

    configs = {"use_disp+midas main": (True, False, True, False),
               "use_disp+midas warm": (True, False, True, True),
               "use_disp_ratio main": (False, True, False, False),
               "plain-residual main": (False, False, False, False)}
    for h, w in ((H, W), WIDE):
        args = loss_inputs(dev, h, w)
        cot = (torch.randn(4, generator=torch.Generator().manual_seed(1))
               / (h * w)).to(dev)
        for label, cfg in configs.items():
            flags = loss_kernel.flag_bits(*cfg)
            what = f" [1,{h},{w}] {label}"
            sums = loss_kernel.loss_forward_cuda(args, flags)
            grads = loss_kernel.loss_backward_cuda(args, flags, cot)
            leaves = [t.clone().requires_grad_(True) for t in args[:3]]
            ref = loss_kernel.projection_loss_plain(*leaves, *args[3:], *cfg)

            def plain_bwd():
                return torch.autograd.grad(ref, leaves, cot,
                                           retain_graph=True)

            ref_grads = plain_bwd()
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(g).all()) for g in grads):
                fail(f"loss_bwd{what}: non-finite gradient")
            # 13 input floats a pixel (gp1, w3, sf, flow, mask, depth); the
            # forward writes 4 sums, the backward 9 gradient floats a pixel
            def fwd():
                return loss_kernel.loss_forward_cuda(args, flags)

            def bwd():
                return loss_kernel.loss_backward_cuda(args, flags, cot)

            def plain_fwd():
                return loss_kernel.projection_loss_plain(*args, *cfg)

            report(results, "loss_fwd", rel_err_each(sums, ref.detach()),
                   time_ms(fwd), time_ms(plain_fwd), what,
                   nbytes=4.0 * 13 * h * w, split=device_split(fwd))
            report(results, "loss_bwd",
                   max((rel_err(a, b) for a, b in zip(grads, ref_grads)),
                       key=lambda e: e[1]),
                   time_ms(bwd), time_ms(plain_bwd), what,
                   nbytes=4.0 * 22 * h * w, split=device_split(bwd))


def phase_kernels_new(dev, results: dict) -> None:
    """The correlation lookup at RAFT's 288x512 shapes (B = 2, a 36x64
    grid, four levels, r = 4) with coordinates past every border, and
    fused_mlp forward and backward at N = 86,016 with the canonical widths
    132 -> 256 -> 256 x4 -> 3, each against its plain version (the backward
    against autograd of the plain stack)."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import corr_kernel, mlp_kernel

    gen = torch.Generator().manual_seed(3)
    h, w = RAFT_GRID
    pyramid, hl, wl = [], h, w
    for _ in range(RAFT_LEVELS):
        pyramid.append(torch.randn(2, h * w, hl, wl, generator=gen).to(dev))
        hl, wl = hl // 2, wl // 2
    coords = torch.rand(2, h, w, 2, generator=gen) * torch.tensor(
        [1.4 * w, 1.4 * h]) - torch.tensor([0.2 * w, 0.2 * h])
    # integer positions and the far corner take the clamped taps
    coords[0, 0, :3] = torch.tensor([[0.0, 0.0], [w - 1.0, h - 1.0],
                                     [5.0, 7.0]])
    args = (pyramid, coords.to(dev), RAFT_RADIUS)
    out = corr_kernel.lookup_forward_cuda(*args)
    ref = corr_kernel.lookup_correlation_plain(*args)
    torch.cuda.synchronize()
    # bytes this lookup needs: the distinct pyramid values that these
    # coordinates' windows weigh, the coordinates, the output
    taps = lookup_taps(args[1], [c.shape[2:] for c in pyramid], RAFT_RADIUS)
    outs = 2 * h * w * RAFT_LEVELS * (2 * RAFT_RADIUS + 1) ** 2
    report(results, "corr_lookup", rel_err(out, ref),
           time_ms(lambda: corr_kernel.lookup_forward_cuda(*args)),
           time_ms(lambda: corr_kernel.lookup_correlation_plain(*args)),
           f" [2,{h},{w}] L={RAFT_LEVELS} r={RAFT_RADIUS}",
           (RAFT_RADIUS, RAFT_LEVELS),
           nbytes=4.0 * (taps + outs + 2 * h * w * 2),
           split=device_split(lambda: corr_kernel.lookup_forward_cuda(*args),
                              reps=20))

    dims = [132] + [256] * 5 + [3]
    ws = [(torch.randn(b, a, generator=gen) * (2.0 / a) ** 0.5).to(dev)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(0.01 * torch.randn(b, generator=gen)).to(dev) for b in dims[1:]]
    feat = torch.randn(N_PTS, dims[0], generator=gen).to(dev)
    near = flip_points([feat], ws, bs)
    g, = zero_rows(near, torch.randn(N_PTS, dims[-1], generator=gen).to(dev))
    fwd_k = mlp_kernel.dense_forward_cuda(feat, ws, bs)
    dfeat_k, dws_k, dbs_k = mlp_kernel.dense_backward_cuda(feat, ws, bs, g)

    def plain_grads():
        leaves = [t.clone().requires_grad_(True) for t in (feat, *ws, *bs)]
        out = mlp_kernel.fused_mlp_plain(leaves[0], leaves[1:7], leaves[7:])
        (out * g).sum().backward()
        return [t.grad for t in leaves]

    grads_p = plain_grads()
    torch.cuda.synchronize()
    fwd_plain_ms = time_ms(lambda: mlp_kernel.fused_mlp_plain(feat, ws, bs))
    bwd_plain_ms = time_ms(plain_grads, reps=10)
    report(results, "dense_fwd",
           rel_err(fwd_k, mlp_kernel.fused_mlp_plain(feat, ws, bs)),
           time_ms(lambda: mlp_kernel.dense_forward_cuda(feat, ws, bs)),
           fwd_plain_ms, f" [{N_PTS},132]", flops=mlp_flops(dims, N_PTS),
           library_ms=fwd_plain_ms, split=device_split(
               lambda: mlp_kernel.dense_forward_cuda(feat, ws, bs)))
    report(results, "dense_bwd",
           max((rel_err(k, p) for k, p in
                zip([dfeat_k, *dws_k, *dbs_k], grads_p)), key=lambda e: e[1]),
           time_ms(lambda: mlp_kernel.dense_backward_cuda(feat, ws, bs, g),
                   reps=10),
           bwd_plain_ms, f" [{N_PTS},132]", flops=3 * mlp_flops(dims, N_PTS),
           library_ms=bwd_plain_ms, excluded=near.float().mean().item(),
           split=device_split(
               lambda: mlp_kernel.dense_backward_cuda(feat, ws, bs, g)))


def phase_trainer(dev, workdir: str, label: str, extra: list, gaps: tuple,
                  n_frames: int, kernels: tuple, midas: bool = False):
    """A warm-up epoch and a main epoch through the trainer's entry on a
    224x384 synthetic track; returns the launch counts of that run and
    its launches by variant (``ops.cuda.launch_variants``)."""
    import torch

    from dynamic_video_depth_tpu_torch.data.batches import to_device
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track
    from dynamic_video_depth_tpu_torch.ops import cuda as kernels_mod
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)
    from dynamic_video_depth_tpu_torch.train.cli import build_trainer

    track = f"smoke_{label}"
    make_track(workdir, track=track, n_frames=n_frames, h=H, w=W, gaps=gaps)
    snaps = {}

    def params(net):
        return [p.detach().clone() for p in net.parameters()]

    def on_epoch_end(epoch, trainer):
        if epoch == 1:
            snaps["depth_warm"] = params(trainer.step.net_depth)
            snaps["adam_depth_warm"] = sum(
                p in trainer.step.optimizer.state
                for p in trainer.step.net_depth.parameters())

    argv = ["--net", "scene_flow_motion_field", "--dataset", "davis_sequence",
            "--data_root", workdir, "--track_id", track,
            "--gaps", ",".join(map(str, gaps)),
            "--epoch", "2", "--warm_sf", "1", "--batch_size", "1",
            "--optim", "adam", "--lr", "1e-6", "--scene_lr_mul", "1000",
            "--acc_mul", "1", "--disp_mul", "1", "--flow_mul", "1",
            "--sf_mag_div", "100", "--time_dependent", "--use_disp",
            "--log_time", "--vali_batches", "2", "--manual_seed", "0",
            "--device", str(dev)] + extra
    trainer = build_trainer(argv, on_epoch_end=on_epoch_end)
    step = trainer.step
    if midas:
        bias_midas_output(step.net_depth)
    snaps["depth_0"] = params(step.net_depth)
    snaps["sf_0"] = params(step.net_sf)
    kernels_mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    trainer.train()
    torch.cuda.synchronize()
    counts = kernels_mod.launch_counts()
    variants = kernels_mod.launch_variants()

    hist = trainer.history
    gaps_by_phase = {w: {r["gap"] for r in hist if r["warm"] == w}
                     for w in (True, False)}
    if gaps_by_phase != {True: set(gaps), False: set(gaps)}:
        fail(f"{label}: gaps per phase {gaps_by_phase}, want {gaps} in both")
    for r in hist:
        if not all(math.isfinite(r[k]) for k in
                   ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss",
                    "acc_reg")):
            fail(f"{label}: non-finite loss: {r}")
    if not all(r["loss"] > 0.0 for r in hist if not r["warm"]):
        fail(f"{label}: a main-phase loss is not above 0 (the loss masks "
             f"have no mass): {[r['loss'] for r in hist]}")
    if any(not torch.equal(a, b) for a, b in
           zip(snaps["depth_0"], snaps["depth_warm"])):
        fail(f"{label}: the depth net changed during warm-up")
    if snaps["adam_depth_warm"]:
        fail(f"{label}: the depth net's Adam group stepped during warm-up")
    if all(torch.equal(a, b) for a, b in
           zip(snaps["depth_warm"], params(step.net_depth))):
        fail(f"{label}: the depth net did not move in the main epoch")
    if all(torch.equal(a, b) for a, b in
           zip(snaps["sf_0"], params(step.net_sf))):
        fail(f"{label}: the scene-flow net did not move")
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        fail(f"{label}: kernels not launched on the path: {missing} "
             f"({counts})")

    # inference on one frame: depth [1, H, W] > 0 and finite scene flow
    pred, vali = step.vali_step(to_device(trainer.dataset_vali[0], dev))
    if tuple(pred["depth"].shape) != (1, H, W) or \
            not bool(torch.isfinite(pred["depth"]).all()) or \
            not bool((pred["depth"] > 0).all()) or \
            tuple(pred["sf_1_2"].shape) != (1, H, W, 3) or \
            not bool(torch.isfinite(pred["sf_1_2"]).all()) or \
            not math.isfinite(float(vali["loss"])):
        fail(f"{label}: inference output has the wrong shape or non-finite "
             "values")

    def median_ms(warm, gap=None):
        ms = [1e3 * r["seconds"] for r in hist if r["warm"] == warm
              and (gap is None or r["gap"] == gap)]
        return statistics.median(ms[1:] if gap is None else ms)

    by_gap = ", ".join(f"gap {g} {median_ms(False, g):.2f}" for g in gaps)
    print(f"[slice] {label} {H}x{W} batch 1: median step "
          f"{median_ms(False):.2f} ms main, {median_ms(True):.2f} ms warm-up "
          f"(first step of each phase excluded); main by gap: {by_gap}; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{counts}; by variant {variants}", flush=True)
    return counts, variants


FRAME_KEYS = ("img", "pose_c2w", "intrinsics", "depth_pred", "depth_mvs",
              "img_orig", "motion_seg")


def shifted_flows(h: int, w: int):
    """RAFT-resolution flows ``[h, w, 2]`` on the CPU moving 4.6 px right
    and back, but inconsistent in one block (the backward flow there moves
    3 px right): both masks hold occluded pixels (the block, and the
    columns whose target leaves the frame) and visible ones."""
    import torch

    f12 = torch.zeros(h, w, 2)
    f12[..., 0] = 4.6
    f21 = -f12
    f21[h // 4:h // 2, w // 3:w // 2, 0] = 3.0
    return f12, f21


def phase_preprocess(dev, workdir: str, card: str, results: dict):
    """Stages 1-3 through the port's preprocessing functions at full width
    on a synthetic raw track in memory (8 frames at 448x768, a camera path,
    triangulated points in front of the camera, object masks): MiDaS with
    the biased output conv (depth near 50), RAFT at 288x512 with 20
    iterations over gaps 1, 2 and 4, the packing. Checks every artifact and
    one hourglass train step on a packed pair; times the stages, a steady
    RAFT call and its profile. Returns the launch counts and variants of
    stages 1-3."""
    import numpy as np
    import torch

    from dynamic_video_depth_tpu_torch.data.batches import to_device
    from dynamic_video_depth_tpu_torch.data.davis_sequence import Dataset
    from dynamic_video_depth_tpu_torch.data.synthetic import make_raw_davis
    from dynamic_video_depth_tpu_torch.ops import cuda as kernels_mod
    from dynamic_video_depth_tpu_torch.preprocess import flows, frames, pairs
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)
    from dynamic_video_depth_tpu_torch.train import (
        LossConfig, SceneFlowMotionFieldStep, TrainStepConfig)

    root, track = os.path.join(workdir, "davis_processed"), "smoke_raw"
    frame_dir = os.path.join(root, "frames_midas", track)
    flow_dir = os.path.join(root, "flow_pairs", track)
    seq_dir = os.path.join(root, "sequences_select_pairs_midas", track, "001")
    imgs, matrices, K, points, masks = make_raw_davis(RAW_FRAMES, *RAW_HW)
    depth_fn = frames.make_midas_depth_fn(device=dev)
    bias_midas_output(depth_fn.net)
    n_pairs = sum(RAW_FRAMES - g for g in PRE_GAPS)

    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    scale = frames.process_davis_track(imgs, matrices, K, points, masks,
                                       frame_dir, depth_fn)
    t1 = time.perf_counter()
    flows.process_track(frame_dir, flow_dir, gaps=PRE_GAPS, device=dev)
    t2 = time.perf_counter()
    pairs.pack_track(frame_dir, flow_dir, seq_dir, gaps=PRE_GAPS)
    t3 = time.perf_counter()
    counts = kernels_mod.launch_counts()
    variants = kernels_mod.launch_variants()

    if counts["corr_lookup"] != flows.RAFT_ITERS * n_pairs:
        fail(f"preprocess: {counts['corr_lookup']} lookups for {n_pairs} "
             f"RAFT calls of {flows.RAFT_ITERS} iterations")
    others = {k: v for k, v in counts.items()
              if v and k not in PREPROCESS_KERNELS}
    if others:
        fail(f"preprocess: launched kernels of another path: {others}")
    wh = frames.working_resolution(*RAW_HW)  # 256x384 for 448x768
    for i in range(RAW_FRAMES):
        with np.load(os.path.join(frame_dir, f"frame_{i:05d}.npz")) as f:
            d = dict(f)
        shapes = {"img": wh + (3,), "pose_c2w": (4, 4), "intrinsics": (3, 3),
                  "depth_pred": wh, "depth_mvs": wh,
                  "img_orig": RAW_HW + (3,), "motion_seg": wh}
        if sorted(d) != sorted(FRAME_KEYS) or any(
                d[k].shape != shapes[k] or not np.isfinite(d[k]).all()
                for k in FRAME_KEYS):
            fail(f"preprocess: frame {i} has wrong keys, shapes or "
                 f"non-finite values: { {k: v.shape for k, v in d.items()} }")
        if not set(np.unique(d["motion_seg"])) <= {0.0, 1.0}:
            fail(f"preprocess: frame {i}'s motion_seg is not 0/1")
    flow_files = sorted(os.listdir(flow_dir))
    if len(flow_files) != n_pairs:
        fail(f"preprocess: {len(flow_files)} flow pairs, want {n_pairs}")
    occluded = []
    for name in flow_files:
        with np.load(os.path.join(flow_dir, name)) as f:
            d = dict(f)
        for k in ("flow_1_2", "flow_2_1"):
            if d[k].shape != wh + (2,) or not np.isfinite(d[k]).all():
                fail(f"preprocess: {name}:{k} is {d[k].shape} or not finite")
        for k in ("mask_1", "mask_2"):
            if d[k].shape != wh or d[k].dtype != np.uint8 or \
                    not set(np.unique(d[k])) <= {0, 1}:
                fail(f"preprocess: {name}:{k} is not a 0/1 uint8 mask")
            occluded.append(float(d[k].mean()))
    opt = argparse.Namespace(track_id=track, gaps=",".join(map(str, PRE_GAPS)),
                             subsample=False, data_root=root)
    ds = Dataset(opt, mode="train")
    want = sum(RAW_FRAMES - 1 - g for g in PRE_GAPS)
    if len(ds) != want:
        fail(f"preprocess: {len(ds)} packed pairs, want {want}")
    for i in range(len(ds)):
        b = ds[i]
        if b["img_1"].shape != (1,) + wh + (3,) or \
                not np.isfinite(b["flow_1_2"]).all():
            fail(f"preprocess: packed pair {i} does not load as a batch")
    step = SceneFlowMotionFieldStep(TrainStepConfig(
        lr=1e-6, scene_lr_mul=1000.0, loss=LossConfig(
            flow_mul=1.0, disp_mul=1.0, acc_mul=1.0, use_disp=True)),
        device=dev)
    logs = step.train_step(to_device(ds[0], dev), ds[0]["steps"], False)
    if not all(math.isfinite(float(v)) for v in logs.values()):
        fail(f"preprocess: the train step on a packed pair: {logs}")

    # random RAFT weights occlude nearly every pixel, so stage 2's masks
    # above are all ones; post-processing of a known shift at full size
    # gives masks with both values, on the card as on the CPU
    f12, f21 = shifted_flows(*flows.RAFT_RES)
    post_cpu = flows.postprocess_pair(f12, f21, wh)
    post = flows.postprocess_pair(f12.to(dev), f21.to(dev), wh)
    for k, v in post.items():
        if v.dtype != post_cpu[k].dtype or v.shape != post_cpu[k].shape:
            fail(f"preprocess: post-processing {k} on the card is "
                 f"{v.dtype} {v.shape}")
    flow_err = max(float(np.abs(post[k] - post_cpu[k]).max())
                   for k in ("flow_1_2", "flow_2_1"))
    shares = [float(post[k].mean()) for k in ("mask_1", "mask_2")]
    flips = max(int((post[k] != post_cpu[k]).sum())
                for k in ("mask_1", "mask_2"))
    if not (flow_err <= 1e-4 and flips == 0 and all(0 < s < 1
                                                    for s in shares)):
        fail(f"preprocess: post-processing of a known shift: flow error "
             f"{flow_err:.3e}, occluded shares {shares}, {flips} mask "
             f"pixels differ from the CPU")
    post_walls = []
    for _ in range(5):
        t = time.perf_counter()
        flows.postprocess_pair(f12.to(dev), f21.to(dev), wh)
        post_walls.append(1e3 * (time.perf_counter() - t))
    # stage 2 again, with cuDNN's per-shape set-up already done
    t = time.perf_counter()
    flows.process_track(frame_dir, flow_dir + "_again", gaps=PRE_GAPS,
                        device=dev)
    stage2_again = 1e3 * (time.perf_counter() - t) / n_pairs

    # one RAFT call in the steady state, timed and profiled
    flow_fn = flows.make_raft_flow_batch_fn(device=dev)
    with np.load(os.path.join(frame_dir, "frame_00000.npz")) as f:
        im1 = flows._prep_raft_input(dict(f), dev)[None]
    with np.load(os.path.join(frame_dir, "frame_00001.npz")) as f:
        im2 = flows._prep_raft_input(dict(f), dev)[None]
    flow_fn(im1, im2)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        flow_fn(im1, im2)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        flow_fn(im1, im2)
    kernels = sorted(((e.self_device_time_total, e.key)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    busy = sum(us for us, _ in kernels)
    lookup = sum(us for us, key in kernels if "corr_lookup" in key)
    top = "; ".join(f"{key[:60]} {us / 1e3:.3f} ms" for us, key in kernels[:8])

    print(f"[preprocess] {card}: {RAW_FRAMES} frames {RAW_HW[0]}x"
          f"{RAW_HW[1]} -> {wh[0]}x{wh[1]}, scale {scale:.4f}; stage 1 "
          f"{1e3 * (t1 - t0) / RAW_FRAMES:.2f} ms/frame (MiDaS at the raw "
          f"resolution, batches of 4); stage 2 {1e3 * (t2 - t1) / n_pairs:.2f}"
          f" ms/pair over {n_pairs} pairs (RAFT {flows.RAFT_RES[0]}x"
          f"{flows.RAFT_RES[1]}, {flows.RAFT_ITERS} iterations, the first "
          f"call, the resizes, masks and files included), lookup "
          f"{results['corr_lookup']['ms']:.4f} ms x {flows.RAFT_ITERS} per "
          f"call; stage 3 {1e3 * (t3 - t2):.2f} ms for {len(ds)} pairs; "
          f"occluded share {statistics.mean(occluded):.3f}; launches "
          f"{counts}; by variant {variants}", flush=True)
    print(f"[preprocess] {card}: post-processing of one pair on the card "
          f"(two flow resizes {flows.RAFT_RES[0]}x{flows.RAFT_RES[1]} -> "
          f"{wh[0]}x{wh[1]}, both masks, the copy to the host) median wall "
          f"{statistics.median(post_walls):.3f} ms over 5; stage 2 run again "
          f"{stage2_again:.2f} ms/pair; a known shift: "
          f"occluded shares {shares[0]:.4f} / {shares[1]:.4f}, flows within "
          f"{flow_err:.3e} of the CPU, masks equal", flush=True)
    print(f"[raft] {card}: one call (both directions of a pair, B = 2) "
          f"median wall {statistics.median(walls):.2f} ms over 5; profiled "
          f"kernel time {busy / 1e3:.2f} ms in {len(kernels)} kernel names, "
          f"lookup {lookup / 1e3:.3f} ms; top: {top}", flush=True)
    return counts, variants


def phase_raft_reference(dev) -> None:
    """RAFT at 64x96 with 3 iterations, the same random weights and
    randomised batch-norm statistics, on the card (the lookup kernel) and
    on the CPU (its plain gather): both flows agree to rtol 1e-3 / atol
    1e-4."""
    import copy

    import torch

    from dynamic_video_depth_tpu_torch.models.raft import RAFT
    from dynamic_video_depth_tpu_torch.ops.cuda import corr_kernel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(7)
    net = RAFT(generator=gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.05, generator=gen)
                m.running_var.uniform_(0.7, 1.3, generator=gen)
    ims = [255.0 * torch.rand(2, 64, 96, 3, generator=gen) for _ in range(2)]
    corr_kernel.reset_launches()
    with torch.no_grad():
        cpu = net(*ims, iters=3)
        card = copy.deepcopy(net).to(dev)(*(t.to(dev) for t in ims), iters=3)
    if corr_kernel.launches["corr_lookup"] != 3:
        fail(f"RAFT on the card launched the lookup "
             f"{corr_kernel.launches['corr_lookup']} times, want 3")
    worst = 0.0
    for name, c, g in zip(("flow8", "flow_up"), cpu, card):
        g = g.cpu()
        excess = ((g - c).abs() - 1e-3 * c.abs()).max().item()
        worst = max(worst, (g - c).abs().max().item())
        if excess > 1e-4:
            fail(f"RAFT {name} on the card disagrees with the CPU: "
                 f"|diff| - 1e-3 |cpu| up to {excess:.3e}")
    print(f"[raft] 64x96, 3 iterations: card (kernel) vs CPU (plain) max "
          f"|diff| {worst:.3e} (tol rtol 1e-3 / atol 1e-4)", flush=True)


def phase_small_reference(dev) -> None:
    """The full-width hourglass slice on a small input (32x48) against the
    same steps on the CPU: on the card the fused chain and loss (auto), on
    the CPU the plain, unfused path; the losses of a warm-up and a main step
    at gap 2 agree."""
    import numpy as np
    import torch

    from dynamic_video_depth_tpu_torch.train import (
        LossConfig, SceneFlowMotionFieldStep, TrainStepConfig)

    cfg = TrainStepConfig(lr=1e-6, scene_lr_mul=1000.0, loss=LossConfig(
        flow_mul=1.0, disp_mul=1.0, acc_mul=1.0, use_disp=True))
    rng = np.random.RandomState(0)
    b, h, w = 1, 32, 48
    f = 0.8 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    batch = {
        "img_1": rng.rand(b, h, w, 3), "img_2": rng.rand(b, h, w, 3),
        "flow_1_2": 2.0 * rng.randn(b, h, w, 2), "mask_2": np.ones((b, h, w)),
        "R_1": np.eye(3)[None], "R_2": np.eye(3)[None], "K": K[None],
        "K_inv": np.linalg.inv(K)[None], "t_1": np.zeros((b, 3)),
        "t_2": np.full((b, 3), 0.01), "time_stamp_1": np.zeros((b, h, w, 1)),
        "time_step": np.float32(0.1),
    }
    batch = {k: torch.as_tensor(np.asarray(v, np.float32))
             for k, v in batch.items()}
    logs = {}
    for device in ("cpu", dev):
        step = SceneFlowMotionFieldStep(cfg, device=device, seed=0)
        if (step.chain_fused, step.loss_fused) != ((device != "cpu",) * 2):
            fail(f"auto picked the wrong paths on {device}")
        on = {k: v.to(device) for k, v in batch.items()}
        logs[device == "cpu"] = [
            {k: float(v) for k, v in step.train_step(on, 2, warm).items()}
            for warm in (True, False)]
    worst = max(abs(g[k] - c[k]) / max(abs(c[k]), 1e-12)
                for g, c in zip(logs[False], logs[True]) for k in c)
    print(f"[small] 32x48 warm+main step, fused on the card vs plain "
          f"unfused on the CPU: worst relative loss difference {worst:.3e} "
          f"(tol 1e-4)", flush=True)
    if not worst <= 1e-4:
        fail(f"the slice on the card disagrees with the CPU: {logs}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--warp_only", action="store_true",
                        help="build and time kernel A alone (phase 2's warp "
                        "lines and the [host] lines), print no result")
    parser.add_argument("--repo", default=HERE,
                        help="the checkout whose package is driven (with "
                        "--warp_only: another tree's kernel A, for a "
                        "before/after on one card)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if args.warp_only:
        from dynamic_video_depth_tpu_torch.ops.cuda import warp_kernel

        print(f"[tree] {os.path.abspath(args.repo)}: kernel A alone",
              flush=True)
        phase_build([warp_kernel])
        phase_kernel_a(dev, {})
        return
    phase_build()
    results = {}
    phase_kernel_a(dev, results)
    phase_kernel_b(dev, results)
    phase_kernel_c(dev, results)
    phase_kernel_d(dev, results)
    phase_kernels_new(dev, results)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        # 6 frames: 4 gap-1, 3 gap-2 and 1 gap-4 pairs per epoch
        counts, midas_variants = phase_trainer(
            dev, workdir, "midas", ["--midas"], (1, 2, 4), 6, MIDAS_KERNELS,
            midas=True)
        # 5 frames: 3 gap-1 and 2 gap-2 pairs per epoch
        hourglass, hourglass_variants = phase_trainer(
            dev, workdir, "hourglass",
            ["--use_pallas_sf_chain", "off", "--use_pallas_loss", "off"],
            (1, 2), 5, HOURGLASS_KERNELS)
        torch.cuda.empty_cache()
        pre_counts, pre_variants = phase_preprocess(dev, workdir, card,
                                                    results)
    if hourglass["chain_bwd"] or hourglass["loss_fwd"]:
        fail(f"the hourglass path with the fused paths off launched kernel "
             f"C or D: {hourglass}")
    if not (midas_variants.get(("warp_fwd", 3))
            and midas_variants.get(("warp_bwd", 3))):
        fail(f"the MiDaS path did not launch the warp at 3 channels: "
             f"{midas_variants}")
    unchecked = (set(midas_variants) | set(hourglass_variants)
                 | set(pre_variants)) - results.pop("checked")
    if unchecked:
        fail(f"a path launched kernel variants that phase 2 did not check: "
             f"{sorted(unchecked)}")
    phase_raft_reference(dev)
    phase_small_reference(dev)
    if "jax" in sys.modules or "dynamic_video_depth_tpu" in sys.modules:
        fail("JAX was imported")
    # launches on the path that runs each kernel: the MiDaS trainer for
    # A-D, preprocessing for the lookup; fused_mlp is on no path (0)
    counts["corr_lookup"] = pre_counts["corr_lookup"]
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"dynamic_video_depth_tpu_torch/csrc/{SOURCE[name]}",
        "replaces": REPLACES[name], "launches": counts[name],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    } for name, r in results.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
