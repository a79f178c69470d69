#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.
``--only {warp,loss,corr,mlp} [--repo <checkout>]`` builds and times one
kernel family alone, phase 2's lines for it (kernel A, kernel D, the
lookup, or kernels B, C and fused_mlp, which share their tiles), for
the package of another checkout too (a before/after on one card), and
prints no result; ``--warp_only`` is ``--only warp``.

1. Builds the hand-written kernels (``dynamic_video_depth_tpu_torch/csrc``),
   one nvcc per library, all at once, and prints the card's name and power
   limit and the launch floor (``[floor]``: an empty kernel through ctypes).
2. Holds every kernel against its plain PyTorch version on the card, at the
   main paths' shapes, and times both: the warp (A) at 224x384 with 4
   channels (the depth warp) and 3 (the fused loss's point warp), at the
   synthetic track's gap-2 and gap-8 flows and at random +-60 px flows,
   with the host time of 1,000 calls (``[host]``); the embedded MLP (B) at
   224x384; the Euler-chain backward (C) at 86,016 points for (n_steps,
   n_evals) = (1, 2), (2, 2), (4, 4), (6, 6) and (8, 8), the chains of gaps
   1, 2, 4, 6 and 8; the projection-loss forward and backward (D) at 224x384 and 320x576 in the use_disp, MiDaS, warm-up and main
   configurations, at batch 2, at 37x53 and with fields 4 bytes past 16,
   with its forward's run-to-run bit identity and the host time of 1,000
   calls; the RAFT correlation lookup
   at 288x512 (B = 2, a 36x64 grid, four levels, r = 4) beside its
   yardstick, four ``F.grid_sample`` calls and a ``torch.cat``; fused_mlp
   forward and backward at 86,016 points, 132 -> 256 -> 256 x4 -> 3 (on no
   path, as in the JAX package). Then A-D at the largest shapes the bench
   (phase 14) gives them (``BENCH_SHAPES``): the warp forward and backward
   at [16,224,384,C] and [1,320,576,C], C = 4 and 3, at the bench's flows
   and random +-60 px; B forward and backward and C at (1, 2), (2, 2) and
   (8, 8) at 1,376,256 points (batch 16) and 184,320 (320x576), the plain
   chain in chunks of ``CHAIN_CHUNK`` points at every size; D's main
   configuration at batch 16 (320x576 is above). Each check records the
   kernel, variant and (batch, h, w) it held.
3. Runs the canonical DAVIS recipe through the train entry
   (``dynamic_video_depth_tpu_torch.train``): the flags of
   ``experiments/davis/train_sequence.sh`` with ``--epoch 2 --warm_sf 1``,
   ``--epoch_batches`` (every pair once), ``--vali_batches 2``, a synthetic
   224x384 track over gaps 1, 2 and 4 and ``--manual_seed 0``: MiDaS at
   full width with the fixture's biased output conv, the fused paths on,
   checkpoints, loggers and visualization, then the chained test entry on
   the card (``--test_template experiments/davis/test_cmd.txt``). It checks
   the losses (the main loss above 0: the far-field masks are live), that
   the depth net and its Adam stayed fixed during warm-up, that both nets
   moved, that the path launched every kernel, the warp at 3 channels among
   them, and only at channel counts and chains that phase 2 checked; that
   the run's artifacts exist; that ``best.pt`` in a fresh step gives each
   frame's depth of the test entry's npz bit for bit and a scene flow
   within ``TOL`` of kernel B's plain version, and that the test entry
   launched kernel B's forward once a frame; that ``--resume -1 --epoch 3``
   restores ``checkpoint.pt`` bit for bit and trains epoch 3. Its
   ``[recipe]`` line gives the test entry's time a frame, the background
   writer's seconds a checkpoint (phase 13 has the loop's blocking time),
   the checkpoint sizes, the visualization seconds and
   the share of each epoch's wall time outside the train steps.
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
8. Runs phase 3's recipe with ``--mixed_precision_training`` on phase 3's
   track: MiDaS in bfloat16 (float32 parameters, optimizers, geometry and
   kernels), a warm-up and a main epoch, then the chained test entry. It
   checks what phase 3 checks of the steps and kernels, that the test
   entry's npz depth is a fresh bfloat16 ``predict`` of ``best.pt`` bit for
   bit, and in one more main step that every convolution of the depth net
   took bfloat16 input and the depth reached the geometry as float32. Its
   ``[bf16]`` line gives the median main step at gap 2 in bfloat16 and in
   float32 (phase 3's trained step), timed in turns, the five CUDA kernels
   with the most device time in one profiled step of each with the device
   time of the FFT convolution path (FFT and complex-GEMM kernels), and the
   test entry's time a frame.
9. Runs ``experiments/shutterstock/train_sequence.sh``'s flags with
   ``--use_cnn --optim sgd --sgd_dampening 0.1 --wdecay 1e-4
   --log_grad_stats --remat_depth`` on a synthetic ShutterStock track
   picked by ``--track_id 0`` (MiDaS at full width in float32, the
   ``FCNUnet`` scene-flow field), a warm-up and a main epoch, then its
   chained test command (``experiments/shutterstock/test_cmd.txt``). It
   checks that kernels A and D launched and B and C did not, that
   ``checkpoint.pt`` holds SGD momentum buffers and ``--resume -1``
   restores them bit for bit, the grad-stat columns of ``epoch_loss.csv``
   (the depth terms 0 in warm-up and above 0 after) and the test entry's
   npz depth against ``best.pt``; its ``[variants]`` line gives the step's
   median time.

10. The fleet (``train/fleet.py``, ``parallel/``), on phase 3's track:
   (a) ``python -m dynamic_video_depth_tpu_torch.train.fleet`` at ``--dp
   1`` on NCCL with a world of one, the recipe's flags cut to a warm-up and
   a main epoch of three steps, MiDaS at full width (a biased seed-0 MiDaS
   that every worker loads through ``DVD_MIDAS_CKPT``): the per-track
   artifacts, the losses (the main loss above 0), kernels A-D launched on
   the rank (B's backward runs only at gap 1 in warm-up, so it may not) and
   only at variants phase 2 checked, and ``--resume -1`` restoring
   ``checkpoint.pt`` bit for bit; (b) two gloo ranks sharing
   cuda:0 through ``parallel.multi_video``: ``DataParallelStep`` at batch 2
   (a pair a rank), a warm-up and a main step, the ranks' parameters equal
   bit for bit after each, against the one-process step at batch 2 on the
   card (losses at rtol 1e-4; 99% of each net's parameters within its
   tolerance: a tenth of lr for the depth net, whose one Adam update is
   +-lr, rtol 1e-4 / atol 1e-6 for the field), a control, the same steps
   without the gradients' all-reduce, that must fall below 99% on each
   net, and a two-video ``MultiVideoOptimizer`` against single-video
   steps on the same pairs;
   (c) where the machine has two or more cards, (a) on two tracks at
   ``--dp 1`` and then at ``--dp 2`` over NCCL, else a line saying that it
   did not run. Its ``[fleet]`` line gives the median step per rank, the
   gradient all-reduce's time and bytes a step (gloo through the host: no
   measure of NCCL), the one-process step beside the data-parallel one,
   the launches by rank and the phase's wall time.

11. The input pipeline (``data/prefetch.py``, the loop's log pipeline),
   the profiler and ShutterStock preprocessing, on phase 3's track with the
   recipe's flags, four epochs of every pair once (a warm-up, then three
   main epochs): (a) the float32 recipe from the device cache and with
   ``--no_device_cache`` at seed 0, the streaming run starting each main
   step from the cached run's depth-net parameters (two free runs part
   through the warp backward's atomic order, amplified by training): the
   losses within rtol 1e-5 step by step, the same pairs, every cached
   batch (and validation frame) a fresh ``to_device`` of its file bit for
   bit after training, the cache's bytes the sum of its batches';
   (b) the same with ``--mixed_precision_training`` streaming and cached,
   in turns with (a): the median main step at gap 2 over epochs 3-4 (its
   span on the device clock, and the interval between step-end events),
   the median data wait, the host time of one batch's read, collate and
   copy (pageable and pinned) and the cache's bytes; (c) the cached bf16
   run's ``--profile_dir`` trace of epoch 2: kernels A-D by name, the step
   and data-wait spans, and the device's idle share of the epoch; (d) the
   fleet entry at ``--dp 1`` with ``--no_device_cache`` against phase 10
   (a)'s cached run, losses within rtol 1e-5 over the steps both start
   from the same state (the warm-up and the first main step); (e)
   ShutterStock stage 1
   (``preprocess/run_shutterstock.py``) on 8 synthetic 432x768 frames in
   memory (``get_im_size``: 224x384) with MiDaS on the card against a CPU
   run of the same arrays and weights (relative 1e-4), stages 2-3 at gaps
   1 and 2 on the card (20 lookups a RAFT call), the pairs through
   ``--dataset shutterstock``; no ``h5py``. Each cached path launches A-D
   and every variant any path of the phase launched was checked in phase
   2. Its ``[pipeline]`` lines give these readings.

12. The tools (``dynamic_video_depth_tpu_torch/tools/``) and DAVIS stage 1
   at DAVIS's raw size: (a) the golden checks through their entry points'
   ``main`` on fake full-width checkpoints from seeds, in the official
   layouts (MiDaS in the ``{"model", "optimizer"}`` wrapper with the
   biased output conv, the hourglass's inner keys with the unused
   ``uncertainty_layer``, RAFT with the ``module.`` prefix), each at its
   protocol size on the card (depth 224x384, RAFT 288x512 x 20): freeze
   (exit 0, the card within the JAX scripts' tolerance of the CPU:
   relative 1e-3, 0.05 px EPE), recheck (0), another artifact (2), a
   perturbed golden (1); RAFT launches the lookup 20 times a call at the
   variant phase 2 checked; (b) ``run_davis.main --stage frames`` on 4
   synthetic raw 1080x1920 frames in the JPEG layout (MiDaS at 1088x1920,
   the biased checkpoint of (a)): every frame's depth at the working size
   and finite, ms a frame; (c) ``step_profile`` on the MiDaS fused step at
   224x384, gap 2, float32 and bf16 (A-D launched at checked variants and
   found by name in the trace): busy and idle shares, device time by
   category, the top 5 convolution shapes; (d) ``roofline`` in float32,
   TF32 and bf16: the ten shapes with the most time x count, their
   algorithm class, TFLOP/s and share of the peak, the sums, and the
   float32 sum beside (c)'s float32 convolution time with their ratio (a
   reading, not a gate). Its lines are ``[golden]``, ``[davis1080]``,
   ``[profile]`` and ``[roofline]``, with the phase's wall time.

13. The background checkpoint writer, the MidasNet_mod mask head and the
   reference's unfused geometry: (a) phase 3's recipe again through
   ``cli.build_run`` (MiDaS at full width, the fixture's biased output
   conv, a warm-up and a main epoch of every pair once, ``--save_every 1
   --save_net 1``), its saves through ``runtime/checkpoint.py::
   AsyncSaver``, then the chained test entry: ``checkpoint.pt``,
   ``nets/0002.pt`` (and ``best.pt`` when epoch 2 wrote it) load to what a
   synchronous ``save_checkpoint`` of the same state holds, bit for bit;
   ``--resume -1`` from it and the unbroken run take the next step (a
   gap-2 pair) from that shared state with bit-equal losses (the
   parameters' largest difference after the update is printed: the warp
   backward adds in atomic order); the ``[saver]`` line gives the loop's
   blocking ms a save beside a synchronous save's, the writer's seconds
   and bytes a file, a main step at gap 2 with a write of a fresh snapshot
   in flight against without one (four steps a turn, in turns, after the
   checks), the epochs' share of wall time outside the steps and the
   run's peak device memory; then the same run with synchronous saves
   (``save_checkpoint``, swapped in) and with the writer, in turns, with
   each run's epoch walls, its whole ``train`` and its peak device memory
   (``[saver turns]``); (b) ``MidasNet(mask_branch=True,
   freeze_backbone=True)`` at 224x384 on the card and on the CPU in
   float32 against the CPU in float64, forward and backward (the card's
   error within ``MASK_FACTOR`` times the float32 CPU run's, for the
   depth, the mask and the heads' gradients; no backbone gradient), and
   the mask head's device time and that of its first 3x3 256->128
   convolution at 112x192 at batch 2 (``[mask]``); (c)
   ``flow_by_depth``, ``scene_flow_projection`` and ``rigidity_loss`` at
   224x384 on the card against the CPU, values and the depths' gradients
   (relative ``TOL['warp_bwd']``), the fused stages against the unfused
   functions on the card (the same tolerance), and kernel A launched at
   C=3 and C=4 by them, forward and backward (``[geometry]``).

14. The port's bench (``tools/bench.py``) through its ``main``: every leg
   of ``bench.py`` (the bf16 MiDaS step at 224x384, batch 1, gap 2, 9
   blocks of 20 steps; MiDaS at batches 1/2/4/8/16 and gaps 1/4/8; the
   hourglass at batches 1/4/8/16, gap 2 and gaps 1/8), then ``--wide``
   (320x576, ``remat_depth``), each in the bench's own protocol. Its JSON
   lines parse (printed as ``[bench json]``); every leg's loss is finite
   and not 0; A-D launched on every MiDaS leg, A and B on every hourglass
   leg (``BENCH_KERNELS``); each kernel and variant a leg launched was
   checked in phase 2 at that variant, the leg's h x w and at least its
   batch. The bench's ``[bench]`` line of each leg (its ms a step, device
   span, pairs/s, loss and peak memory) is printed with the card in
   front.

The trainer reads each step's losses up to 16 steps late, so a ``[slice]`` or ``[variants]`` median step is the step's span on
the device clock (an event before its first launch to one after its last),
not a host wall that ends in a synchronisation.

Phases 8, 9, 10, 11, 12, 13 and 14 run after phase 5, in that order;
phase 3's trained run is kept for phase 8's float32 yardstick, and each
run's files are removed once checked.

Phase 1 also counts the tensor-core instructions (HMMA, HGMMA) in the two
MLP libraries and the warp's shared atomics and global reductions with
``cuobjdump -sass`` where the toolkit has it, and
measures the rate of the weight-gradient pass's instruction alone
(``MMA_LOOP``).
Phase 2's gradient checks of the MLP kernels (``mlp_bwd``, ``chain_bwd``,
``dense_bwd``) zero the cotangents of the points whose hidden
pre-activations lie within roundoff of 0 (``flip_points``: there two right
float32 computations may take different leaky-relu slopes) on both sides,
and print the share excluded; ``TOL`` is not loosened for it. Each
``[kernel]`` line gives the kernel's bound (bytes over 3.35 TB/s, or the
3xTF32 tensor-core bound, 3 x FLOPs over 495 TFLOP/s, for the MLP kernels,
with their f32-FMA bound share and achieved TFLOP/s) and a library
yardstick: ``F.grid_sample`` and its autograd backward for the warp, the
cuBLAS-backed plain stack for the MLP kernels, four ``F.grid_sample``
calls (one a level) and a ``torch.cat`` for the lookup, none for the
loss. Each line also gives the device time of every CUDA kernel that
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
import gc
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
CHAINS = ((1, 2), (2, 2), (4, 4), (6, 6), (8, 8))  # (n_steps, n_evals)
# of gaps 1, 2, 4, 6 and 8
# the largest shapes the bench (tools/bench.py) gives the kernels, (batch,
# h, w): batch 16 at 224x384 (its batch legs) and 320x576 (--wide); phase 2
# checks A-D there too, the chain at these of CHAINS: (2, 2), which every
# batch leg and --wide launch (gap 2), and the smallest and the largest
# scratch
BENCH_SHAPES = ((16, H, W), (1, *WIDE))
BENCH_CHAINS = ((1, 2), (2, 2), (8, 8))
# the chain's plain version runs in chunks of this many points, each chunk's
# forward untimed (a gap-8 chain's autograd graph at 1,376,256 points
# outgrows the card)
CHAIN_CHUNK = 2 * N_PTS
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
# the canonical recipe and its chained test command (the smoke's phase 3)
RECIPE = "experiments/davis/train_sequence.sh"
TEST_TEMPLATE = "experiments/davis/test_cmd.txt"
# the ShutterStock recipe and the variants phase 9 adds to it
SS_RECIPE = "experiments/shutterstock/train_sequence.sh"
SS_TEST_TEMPLATE = "experiments/shutterstock/test_cmd.txt"
VARIANT_FLAGS = ["--use_cnn", "--optim", "sgd", "--sgd_dampening", "0.1",
                 "--wdecay", "1e-4", "--log_grad_stats", "--remat_depth"]
GRAD_STATS = ("grad_norm_depth", "grad_norm_sf", "grad_max_depth",
              "grad_max_sf")
# kernels each path must launch; fused_mlp (dense_*) is on no path, as in
# the JAX package, and is held in phase 2 only
HOURGLASS_KERNELS = ("warp_fwd", "warp_bwd", "mlp_fwd", "mlp_bwd")
MIDAS_KERNELS = HOURGLASS_KERNELS + ("chain_bwd", "loss_fwd", "loss_bwd")
# the CNN scene-flow field takes neither kernel B nor the chain
VARIANT_KERNELS = ("warp_fwd", "warp_bwd", "loss_fwd", "loss_bwd")
PREPROCESS_KERNELS = ("corr_lookup",)
# RAFT at 288x512: a 36x64 grid at 1/8, four levels, radius 4; both
# directions of one pair in one batch
RAFT_GRID = (36, 64)
RAFT_LEVELS, RAFT_RADIUS = 4, 4
# the synthetic raw track of the preprocessing phase (multiples of 32 for
# MiDaS at the raw resolution)
RAW_FRAMES, RAW_HW, PRE_GAPS = 8, (448, 768), (1, 2, 4)
# the ceiling of the instruction the MLP weight-gradient pass uses: a loop
# of TF32 mma.sync.m16n8k8 on register operands, 16 independent
# accumulators a warp,
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


def kernel_name(key: str) -> str:
    """A profiler key without ``void``, anonymous namespaces and the
    argument list."""
    return (key.replace("(anonymous namespace)::", "").replace("void ", "")
            .split("(")[0])


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
                         kernel_name(e.key)))
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
           library_ms=None, excluded=None, split: str = "",
           shape: tuple = ()) -> None:
    """Print one comparison, fail past the tolerance, and keep the worst
    error and the first timing of each kernel with its bound; ``variant``
    names the branch checked, as ``ops.cuda.launch_variants`` keys it.
    ``flops`` are the float32 operations of a matrix-product kernel (its
    bound is 3xTF32 on the tensor cores, and its f32-FMA bound is printed
    too), ``nbytes`` the bytes a kernel must move (each input read once,
    each output written once); ``excluded`` the share of points whose
    cotangents the flip mask zeroed; ``split`` the device time of each
    CUDA kernel of one call (``device_split``); ``shape`` the (batch, h, w)
    of the inputs checked (the points' shape for the MLP kernels), kept
    with the name and variant as (name, variant, batch, h, w)."""
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
    if shape:
        results.setdefault("shapes", set()).add((name, tuple(variant),
                                                 *shape))


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


def bench_flow(b: int, h: int, w: int):
    """``flow_1_2 [b, h, w, 2]`` (CPU) of the bench's batch
    (``data/synthetic.py::synthetic_batch``, ``RandomState(0)``): +-1 px
    Gaussian flows."""
    import numpy as np

    from dynamic_video_depth_tpu_torch.data.synthetic import synthetic_batch

    return synthetic_batch(b, h, w, np.random.RandomState(0),
                           "cpu")["flow_1_2"]


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


def warp_case(results: dict, src, g, flow, what: str) -> tuple:
    """Kernel A forward and backward on ``src [B, h, w, C]`` by ``flow``
    against the plain versions, timed beside the library yardstick
    (``F.grid_sample`` on NCHW and its autograd backward, prepared
    untimed); returns the four calls (kernel and library, each way)."""
    import torch
    import torch.nn.functional as F

    from dynamic_video_depth_tpu_torch.ops.cuda import warp_kernel

    b, h, w, c = src.shape
    dev = src.device
    xs = torch.arange(w, device=dev, dtype=torch.float32)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    src_nchw = src.permute(0, 3, 1, 2).contiguous()
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    nbytes = 4.0 * b * h * w * (2 * c + 2)
    out_k = warp_kernel.warp_forward_cuda(src, flow)
    out_p = warp_kernel.backward_warp_plain(src, flow)
    src_p = src.clone().requires_grad_(True)
    (warp_kernel.backward_warp_plain(src_p, flow) * g).sum().backward()
    dsrc_k = warp_kernel.warp_backward_cuda(g, flow)
    torch.cuda.synchronize()

    def plain_bwd():
        s = src.clone().requires_grad_(True)
        (warp_kernel.backward_warp_plain(s, flow) * g).sum().backward()

    grid = torch.stack([2.0 * (xs + flow[..., 0]) / (w - 1) - 1.0,
                        2.0 * (ys + flow[..., 1]) / (h - 1) - 1.0], -1)
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

    if hasattr(warp_kernel, "window_plan"):  # not the parent's
        share, rows = window_share(warp_kernel, flow, c)
        what += (f" (taps in a window {share:.2%}; rows by steps 0/1/2/4: "
                 f"{'/'.join(f'{r:.1%}' for r in rows)})")
    fwd_ms, lib_fwd_ms = time_ms_pair(fwd, lib_fwd)
    bwd_ms, lib_bwd_ms = time_ms_pair(bwd, lib_bwd)
    report(results, "warp_fwd", rel_err(out_k, out_p), fwd_ms,
           time_ms(lambda: warp_kernel.backward_warp_plain(src, flow)),
           what, (c,), nbytes=nbytes, library_ms=lib_fwd_ms,
           split=f"{device_split(fwd, reps=10)}; library "
                 f"{device_split(lib_fwd, reps=10)}", shape=(b, h, w))
    report(results, "warp_bwd", rel_err(dsrc_k, src_p.grad), bwd_ms,
           time_ms(plain_bwd), what, (c,), nbytes=nbytes,
           library_ms=lib_bwd_ms,
           split=f"{device_split(bwd, reps=10)}; library "
                 f"{device_split(lib_bwd, reps=10)}", shape=(b, h, w))
    return fwd, lib_fwd, bwd, lib_bwd


def phase_kernel_a(dev, results: dict) -> None:
    """Kernel A against its plain version at [1, 224, 384, C] for the depth
    warp's C = 4 and the fused loss's C = 3, at every flow of
    ``warp_flows`` (the gap-2 reading first: it is the JSON line's ``ms``);
    the library yardstick is ``F.grid_sample`` and its autograd backward.
    Then the host time of 1,000 back-to-back calls of each direction beside
    the library's, at the gap-2 flow. Then the bench's largest shapes
    (``BENCH_SHAPES``: batch 16 at 224x384, 320x576), C = 4 and 3, at the
    bench's flows (``synthetic_batch``) and random ±60 px."""
    import torch

    gen = torch.Generator().manual_seed(1)
    flows = warp_flows(dev)
    for c in (4, 3):
        src = torch.randn(1, H, W, c, generator=gen).to(dev)
        g = torch.randn(1, H, W, c, generator=gen).to(dev)
        host = {}
        for name, flow in flows.items():
            fwd, lib_fwd, bwd, lib_bwd = warp_case(
                results, src, g, flow, f" [1,{H},{W},{c}] flow={name}")
            if name == "gap2":
                host = {"warp_fwd": (host_us(fwd), host_us(lib_fwd)),
                        "warp_bwd": (host_us(bwd), host_us(lib_bwd))}
        for kernel, (ours, lib) in host.items():
            lib_name = "F.grid_sample" + " backward" * (kernel == "warp_bwd")
            print(f"[host] {kernel} [1,{H},{W},{c}] flow=gap2: {ours:.2f} µs "
                  f"per call, {lib_name} {lib:.2f} µs (1,000 calls back to "
                  f"back, one sync)", flush=True)
    for b, h, w in BENCH_SHAPES:
        flows = {"bench": bench_flow(b, h, w).to(dev),
                 "random60": random_flow(b, h, w).to(dev)}
        for c in (4, 3):
            src = torch.randn(b, h, w, c, generator=gen).to(dev)
            g = torch.randn(b, h, w, c, generator=gen).to(dev)
            for name, flow in flows.items():
                warp_case(results, src, g, flow,
                          f" [{b},{h},{w},{c}] flow={name}")


def phase_kernel_b(dev, results: dict) -> None:
    """Kernel B against its plain version at the points of 224x384, then at
    those of ``BENCH_SHAPES`` (1,376,256 and 184,320)."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import mlp_kernel
    from dynamic_video_depth_tpu_torch.ops.embedding import sceneflow_features

    gen = torch.Generator().manual_seed(0)

    # kernel B with the canonical field's random weights
    ws, bs = field_weights(gen, dev)
    dims = [ws[0].shape[1]] + [w.shape[0] for w in ws]
    consts = mlp_kernel.embed_consts(16, 16, True, dev)
    for b, h, w in ((1, H, W), *BENCH_SHAPES):
        n = b * h * w
        pts, ts = field_points(gen, dev, n)
        gm = torch.randn(n, 3, generator=gen).to(dev)
        near = flip_points(
            [sceneflow_features(pts, ts, 16, 16, True)], ws, bs)
        gm, = zero_rows(near, gm)
        fwd_k = mlp_kernel.mlp_forward_cuda(pts, ts, consts, ws, bs)
        dpts_k, dts_k, dws_k, dbs_k = mlp_kernel.mlp_backward_cuda(
            pts, ts, consts, ws, bs, gm)

        def plain_fwd():
            return mlp_kernel.mlp_embed_plain(pts, ts, ws, bs, 16, 16, True)

        def plain_grads():
            leaves = [t.clone().requires_grad_(True)
                      for t in (pts, ts, *ws, *bs)]
            out = mlp_kernel.mlp_embed_plain(leaves[0], leaves[1],
                                             leaves[2:8], leaves[8:], 16, 16,
                                             True)
            (out * gm).sum().backward()
            return [t.grad for t in leaves]

        def fwd():
            return mlp_kernel.mlp_forward_cuda(pts, ts, consts, ws, bs)

        def bwd():
            return mlp_kernel.mlp_backward_cuda(pts, ts, consts, ws, bs, gm)

        grads_p = plain_grads()
        grads_k = [dpts_k, dts_k, *dws_k, *dbs_k]
        torch.cuda.synchronize()
        bwd_err = max((rel_err(k, p) for k, p in zip(grads_k, grads_p)),
                      key=lambda e: e[1])
        del grads_p, grads_k, dpts_k, dts_k, dws_k, dbs_k
        what = f" {n:,} points ([{b},{h},{w}])"
        # the MLP rows' library yardstick is the cuBLAS-backed plain stack
        fwd_plain_ms = time_ms(plain_fwd)
        bwd_plain_ms = time_ms(plain_grads, reps=10)
        report(results, "mlp_fwd", rel_err(fwd_k, plain_fwd()),
               time_ms(fwd), fwd_plain_ms, what, flops=mlp_flops(dims, n),
               library_ms=fwd_plain_ms, split=device_split(fwd),
               shape=(b, h, w))
        report(results, "mlp_bwd", bwd_err, time_ms(bwd, reps=10),
               bwd_plain_ms, what, flops=3 * mlp_flops(dims, n),
               library_ms=bwd_plain_ms, excluded=near.float().mean().item(),
               split=device_split(bwd), shape=(b, h, w))
        del fwd_k, near
        torch.cuda.empty_cache()


def chain_plain_grads(pts, ts, dt, ws, bs, gs, args, chunk: int):
    """The plain chain over ``chunk`` points at a time: its values, the
    gradients at every input (``pts``, ``ts``, ``dt``, then the weights and
    biases) for the cotangents ``gs`` by autograd, and the device ms of the
    backwards alone (each chunk's forward untimed; ``time_ms`` of each
    chunk's backward, summed). The points' values and gradients are
    concatenated, the parameters' gradients summed over the chunks in
    order."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import chain_kernel

    params = [t.clone().requires_grad_(True) for t in (*ws, *bs)]
    values, point_grads, param_grads, ms = [], [], None, 0.0
    for i in range(0, pts.shape[0], chunk):
        leaves = [t[i:i + chunk].clone().requires_grad_(True)
                  for t in (pts, ts, dt)]
        outs = chain_kernel.chain_plain(*leaves, params[:6], params[6:], 16,
                                        16, True, *args)
        cots = [g[i:i + chunk] for g in gs]

        def backward():
            return torch.autograd.grad(outs, leaves + params, cots,
                                       retain_graph=True)

        got = backward()
        ms += time_ms(backward, reps=5, warmup=1)
        values.append([o.detach() for o in outs])
        point_grads.append(got[:3])
        param_grads = list(got[3:]) if param_grads is None else [
            a + b for a, b in zip(param_grads, got[3:])]
        del outs, got
    return ([torch.cat(v) for v in zip(*values)],
            [torch.cat(g) for g in zip(*point_grads)] + param_grads, ms)


def phase_kernel_c(dev, results: dict) -> None:
    """Kernel C, full width, at N = 86,016 for every (n_steps, n_evals) of
    ``CHAINS``, then at the points of ``BENCH_SHAPES`` (1,376,256 and
    184,320) for ``BENCH_CHAINS``: the chain's values and every gradient
    against autograd of the plain chain (``chain_plain_grads``, in chunks
    of ``CHAIN_CHUNK`` points). Times of the backward alone: kernel C
    against the plain chain's backwards, their forwards untimed."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import chain_kernel, mlp_kernel

    gen = torch.Generator().manual_seed(2)
    ws, bs = field_weights(gen, dev)
    consts = mlp_kernel.embed_consts(16, 16, True, dev)
    dims = [ws[0].shape[1]] + [w.shape[0] for w in ws]
    for (b, h, w), chains in (((1, H, W), CHAINS),
                              *((shape, BENCH_CHAINS)
                                for shape in BENCH_SHAPES)):
        n = b * h * w
        pts, ts = field_points(gen, dev, n)
        dt = torch.full((n, 1), 1.0 / 6.0, device=dev)
        gs_all = [(torch.randn(n, 3, generator=gen) / n).to(dev)
                  for _ in range(3)]
        for n_steps, n_evals in chains:
            args = (n_steps, n_evals, 100.0)
            acc, f0, f1, stash = chain_kernel.chain_forward_cuda(
                pts, ts, dt, consts, ws, bs, *args)
            near = flip_points(chain_features(pts, ts, dt, ws, bs, 16, 16,
                                              True, n_evals, 100.0), ws, bs)
            gs = zero_rows(near, *gs_all)

            def kernel_bwd():
                return chain_kernel.chain_backward_cuda(
                    pts, ts, dt, consts, ws, bs, stash, *gs, *args)

            got = kernel_bwd()
            outs, want, plain_ms = chain_plain_grads(pts, ts, dt, ws, bs, gs,
                                                     args, CHAIN_CHUNK)
            torch.cuda.synchronize()
            what = (f" (n_steps, n_evals) = ({n_steps}, {n_evals})"
                    + (f" {n:,} points ([{b},{h},{w}])"
                       if (b, h, w) != (1, H, W) else ""))
            fwd_err = max((rel_err(x, y) for x, y in zip((acc, f0, f1),
                                                          outs)),
                          key=lambda e: e[1])
            print(f"[kernel] chain_fwd{what}: max_abs_err {fwd_err[0]:.3e} "
                  f"rel {fwd_err[1]:.3e} (tol {TOL['chain_fwd']:.0e})",
                  flush=True)
            if fwd_err[1] > TOL["chain_fwd"]:
                fail(f"chain forward{what}: rel {fwd_err[1]:.3e}")
            got = [got[0], got[1], got[2], *got[3], *got[4]]
            report(results, "chain_bwd",
                   max((rel_err(x, y) for x, y in zip(got, want)),
                       key=lambda e: e[1]),
                   time_ms(kernel_bwd, reps=5), plain_ms, what,
                   (n_steps, n_evals),
                   flops=3 * n_evals * mlp_flops(dims, n),
                   library_ms=plain_ms, excluded=near.float().mean().item(),
                   split=device_split(kernel_bwd), shape=(b, h, w))
            del outs, want, got, stash, acc, f0, f1, near, gs
            torch.cuda.empty_cache()


def loss_inputs(dev, h: int, w: int, b: int = 1):
    """Projection-loss inputs on the card: world points a few metres out,
    dead pixels behind camera 2, warped z under the 1e-3 clip, far-field
    pixels for the MiDaS masks; a camera a batch row."""
    import torch

    gen = torch.Generator().manual_seed(h)
    gp1 = torch.randn(b, h, w, 3, generator=gen) * 0.5
    gp1[..., 2] += 3.0
    w3 = torch.randn(b, h, w, 3, generator=gen) * 0.5
    w3[..., 2] += 3.0
    sf = torch.randn(b, h, w, 3, generator=gen) * 0.05
    gp1[:, :8, :8, 2] = -5.0
    sf[:, :8, :8, 2] = 0.0
    w3[:, 8:12, :16, 2] = torch.rand(b, 4, 16, generator=gen) * 1e-3
    w3[:, 20:24, 20:40, 2] = 150.0
    depth = torch.rand(b, h, w, generator=gen) * 5.0 + 0.5
    depth[:, 30:34, :50] = 120.0
    cam = torch.zeros(b, 24)
    cam[:, 0:9] = torch.eye(3).reshape(9)
    cam[:, 9:12] = torch.randn(b, 3, generator=gen) * 0.1
    cam[:, 12:21] = torch.tensor([0.8 * w, 0, w / 2, 0, 0.8 * w, h / 2,
                                  0, 0, 1.0])
    data = (torch.randn(b, h, w, 2, generator=gen) * 2.0,
            torch.rand(b, h, w, generator=gen), depth, cam)
    return [t.to(dev) for t in (gp1, w3, sf, *data)]


def misaligned(t):
    """``t`` copied into a buffer one float past its start: the same values
    4 bytes past a 16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


def phase_kernel_d(dev, results: dict) -> None:
    """Kernel D forward and backward at [1,224,384] and [1,320,576] in the
    use_disp + MiDaS main, the same in warm-up, the disparity-ratio and the
    plain-residual configurations; then the main configuration at batch 2,
    at 37x53 (rows of no multiple of 4 pixels), with 224x384 fields 4
    bytes past 16 and at the bench's batch 16. The forward's profile shows
    no more kernels than ``FORWARD_LAUNCHES`` (one, no memset) and its sums
    are bit-equal over repeated calls; the host time of 1,000 calls of
    each direction at 224x384."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import loss_kernel

    configs = {"use_disp+midas main": (True, False, True, False),
               "use_disp+midas warm": (True, False, True, True),
               "use_disp_ratio main": (False, True, False, False),
               "plain-residual main": (False, False, False, False)}
    main = {"use_disp+midas main": configs["use_disp+midas main"]}
    cases = [(1, H, W, False, configs), (1, *WIDE, False, configs),
             (2, H, W, False, main), (1, 37, 53, False, main),
             (1, H, W, True, main), (16, H, W, False, main)]
    # the parent's forward was a pixel kernel and a reduce
    n_fwd = getattr(loss_kernel, "FORWARD_LAUNCHES", 2)
    for b, h, w, shifted, cfgs in cases:
        args = loss_inputs(dev, h, w, b)
        if shifted:
            args = [misaligned(t) for t in args[:6]] + args[6:]
        cot = (torch.randn(4, generator=torch.Generator().manual_seed(1))
               / (b * h * w)).to(dev)
        for label, cfg in cfgs.items():
            flags = loss_kernel.flag_bits(*cfg)
            what = (f" [{b},{h},{w}] {label}"
                    + " (fields 4 bytes past 16)" * shifted)
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
            again = [loss_kernel.loss_forward_cuda(args, flags)
                     for _ in range(5)]
            if not all(torch.equal(sums, s) for s in again):
                fail(f"loss_fwd{what}: the sums differ between calls")

            def fwd():
                return loss_kernel.loss_forward_cuda(args, flags)

            def bwd():
                return loss_kernel.loss_backward_cuda(args, flags, cot)

            def plain_fwd():
                return loss_kernel.projection_loss_plain(*args, *cfg)

            split = device_split(fwd, reps=10)
            if split.count(" ms x") > n_fwd:
                fail(f"loss_fwd{what} launched more than {n_fwd} kernels or "
                     f"a memset: {split}")
            # 13 input floats a pixel (gp1, w3, sf, flow, mask, depth); the
            # forward writes 4 sums, the backward 9 gradient floats a pixel
            report(results, "loss_fwd", rel_err_each(sums, ref.detach()),
                   time_ms(fwd), time_ms(plain_fwd), what,
                   nbytes=4.0 * 13 * b * h * w, split=split, shape=(b, h, w))
            report(results, "loss_bwd",
                   max((rel_err(k, p) for k, p in zip(grads, ref_grads)),
                       key=lambda e: e[1]),
                   time_ms(bwd), time_ms(plain_bwd), what,
                   nbytes=4.0 * 22 * b * h * w,
                   split=device_split(bwd, reps=10), shape=(b, h, w))
            if (b, h, w, shifted) == (1, H, W, False) and \
                    label == "use_disp+midas main":
                print(f"[host] loss_fwd / loss_bwd{what}: {host_us(fwd):.2f}"
                      f" / {host_us(bwd):.2f} µs per call (1,000 calls back "
                      f"to back, one sync)", flush=True)


def lookup_library(pyramid, coords, radius: int):
    """The lookup's yardstick, used nowhere in the port: per level one
    ``F.grid_sample`` (bilinear, border padding, align_corners) of the
    ``[B N, 1, Hl, Wl]`` volumes at a ``[B N, K, K, 2]`` grid of the
    window's coordinates, then one ``torch.cat`` of the levels; the grids
    are made here, untimed. Returns the call."""
    import torch
    import torch.nn.functional as F

    b, h, w, _ = coords.shape
    k = 2 * radius + 1
    off = torch.arange(-radius, radius + 1, dtype=coords.dtype,
                       device=coords.device)
    vols, grids = [], []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        c = coords.reshape(b * h * w, 1, 1, 2) / 2.0 ** lvl
        x = (c[..., 0] + off[None, None, :]).expand(-1, k, k)
        y = (c[..., 1] + off[None, :, None]).expand(-1, k, k)
        grids.append(torch.stack([2.0 * x / max(wl - 1, 1) - 1.0,
                                  2.0 * y / max(hl - 1, 1) - 1.0], -1))
        vols.append(corr.reshape(b * h * w, 1, hl, wl))

    def run():
        return torch.cat([F.grid_sample(
            v, g, mode="bilinear", padding_mode="border",
            align_corners=True).reshape(b, h, w, k * k)
            for v, g in zip(vols, grids)], -1)

    return run


def phase_lookup(dev, results: dict) -> None:
    """The correlation lookup at RAFT's 288x512 shapes (B = 2, a 36x64
    grid, four levels, r = 4) with coordinates past every border, against
    its plain gather and beside its yardstick (``lookup_library``: four
    ``F.grid_sample`` calls and a ``torch.cat``), per call in alternating
    calls and on the device."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import corr_kernel

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
    library = lookup_library(*args)
    lib_err = rel_err(library(), ref)
    torch.cuda.synchronize()

    def kernel():
        return corr_kernel.lookup_forward_cuda(*args)

    # bytes this lookup needs: the distinct pyramid values that these
    # coordinates' windows weigh, the coordinates, the output
    taps = lookup_taps(args[1], [c.shape[2:] for c in pyramid], RAFT_RADIUS)
    outs = 2 * h * w * RAFT_LEVELS * (2 * RAFT_RADIUS + 1) ** 2
    ms, lib_ms = time_ms_pair(kernel, library)
    report(results, "corr_lookup", rel_err(out, ref), ms,
           time_ms(lambda: corr_kernel.lookup_correlation_plain(*args)),
           f" [2,{h},{w}] L={RAFT_LEVELS} r={RAFT_RADIUS}",
           (RAFT_RADIUS, RAFT_LEVELS),
           nbytes=4.0 * (taps + outs + 2 * h * w * 2), library_ms=lib_ms,
           split=f"{device_split(kernel, reps=20)}; library (4 x "
                 f"F.grid_sample + torch.cat) "
                 f"{device_split(library, reps=20)}")
    print(f"[host] corr_lookup [2,{h},{w}]: {host_us(kernel):.2f} µs per "
          f"call, library {host_us(library):.2f} µs (1,000 calls back to "
          f"back, one sync); the library against the plain gather: max "
          f"abs err {lib_err[0]:.3e} rel {lib_err[1]:.3e}", flush=True)


def phase_dense(dev, results: dict) -> None:
    """fused_mlp forward and backward at N = 86,016 with the canonical
    widths 132 -> 256 -> 256 x4 -> 3 against the plain stack (the backward
    against autograd of it)."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import mlp_kernel

    gen = torch.Generator().manual_seed(3)
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


def phase_trainer(dev, label: str, trainer, gaps: tuple, kernels: tuple,
                  midas: bool = False):
    """A warm-up epoch and a main epoch of a trainer that the entry built
    on a 224x384 synthetic track; returns the launch counts of that run,
    its launches by variant (``ops.cuda.launch_variants``) and each epoch's
    wall time from the start of training to its last epoch-end hook."""
    import torch

    from dynamic_video_depth_tpu_torch.data.batches import to_device
    from dynamic_video_depth_tpu_torch.ops import cuda as kernels_mod
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)

    snaps, walls = {}, {}

    def params(net):
        return [p.detach().clone() for p in net.parameters()]

    def on_epoch_end(epoch, trainer):
        walls[epoch] = time.perf_counter()
        if epoch == 1:
            snaps["depth_warm"] = params(trainer.step.net_depth)
            snaps["adam_depth_warm"] = sum(
                p in trainer.step.opt_depth.state
                for p in trainer.step.net_depth.parameters())

    trainer.on_epoch_end = on_epoch_end
    step = trainer.step
    if midas:
        bias_midas_output(step.net_depth)
    snaps["depth_0"] = params(step.net_depth)
    snaps["sf_0"] = params(step.net_sf)
    kernels_mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    walls[0] = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    counts = kernels_mod.launch_counts()
    variants = kernels_mod.launch_variants()
    walls = {e: walls[e] - walls[e - 1] for e in walls if e}

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
        fail(f"{label}: the depth net's Adam stepped during warm-up")
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
    return counts, variants, walls


def track_pairs(root: str, track: str) -> int:
    """The packed training pairs of a synthetic track, all gaps."""
    import glob

    return len(glob.glob(os.path.join(
        root, "sequences_select_pairs_midas", track, "001", "*.pt")))


def recipe_flags(track: str, recipe: str = RECIPE) -> list:
    """The flags between ``python train.py`` and ``"$@"`` in ``recipe``
    (``experiments/davis/train_sequence.sh``), ``${track}`` as ``track``."""
    import shlex

    with open(os.path.join(HERE, recipe)) as f:
        body = f.read().split("python train.py", 1)[1].split('"$@"', 1)[0]
    return shlex.split(body.replace("\\\n", " ").replace("${track}", track))


def phase_hourglass(dev, workdir: str):
    """The hourglass slice through the trainer's entry with the fused paths
    off: kernels A and B per evaluation, gaps 1 and 2."""
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track
    from dynamic_video_depth_tpu_torch.train.cli import build_trainer

    track, gaps = "smoke_hourglass", (1, 2)
    # 5 frames: 3 gap-1 and 2 gap-2 pairs per epoch
    make_track(workdir, track=track, n_frames=5, h=H, w=W, gaps=gaps)
    argv = ["--net", "scene_flow_motion_field", "--dataset", "davis_sequence",
            "--data_root", workdir, "--track_id", track,
            "--gaps", ",".join(map(str, gaps)),
            "--epoch", "2", "--warm_sf", "1", "--batch_size", "1",
            "--optim", "adam", "--lr", "1e-6", "--scene_lr_mul", "1000",
            "--acc_mul", "1", "--disp_mul", "1", "--flow_mul", "1",
            "--sf_mag_div", "100", "--time_dependent", "--use_disp",
            "--log_time", "--vali_batches", "2", "--manual_seed", "0",
            "--logdir", os.path.join(workdir, "runs"),
            "--device", str(dev), "--use_pallas_sf_chain", "off",
            "--use_pallas_loss", "off"]
    counts, variants, _ = phase_trainer(dev, "hourglass",
                                        build_trainer(argv), gaps,
                                        HOURGLASS_KERNELS)
    return counts, variants


def state_equal(a, b) -> bool:
    """Nested dicts/lists of tensors and numbers, equal bit for bit."""
    import torch

    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(state_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(state_equal(x, y) for x, y in zip(a, b)))
    return a == b


def phase_recipe(dev, workdir: str, card: str):
    """The canonical DAVIS recipe through the train entry: MiDaS at full
    width (the fixture's biased output conv), 224x384, the flags of
    ``experiments/davis/train_sequence.sh`` with two epochs (warm-up, main)
    over gaps 1, 2 and 4, checkpoints, loggers and visualization, then the
    chained test entry on the card. Checks the run's artifacts, that
    ``best.pt`` in a fresh step gives every frame's depth of the test
    entry's npz bit for bit and a scene flow that kernel B's plain version
    gives too, that the test entry launched kernel B once a frame, and that
    ``--resume -1`` loads ``checkpoint.pt`` bit for bit and trains on.
    Returns the training run's launch counts and variants, and the run
    (its trained float32 step is phase 8's yardstick); the run's files are
    removed at the end."""
    import glob
    from argparse import Namespace

    import numpy as np
    import torch

    from dynamic_video_depth_tpu_torch.data.batches import to_device
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track
    from dynamic_video_depth_tpu_torch.ops import Camera, unproject
    from dynamic_video_depth_tpu_torch.ops.cuda import mlp_kernel
    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        load_checkpoint, load_opt, read_checkpoint)
    from dynamic_video_depth_tpu_torch.train.cli import build_run
    from dynamic_video_depth_tpu_torch.train.scene_flow_motion_field import (
        Model)

    track, gaps = "smoke_recipe", (1, 2, 4)
    # 6 frames: 8 pairs over gaps 1, 2 and 4, every pair once an epoch
    make_track(workdir, track=track, n_frames=6, h=H, w=W, gaps=gaps)
    n_pairs = track_pairs(workdir, track)
    # flags a resumed run takes from its command line (UNIQUE_PARAMS)
    common = ["--epoch_batches", str(n_pairs), "--vali_batches", "2",
              "--batch_size", "1", "--device", str(dev)]
    argv = recipe_flags(track) + common + [
        "--epoch", "2", "--warm_sf", "1", "--data_root", workdir,
        "--track_id", track, "--gaps", ",".join(map(str, gaps)),
        "--logdir", os.path.join(workdir, "checkpoints"),
        "--test_template", os.path.join(HERE, TEST_TEMPLATE),
        "--manual_seed", "0"]
    run = build_run(argv)
    logdir = run.logdir
    counts, variants, walls = phase_trainer(dev, "midas", run.trainer, gaps,
                                            MIDAS_KERNELS, midas=True)
    hist = run.trainer.history
    t0 = time.perf_counter()
    run.chain_test()
    test_s = time.perf_counter() - t0

    # the artifacts of the run and of its test entry
    vali_frames = len(run.trainer.dataset_vali)
    want = ["checkpoint.pt", "best.pt", "nets/0001.pt", "nets/0002.pt",
            "opt.json", "opt.txt", "epoch_loss.csv", "html/progress.html",
            "html/progress.json", "test/epochbest_test.html",
            "test/epochbest_test.json"]
    want += [f"test/epochbest_test/batch{i:04d}.npz"
             for i in range(vali_frames)]
    for epoch in (1, 2):
        for phase in ("train", "vali"):
            d = f"visualize/epoch{epoch:04d}_{phase}"
            want += [f"{d}/index.html", f"{d}/rank0000_batch0000.npz"
                     if phase == "vali" else
                     f"{d}/rank0000_batch{n_pairs - 1:04d}.npz"]
            if not glob.glob(os.path.join(logdir, d, "*.png")):
                fail(f"recipe: no PNG in {d}")
    missing = [f for f in want if not os.path.isfile(os.path.join(logdir, f))]
    if missing:
        fail(f"recipe: missing artifacts {missing}")
    with open(os.path.join(logdir, "test", "epochbest_test.json")) as f:
        summary = json.load(f)
    if summary["frames"] != vali_frames or \
            summary["launches"]["mlp_fwd"] != vali_frames:
        fail(f"recipe: the test entry launched kernel B's forward "
             f"{summary['launches']['mlp_fwd']} times over "
             f"{summary['frames']} frames, want one a frame ({vali_frames})")

    # best.pt in a fresh step: the test entry's depth bit for bit, and the
    # scene flow of kernel B's plain version at the same weights
    opt = Namespace(**load_opt(logdir))
    model = Model(opt, device=dev, pretrained=False)
    load_checkpoint(os.path.join(logdir, "best.pt"), model.step)
    net_sf, cfg = model.step.net_sf, model.step.cfg
    layers = [layer.conv for layer in net_sf.convs]
    worst_sf = 0.0
    for i in range(vali_frames):
        batch = to_device(run.trainer.dataset_vali[i], dev)
        pred = model.step.predict(batch)
        dump = np.load(os.path.join(logdir, "test", "epochbest_test",
                                    f"batch{i:04d}.npz"))
        if not np.array_equal(pred["depth"].cpu().numpy(), dump["depth"]):
            fail(f"recipe: frame {i}: depth of best.pt in a fresh step "
                 "differs from the test entry's npz")
        cam = Camera(batch["R_1"], batch["t_1"], batch["K"], batch["K_inv"])
        pts = unproject(pred["depth"], cam).reshape(-1, 3)
        with torch.no_grad():
            plain = mlp_kernel.mlp_embed_plain(
                pts, batch["time_stamp_1"].reshape(-1, 1),
                [l.weight for l in layers], [l.bias for l in layers],
                cfg.n_freq_xyz, cfg.n_freq_t, cfg.time_dependent)
        plain = (plain / cfg.loss.sf_mag_div).reshape(pred["sf_1_2"].shape)
        worst_sf = max(worst_sf, rel_err(pred["sf_1_2"], plain)[1])
        sf_dump = torch.from_numpy(dump["sf_1_2"]).to(dev)
        worst_sf = max(worst_sf, rel_err(sf_dump, plain)[1])
    if not worst_sf <= TOL["mlp_fwd"]:
        fail(f"recipe: sf_1_2 of best.pt vs kernel B's plain version: "
             f"relative error {worst_sf:.3e} > {TOL['mlp_fwd']}")

    # --resume -1: the nets and both Adams bit for bit, then epoch 3
    ckpt = read_checkpoint(os.path.join(logdir, "checkpoint.pt"))
    resumed = build_run(["--full_logdir", logdir, "--resume", "-1",
                         "--epoch", "3"] + common)
    step = resumed.model.step
    loaded = [step.net_depth.state_dict(), step.net_sf.state_dict()]
    if resumed.start_epoch != 3 or not state_equal(loaded, ckpt["nets"]) \
            or not state_equal([o.state_dict() for o in step.optimizers],
                               ckpt["optimizers"]):
        fail("recipe: --resume -1 did not restore checkpoint.pt bit for bit "
             f"(start epoch {resumed.start_epoch})")
    resumed.train()
    hist3 = resumed.trainer.history
    if len(hist3) != n_pairs or any(r["epoch"] != 3 or r["warm"]
                                    for r in hist3) or \
            not all(math.isfinite(r[k]) for r in hist3 for k in
                    ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss",
                     "acc_reg")):
        fail(f"recipe: the resumed epoch 3 ran {len(hist3)} steps, want "
             f"{n_pairs} finite main-phase steps")

    by_file = collections.defaultdict(list)  # (seconds, bytes) by file
    for path, sec, n, *_ in run.saves:
        name = "nets/%04d.pt" if "/nets/" in path else os.path.basename(path)
        by_file[name].append((sec, n))
    saves = "; ".join(
        f"{name} {len(v)} saves "
        + "/".join(f"{sec:.3f}" for sec, _ in v) + f" s, {v[-1][1]} bytes"
        for name, v in sorted(by_file.items()))
    outside = {e: 1 - sum(r["seconds"] for r in hist if r["epoch"] == e)
               / walls[e] for e in walls}
    print(f"[recipe] {card}: MiDaS {H}x{W}, {n_pairs} steps an epoch, "
          f"{vali_frames} test frames; test entry median "
          f"{summary['median_predict_ms']:.2f} ms a frame predict only "
          f"(first frame excluded), {summary['median_frame_ms']:.2f} ms "
          f"with npz and PNGs, {summary['loop_seconds']:.2f} s its frame "
          f"loop, {test_s:.1f} s the chained command; {saves} (the last "
          "save's size); visualization "
          + ", ".join(f"{run.vis_seconds.get(e, 0.0):.2f} s epoch {e}"
                      for e in sorted(walls))
          + "; share of epoch wall outside the train steps "
          + ", ".join(f"{outside[e]:.3f} epoch {e} ({walls[e]:.2f} s)"
                      for e in sorted(walls))
          + f"; sf_1_2 vs plain {worst_sf:.3e}; resumed epoch 3 median step "
          f"{statistics.median(1e3 * r['seconds'] for r in hist3):.2f} ms",
          flush=True)
    shutil.rmtree(logdir)
    return counts, variants, run


def gap_batch(dataset, gap: int, dev):
    """The first training pair of ``dataset`` at ``gap``, on ``dev``."""
    from dynamic_video_depth_tpu_torch.data.batches import (collate_batches,
                                                            to_device)

    idx = next(i for i in range(len(dataset)) if dataset.gap_of(i) == gap)
    return to_device(collate_batches([dataset[idx]]), dev)


def step_wall_ms(step, batch, gap: int) -> float:
    """One main train step's wall time in ms, host clock to the fetch of
    its losses (the epoch loop's synchronisation)."""
    import torch

    t0 = time.perf_counter()
    logs = step.train_step(batch, steps=gap, warm=False)
    torch.stack(list(logs.values())).tolist()
    return 1e3 * (time.perf_counter() - t0)


def top_kernels(fn, n: int = 5):
    """``torch.profiler`` over one call of ``fn``: (device ms of its CUDA
    kernels in all, the ``n`` kernels with the most device time as "name ms
    xcount", the device ms of the FFT convolution path: kernels named for
    an FFT or a complex-float GEMM, ``cf32``). User annotations (the
    optimizers' ranges) are not kernels and are left out."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)
                   and "#" not in e.key), reverse=True)
    if not rows:
        fail("the profiler recorded no device time for a train step")
    total = sum(r[0] for r in rows)
    fft = sum(r[0] for r in rows
              if "fft" in r[2].lower() or "cf32" in r[2].lower())
    top = [f"{kernel_name(name)[:64]} {ms:.2f} ms x{count}"
           for ms, count, name in rows[:n]]
    return total, top, fft


def check_test_entry_depth(label: str, run, dev, summary_path: str,
                           npz_dir: str) -> dict:
    """``best.pt`` of ``run`` in a fresh step (the compute dtype its
    ``opt.json`` names) gives every frame's npz depth of the test entry bit
    for bit; returns the test entry's summary."""
    from argparse import Namespace

    import numpy as np

    from dynamic_video_depth_tpu_torch.data.batches import to_device
    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        load_checkpoint, load_opt)
    from dynamic_video_depth_tpu_torch.train.scene_flow_motion_field import (
        Model)

    with open(summary_path) as f:
        summary = json.load(f)
    frames = len(run.trainer.dataset_vali)
    if summary["frames"] != frames:
        fail(f"{label}: the test entry ran {summary['frames']} frames of "
             f"{frames}")
    model = Model(Namespace(**load_opt(run.logdir)), device=dev,
                  pretrained=False)
    if model.step.compute_dtype != run.model.step.compute_dtype:
        fail(f"{label}: opt.json gives another compute dtype")
    load_checkpoint(os.path.join(run.logdir, "best.pt"), model.step)
    for i in range(frames):
        pred = model.step.predict(to_device(run.trainer.dataset_vali[i], dev))
        dump = np.load(os.path.join(npz_dir, f"batch{i:04d}.npz"))
        if not np.array_equal(pred["depth"].cpu().numpy(), dump["depth"]):
            fail(f"{label}: frame {i}: depth of best.pt in a fresh step "
                 "differs from the test entry's npz")
    return summary


def phase_bf16(dev, workdir: str, card: str, f32_run):
    """The canonical recipe with ``--mixed_precision_training`` on phase
    3's track: MiDaS in bfloat16 at full width (the fixture's biased output
    conv), a warm-up and a main epoch, then the chained test entry. Checks
    what phase 3 checks of the steps, that the test entry's npz depth is a
    fresh bfloat16 ``predict`` of ``best.pt`` bit for bit, and, in one more
    main step, that every convolution of the depth net took bfloat16 input
    and that the depth reached the geometry as float32. Times main steps at
    gap 2 in bfloat16 and in float32 (phase 3's trained step) in turns and
    profiles one of each. Returns the launch counts and variants."""
    import torch
    from torch import nn

    from dynamic_video_depth_tpu_torch.train.cli import build_run

    track, gaps = "smoke_recipe", (1, 2, 4)  # phase 3's track
    n_pairs = track_pairs(workdir, track)
    argv = recipe_flags(track) + [
        "--epoch_batches", str(n_pairs), "--vali_batches", "2",
        "--batch_size", "1", "--device", str(dev), "--epoch", "2",
        "--warm_sf", "1", "--data_root", workdir, "--track_id", track,
        "--gaps", ",".join(map(str, gaps)),
        "--logdir", os.path.join(workdir, "checkpoints_bf16"),
        "--test_template", os.path.join(HERE, TEST_TEMPLATE),
        "--manual_seed", "0", "--mixed_precision_training"]
    run = build_run(argv)
    step = run.model.step
    if step.compute_dtype != torch.bfloat16:
        fail(f"bf16: --mixed_precision_training gave {step.compute_dtype}")
    counts, variants, _ = phase_trainer(dev, "midas_bf16", run.trainer,
                                        gaps, MIDAS_KERNELS, midas=True)
    run.chain_test()
    summary = check_test_entry_depth(
        "bf16", run, dev,
        os.path.join(run.logdir, "test", "epochbest_test.json"),
        os.path.join(run.logdir, "test", "epochbest_test"))

    # one more main step at gap 2: the convolutions' input dtypes and the
    # depth's dtype where the geometry reads it, under the profiler
    batch = gap_batch(run.trainer.dataset_train, 2, dev)
    seen = {"conv": set(), "depth": set()}
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen["conv"].add(args[0].dtype))
        for m in step.net_depth.modules() if isinstance(m, nn.Conv2d)]
    apply_depth = step._apply_depth

    def recorded(img):
        depth = apply_depth(img)
        seen["depth"].add(depth.dtype)
        return depth

    step._apply_depth = recorded
    bf16_dev, bf16_top, bf16_fft = top_kernels(
        lambda: step.train_step(batch, steps=2, warm=False))
    del step._apply_depth
    for h in hooks:
        h.remove()
    if seen["conv"] != {torch.bfloat16}:
        fail(f"bf16: the depth net's convolutions took {seen['conv']}")
    if seen["depth"] != {torch.float32}:
        fail(f"bf16: the depth reached the geometry as {seen['depth']}")
    f32_step = f32_run.model.step
    f32_batch = gap_batch(f32_run.trainer.dataset_train, 2, dev)
    f32_dev, f32_top, f32_fft = top_kernels(
        lambda: f32_step.train_step(f32_batch, steps=2, warm=False))
    walls = {"bf16": [], "f32": []}
    for _ in range(6):  # in turns: float32, bfloat16
        walls["f32"].append(step_wall_ms(f32_step, f32_batch, 2))
        walls["bf16"].append(step_wall_ms(step, batch, 2))
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"[bf16] {card}: MiDaS {H}x{W} main step at gap 2, median of 6 "
          f"in turns: bf16 {med['bf16']:.2f} ms, f32 {med['f32']:.2f} ms "
          f"(x{med['f32'] / med['bf16']:.2f}); one profiled step: bf16 "
          f"{bf16_dev:.2f} ms of kernel time, FFT path {bf16_fft:.2f} ms, "
          f"top 5: {'; '.join(bf16_top)} | f32 {f32_dev:.2f} ms, FFT path "
          f"{f32_fft:.2f} ms, top 5: {'; '.join(f32_top)}; test entry bf16 "
          f"median {summary['median_predict_ms']:.2f} ms a frame predict "
          f"only, {summary['median_frame_ms']:.2f} ms with npz and PNGs; "
          f"convolution inputs {sorted(map(str, seen['conv']))}, depth into "
          f"the geometry {sorted(map(str, seen['depth']))}", flush=True)
    shutil.rmtree(run.logdir)
    return counts, variants


def phase_variants(dev, workdir: str, card: str):
    """``experiments/shutterstock/train_sequence.sh``'s flags with
    ``VARIANT_FLAGS`` on a synthetic ShutterStock track picked by
    ``--track_id 0``: MiDaS at full width (float32, recomputed in the
    backward) and the CNN scene-flow field, SGD, gradient statistics; a
    warm-up and a main epoch, then the chained test command of
    ``experiments/shutterstock/test_cmd.txt`` (run from ``workdir``: its
    output directory is relative). Checks that kernels A and D launched and
    B and C did not, the SGD momentum buffers of ``checkpoint.pt`` and
    their bit-equal restore by ``--resume -1``, the grad-stat columns of
    ``epoch_loss.csv`` (depth terms 0 in warm-up, above 0 after) and the
    test entry's npz depth against ``best.pt``. Returns the launch counts
    and variants."""
    import csv

    from dynamic_video_depth_tpu_torch.data.synthetic import make_track
    from dynamic_video_depth_tpu_torch.models import FCNUnet
    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        read_checkpoint)
    from dynamic_video_depth_tpu_torch.train.cli import build_run

    root = os.path.join(workdir, "shutterstock")
    gaps = (1, 2)
    # 5 frames: 3 gap-1 and 2 gap-2 pairs per epoch
    make_track(root, track="smoke_ss", n_frames=5, h=H, w=W, gaps=gaps)
    n_pairs = track_pairs(root, "smoke_ss")
    common = ["--epoch_batches", str(n_pairs), "--vali_batches", "2",
              "--batch_size", "1", "--device", str(dev)]
    argv = recipe_flags("0", SS_RECIPE) + common + VARIANT_FLAGS + [
        "--epoch", "2", "--warm_sf", "1", "--data_root", root,
        "--gaps", ",".join(map(str, gaps)),
        "--logdir", os.path.join(workdir, "checkpoints_ss"),
        "--test_template", os.path.join(HERE, SS_TEST_TEMPLATE),
        "--manual_seed", "0"]
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        run = build_run(argv)
        step = run.model.step
        if run.opt.track_id != "smoke_ss" or type(step.net_sf) is not \
                FCNUnet or step.chain_fused or not step.loss_fused:
            fail(f"variants: track {run.opt.track_id}, field "
                 f"{type(step.net_sf).__name__}, chain {step.chain_fused}, "
                 f"fused loss {step.loss_fused}")
        counts, variants, _ = phase_trainer(dev, "variants", run.trainer,
                                            gaps, VARIANT_KERNELS,
                                            midas=True)
        launched = [k for k in ("mlp_fwd", "mlp_bwd", "chain_bwd")
                    if counts[k]]
        if launched:
            fail(f"variants: the CNN path launched {launched}: {counts}")
        run.chain_test()
        out = os.path.join(workdir, "test_results", "shutterstock",
                           "track_smoke_ss")
        summary = check_test_entry_depth(
            "variants", run, dev, os.path.join(out, "epochbest_test.json"),
            os.path.join(out, "epochbest_test"))
        if summary["launches"]["mlp_fwd"]:
            fail("variants: the test entry launched kernel B")
    finally:
        os.chdir(cwd)

    with open(os.path.join(run.logdir, "epoch_loss.csv")) as f:
        rows = list(csv.DictReader(f))
    stats = [[float(r[k]) for k in GRAD_STATS] for r in rows]
    if len(rows) != 2 or not all(map(math.isfinite, sum(stats, []))):
        fail(f"variants: epoch_loss.csv grad stats {stats}")
    depth = {int(r["epoch"]): (float(r["grad_norm_depth"]),
                               float(r["grad_max_depth"])) for r in rows}
    if depth[1] != (0.0, 0.0) or not min(depth[2]) > 0.0:
        fail(f"variants: depth grad stats {depth}, want 0 in warm-up and "
             "above 0 after")
    ckpt = read_checkpoint(os.path.join(run.logdir, "checkpoint.pt"))
    for sd in ckpt["optimizers"]:
        if not sd["state"] or not all("momentum_buffer" in v
                                      for v in sd["state"].values()):
            fail("variants: checkpoint.pt lacks SGD momentum buffers")
    resumed = build_run(["--full_logdir", run.logdir, "--resume", "-1",
                         "--epoch", "3"] + common)
    rstep = resumed.model.step
    if resumed.start_epoch != 3 or not state_equal(
            [o.state_dict() for o in rstep.optimizers],
            ckpt["optimizers"]) or not state_equal(
            [rstep.net_depth.state_dict(), rstep.net_sf.state_dict()],
            ckpt["nets"]):
        fail("variants: --resume -1 did not restore checkpoint.pt (SGD "
             "momentum buffers included) bit for bit")
    hist = run.trainer.history
    main = [1e3 * r["seconds"] for r in hist if not r["warm"]][1:]
    warm = [1e3 * r["seconds"] for r in hist if r["warm"]][1:]
    print(f"[variants] {card}: MiDaS {H}x{W} f32 with --remat_depth, "
          f"FCNUnet field, SGD, --log_grad_stats; median step "
          f"{statistics.median(main):.2f} ms main, "
          f"{statistics.median(warm):.2f} ms warm-up (first step of each "
          f"phase excluded); grad stats epoch 2 "
          + ", ".join(f"{k} {v:.4g}" for k, v in zip(GRAD_STATS, stats[1]))
          + f"; test entry median {summary['median_predict_ms']:.2f} ms a "
          f"frame predict only; launches {counts}", flush=True)
    shutil.rmtree(run.logdir)
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


# phase 10: the fleet (train/fleet.py, parallel/)
FLEET_TRACK, FLEET_GAPS = "smoke_recipe", (1, 2, 4)  # phase 3's track
FLEET_TIMED = 4  # main steps timed after the checked ones
# the card tests' step tolerance (losses), and each net's parameters: at
# least FLEET_SHARE of them within (atol, rtol) of the reference (the warp's
# backward adds in atomic order, cuDNN picks its algorithms by batch, and
# Adam turns a gradient near 0 into a step of either sign). The depth net
# moves once, by Adam's first update of +-lr whatever the gradient's size,
# so its atol is a tenth of lr (a flipped sign is 2 lr) and its rtol a few
# float32 units; the field's is the CPU tests' rtol 1e-4 / atol 1e-6 (lr x
# scene_lr_mul is 1e-3). A control without the gradients' all-reduce must
# fall below FLEET_SHARE on each net.
FLEET_LOSS_RTOL, FLEET_SHARE = 1e-4, 0.99
FLEET_DEPTH_TOL = (0.1, 1e-6)  # (atol in units of lr, rtol)
FLEET_SF_TOL = (1e-6, 1e-4)  # (atol, rtol)
# kernels A-D: B's backward runs only at gap 1 in warm-up on this path
FLEET_KERNELS = ("warp_fwd", "warp_bwd", "mlp_fwd", "chain_bwd", "loss_fwd",
                 "loss_bwd")


def fleet_flags(dev, workdir: str, logdir: str, tracks: str, *extra) -> list:
    """The recipe's flags for the fleet entry on ``dev``'s kind of device:
    a warm-up and a main epoch of three steps on ``tracks``, MiDaS at full
    width, the fused paths."""
    return recipe_flags(FLEET_TRACK) + [
        "--tracks", tracks, "--epoch", "2", "--warm_sf", "1",
        "--epoch_batches", "3", "--vali_batches", "2", "--batch_size", "1",
        "--device", dev.type, "--data_root", workdir,
        "--gaps", ",".join(map(str, FLEET_GAPS)), "--logdir", logdir,
        "--manual_seed", "0"] + list(extra)


def midas_recipe_model(dev, workdir: str):
    """A MiDaS model of the recipe's configuration on ``dev`` from seed 0,
    its output conv biased (the fixture's range), and the train dataset."""
    from dynamic_video_depth_tpu_torch.data import get_dataset
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)
    from dynamic_video_depth_tpu_torch.train import cli
    from dynamic_video_depth_tpu_torch.train.scene_flow_motion_field import (
        Model)

    opt = cli.build_parser().parse_args(recipe_flags(FLEET_TRACK) + [
        "--data_root", workdir, "--gaps", ",".join(map(str, FLEET_GAPS)),
        "--device", str(dev)])
    model = Model(opt, device=dev, seed=0, pretrained=False)
    bias_midas_output(model.step.net_depth)
    return model.step, get_dataset(opt.dataset)(opt, "train")


def flat_params(step):
    import torch

    return torch.cat([p.detach().reshape(-1) for net in
                      (step.net_depth, step.net_sf)
                      for p in net.parameters()])


def net_params(step) -> list:
    """Both nets' parameters, detached copies on the CPU."""
    return [[p.detach().to("cpu", copy=True) for p in net.parameters()]
            for net in (step.net_depth, step.net_sf)]


def compare_steps(step, params, ref_params, logs, ref_logs) -> dict:
    """Losses and parameters (``net_params``) of a run against the one
    process's: the largest relative loss difference and, for the depth net
    and the field, the share of parameters within ``FLEET_DEPTH_TOL`` /
    ``FLEET_SF_TOL`` and the largest difference in optimizer steps (lr for
    the depth net, lr x scene_lr_mul for the field)."""
    loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                   for a, b in zip(logs, ref_logs) for k in b)
    share, in_steps = [], []
    cfg = step.cfg
    tols = ((FLEET_DEPTH_TOL[0] * cfg.lr, FLEET_DEPTH_TOL[1]), FLEET_SF_TOL)
    for ps, qs, lr, (atol, rtol) in zip(
            params, ref_params, (cfg.lr, cfg.lr * cfg.scene_lr_mul), tols):
        within, total, most = 0, 0, 0.0
        for p, q in zip(ps, qs):
            d = (p - q).abs()
            within += int((d <= atol + rtol * q.abs()).sum())
            total += d.numel()
            most = max(most, float(d.max()))
        share.append(within / total)
        in_steps.append(most / lr)
    return {"loss_err": loss_err, "share": share, "in_steps": in_steps}


def steps_agree(cmp: dict) -> bool:
    """``compare_steps``'s losses within ``FLEET_LOSS_RTOL`` and each net's
    share at least ``FLEET_SHARE``."""
    return (cmp["loss_err"] <= FLEET_LOSS_RTOL
            and min(cmp["share"]) >= FLEET_SHARE)


def show_cmp(cmp: dict) -> str:
    return (f"loss {cmp['loss_err']:.2e}, share within tolerance depth "
            f"{cmp['share'][0]:.6f} / field {cmp['share'][1]:.6f}, max "
            f"{cmp['in_steps'][0]:.2f} / {cmp['in_steps'][1]:.2f} optimizer "
            "steps")


def _gloo_rank(rank: int, device: str, rendezvous: str, workdir: str,
               out: str) -> None:
    """One of two gloo ranks sharing cuda:0 (phase 10b): ``DataParallelStep``
    at batch 2 (a pair a rank), a warm-up and a main step, each followed by
    a bit-for-bit comparison of the two ranks' parameters, then
    ``FLEET_TIMED`` timed main steps; the control: the same two steps from
    the same nets without the gradients' all-reduce; a two-video
    ``MultiVideoOptimizer`` (a pair a rank) against a single-video step on
    the same pair. Rank 0 saves its parameters after the checked steps to
    ``out/dp_params.pt`` and the control's to ``out/control_params.pt``.
    Writes its results to ``out/gloo_rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from dynamic_video_depth_tpu_torch.data.batches import (collate_batches,
                                                            to_device)
    from dynamic_video_depth_tpu_torch.ops import cuda as kernels
    from dynamic_video_depth_tpu_torch.parallel import (
        DataParallelStep, MultiVideoOptimizer, initialize_distributed)

    dev = torch.device(device)
    initialize_distributed("gloo", "file://" + rendezvous, 2, rank, dev)
    res = {"rank": rank}
    try:
        step, ds = midas_recipe_model(dev, workdir)
        pairs = [i for i in range(len(ds)) if ds.gap_of(i) == 2][:2]
        host = collate_batches([ds[i] for i in pairs])
        gap = host["steps"]
        kernels.reset_launches()

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, 1e3 * (time.perf_counter() - t0)

        def same_on_both(flat) -> bool:
            theirs = flat.clone()
            dist.broadcast(theirs, 0)
            ok = torch.tensor([float(torch.equal(flat, theirs))], device=dev)
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
            return bool(ok.item())

        dp = DataParallelStep(step, timed=True)
        dp.broadcast_state()
        batch = dp.place(host)
        logs, bit_equal = [], []
        for warm in (True, False):
            logs.append({k: float(v) for k, v in
                         dp.train_step(batch, gap, warm).items()})
            bit_equal.append(same_on_both(flat_params(step)))
        if rank == 0:
            torch.save(net_params(step), os.path.join(out, "dp_params.pt"))
        dp.reductions.clear()
        step_ms = [timed(lambda: dp.train_step(batch, gap, False))[1]
                   for _ in range(FLEET_TIMED)]
        res.update(dp_logs=logs, bit_equal=bit_equal, dp_step_ms=step_ms,
                   reductions=dp.reductions, launches=kernels.launch_counts(),
                   variants=[[list(k), n] for k, n in
                             kernels.launch_variants().items()])

        # the control: each rank steps on its own pair's gradients
        del dp, step
        torch.cuda.empty_cache()
        control, _ = midas_recipe_model(dev, workdir)
        control._reduce_grads = lambda reduce: None
        cdp = DataParallelStep(control)
        cdp.broadcast_state()
        res["control_logs"] = [{k: float(v) for k, v in
                                cdp.train_step(batch, gap, warm).items()}
                               for warm in (True, False)]
        if rank == 0:
            torch.save(net_params(control),
                       os.path.join(out, "control_params.pt"))
        del cdp, control
        torch.cuda.empty_cache()

        # two videos, a pair each, against a single-video step on the pair
        mine = to_device(collate_batches([ds[pairs[rank]]]), dev)
        video, _ = midas_recipe_model(dev, workdir)
        mvo = MultiVideoOptimizer(video)
        mvo.broadcast_state(0)
        mvo_logs = [{k: float(v) for k, v in
                     mvo.train_step(mine, gap, warm).items()}
                    for warm in (True, False)]
        single, _ = midas_recipe_model(dev, workdir)
        single_logs = [{k: float(v) for k, v in
                        single.train_step(mine, gap, warm).items()}
                       for warm in (True, False)]
        res["mvo"] = compare_steps(video, net_params(video),
                                   net_params(single), mvo_logs, single_logs)
        del video, single, mvo
        torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"gloo_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_fleet_reference(dev, workdir: str):
    """Phase 10b's yardstick: the one-process step at batch 2 on the same
    card and pairs from the same nets, a warm-up and a main step, then
    ``FLEET_TIMED`` timed main steps. Returns the step, its logs, its
    parameters after the two steps (``net_params``) and the times."""
    import torch

    from dynamic_video_depth_tpu_torch.data.batches import (collate_batches,
                                                            to_device)

    step, ds = midas_recipe_model(dev, workdir)
    pairs = [i for i in range(len(ds)) if ds.gap_of(i) == 2][:2]
    host = collate_batches([ds[i] for i in pairs])
    batch, gap = to_device(host, dev), host["steps"]
    logs = [{k: float(v) for k, v in step.train_step(batch, gap, w).items()}
            for w in (True, False)]
    params = net_params(step)
    ms = []
    for _ in range(FLEET_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.train_step(batch, gap, False)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return step, logs, params, ms


def check_fleet_run(label: str, out: dict, checked: set, n_ranks: int,
                    backend: str) -> dict:
    """A fleet entry run's per-rank summaries: the backend, finite losses,
    a main loss above 0, kernels A-D launched on every rank and only at
    variants phase 2 checked. Returns the launches by rank."""
    ranks = out["ranks"]
    if len(ranks) != n_ranks or any(r["backend"] != backend for r in ranks):
        fail(f"{label}: ranks {[(r['rank'], r['backend']) for r in ranks]}"
             f", want {n_ranks} on {backend}")
    for r in ranks:
        recs = r["records"]
        if len(recs) != 6 or not all(
                math.isfinite(x[k]) for x in recs for k in
                ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss",
                 "acc_reg")):
            fail(f"{label}: rank {r['rank']}: {len(recs)} steps or a "
                 "non-finite loss")
        if not all(x["loss"] > 0 for x in recs if not x["warm"]):
            fail(f"{label}: rank {r['rank']}: a main loss is not above 0")
        missing = [k for k in FLEET_KERNELS if r["launches"][k] <= 0]
        if missing:
            fail(f"{label}: rank {r['rank']} did not launch {missing}")
        unchecked = {tuple(k) for k, _ in r["variants"]} - checked
        if unchecked:
            fail(f"{label}: rank {r['rank']} launched variants phase 2 did "
                 f"not check: {sorted(unchecked)}")
    return {r["rank"]: {k: r["launches"][k] for k in MIDAS_KERNELS}
            for r in ranks}


def phase_fleet(dev, workdir: str, card: str, checked: set) -> dict:
    """Phase 10, the fleet (``train/fleet.py``, ``parallel/``):
    (a) the fleet entry on phase 3's track at ``--dp 1`` on NCCL (a world
    of one): the recipe's flags cut to a warm-up and a main epoch of three
    steps, MiDaS at full width (every worker loads a biased seed-0 MiDaS
    through ``DVD_MIDAS_CKPT``), the per-track artifacts, kernels A-D, and
    ``--resume -1`` restoring ``checkpoint.pt`` bit for bit;
    (b) two gloo ranks sharing cuda:0 through ``parallel.multi_video``
    (``_gloo_rank``) against the one-process step at batch 2;
    (c) with two or more cards, (a) on two tracks at ``--dp 1`` and at
    ``--dp 2`` over NCCL. Prints ``[fleet]``; returns the launches by run
    and rank."""
    import torch

    from dynamic_video_depth_tpu_torch.data.synthetic import make_track
    from dynamic_video_depth_tpu_torch.models import MidasNet
    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        read_checkpoint)
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)
    from dynamic_video_depth_tpu_torch.train import fleet

    t_phase = time.perf_counter()
    midas = os.path.join(workdir, "midas_biased.pt")
    net = MidasNet(non_negative=True, normalize_input=True,
                   generator=torch.Generator().manual_seed(0))
    torch.save(bias_midas_output(net).state_dict(), midas)
    del net
    launches = {}
    old_env = os.environ.get("DVD_MIDAS_CKPT")
    os.environ["DVD_MIDAS_CKPT"] = midas
    try:
        # (a) NCCL, a world of one
        logdir = os.path.join(workdir, "fleet_a")
        out_a = fleet.main(fleet_flags(dev, workdir, logdir, FLEET_TRACK))
        backend = "nccl" if dev.type == "cuda" else "gloo"
        launches["nccl_dp1"] = check_fleet_run("fleet (a)", out_a, checked,
                                               1, backend)
        track_dir = os.path.join(logdir, FLEET_TRACK)
        want = [os.path.join(logdir, f) for f in
                ("epoch_loss.csv", "opt.json", "fleet_rank0.json")]
        want += [os.path.join(track_dir, f) for f in
                 ("vali_loss.csv", "checkpoint.pt", "best.pt")]
        missing = [f for f in want if not os.path.isfile(f)]
        if missing:
            fail(f"fleet (a): missing artifacts {missing}")
        before = read_checkpoint(os.path.join(track_dir, "checkpoint.pt"))
        fleet.main(fleet_flags(dev, workdir, logdir, FLEET_TRACK,
                               "--resume", "-1", "--vali_at_start"))
        after = read_checkpoint(os.path.join(track_dir, "checkpoint.pt"))
        if after["epoch"] != 2 or not state_equal(
                [before["nets"], before["optimizers"]],
                [after["nets"], after["optimizers"]]):
            fail("fleet (a): --resume -1 did not restore checkpoint.pt bit "
                 "for bit")
        del before, after
        a_ms = out_a["ranks"][0]["step_ms"]
        rank_a = out_a["ranks"][0]
        shutil.rmtree(logdir)

        # (c) NCCL across cards: two videos at dp 1, then dp 2 (two videos
        # with four cards, else one)
        n_cards = torch.cuda.device_count()
        c_line = (f"NCCL across cards not run: {n_cards} CUDA device "
                  f"({card})")
        if n_cards >= 2:
            make_track(workdir, track="smoke_fleet_b", n_frames=6, h=H, w=W,
                       gaps=FLEET_GAPS, seed=1)
            two = f"{FLEET_TRACK},smoke_fleet_b"
            parts = []
            for tracks, dp in ((two, 1),
                               (two if n_cards >= 4 else FLEET_TRACK, 2)):
                logdir = os.path.join(workdir, f"fleet_c{dp}")
                out_c = fleet.main(fleet_flags(dev, workdir, logdir, tracks,
                                               "--dp", str(dp),
                                               "--batch_size", str(dp)))
                n_videos = len(tracks.split(","))
                launches[f"nccl_{n_videos}x{dp}"] = check_fleet_run(
                    f"fleet (c) {n_videos} x dp {dp}", out_c, checked,
                    n_videos * dp, "nccl")
                largest = max([n for r in out_c["ranks"]
                                for n, _ in r["reductions"]], default=0)
                grads = [ms for r in out_c["ranks"]
                         for nbytes, ms in r["reductions"]
                         if nbytes == largest]
                steps = "/".join(
                    f"{statistics.median(r['step_ms'][4:]):.2f}"
                    for r in out_c["ranks"])
                parts.append(
                    f"{n_videos} videos x dp {dp}: median main step {steps} "
                    "ms by rank" + (f", gradient all-reduce median "
                                    f"{statistics.median(grads):.2f} ms"
                                    if grads else ""))
                shutil.rmtree(logdir)
            c_line = "NCCL across cards: " + "; ".join(parts)
    finally:
        if old_env is None:
            os.environ.pop("DVD_MIDAS_CKPT", None)
        else:
            os.environ["DVD_MIDAS_CKPT"] = old_env
    if n_cards < 2:
        print(f"[fleet] {c_line}", flush=True)

    # (b) two gloo ranks sharing cuda:0, and the one-process yardstick
    torch.cuda.empty_cache()
    out = os.path.join(workdir, "fleet_b")
    os.makedirs(out)
    torch.multiprocessing.spawn(
        _gloo_rank, args=(str(dev), os.path.join(out, "rendezvous"), workdir,
                          out),
        nprocs=2, join=True)
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"gloo_rank{r}.json")) as f:
            ranks.append(json.load(f))
    ref, ref_logs, ref_params, ref_ms = phase_fleet_reference(dev, workdir)
    dp = compare_steps(ref, torch.load(os.path.join(out, "dp_params.pt")),
                       ref_params, ranks[0]["dp_logs"], ref_logs)
    if not steps_agree(dp):
        fail(f"fleet (b): DataParallelStep vs the one-process step: "
             f"{show_cmp(dp)}")
    control = compare_steps(
        ref, torch.load(os.path.join(out, "control_params.pt")), ref_params,
        ranks[0]["control_logs"], ref_logs)
    if max(control["share"]) >= FLEET_SHARE:
        fail(f"fleet (b): the check does not tell a step without the "
             f"gradients' all-reduce from the one-process step: "
             f"{show_cmp(control)}")
    for r in ranks:
        if not all(r["bit_equal"]) or r["dp_logs"] != ranks[0]["dp_logs"]:
            fail(f"fleet (b): the ranks' parameters or logs differ after a "
                 f"step: {r['bit_equal']}")
        if not steps_agree(r["mvo"]):
            fail(f"fleet (b): rank {r['rank']}'s video vs a single-video "
                 f"step: {show_cmp(r['mvo'])}")
        missing = [k for k in FLEET_KERNELS if r["launches"][k] <= 0]
        unchecked = {tuple(k) for k, _ in r["variants"]} - checked
        if missing or unchecked:
            fail(f"fleet (b): rank {r['rank']}: kernels not launched "
                 f"{missing}, unchecked variants {sorted(unchecked)}")
    launches["gloo_dp2"] = {r["rank"]: {k: r["launches"][k]
                                        for k in MIDAS_KERNELS}
                            for r in ranks}
    # the gradients' all-reduce is a step's largest reduction
    largest = max(nbytes for r in ranks for nbytes, _ in r["reductions"])
    grads = [(nbytes, ms) for r in ranks for nbytes, ms in r["reductions"]
             if nbytes == largest]
    if len(grads) != 2 * FLEET_TIMED:
        fail(f"fleet (b): {len(grads)} gradient all-reduces over "
             f"{FLEET_TIMED} timed steps on two ranks")
    del ref
    shutil.rmtree(out)
    torch.cuda.empty_cache()
    dp_steps = "/".join(f"{statistics.median(r['dp_step_ms']):.2f}"
                        for r in ranks)
    mvo = "; ".join(show_cmp(r["mvo"]) for r in ranks)
    print(f"[fleet] {card}: (a) fleet entry, NCCL, 1 video x dp 1, MiDaS "
          f"{H}x{W}: median step {statistics.median(a_ms[1:3]):.2f} ms "
          f"warm-up, {statistics.median(a_ms[4:]):.2f} ms main (each "
          f"phase's first step excluded), launches {launches['nccl_dp1']}; "
          f"(b) gloo, 2 ranks sharing cuda:0, DataParallelStep at batch 2 "
          f"(a pair a rank): median main step {dp_steps} ms by rank, "
          f"gradient all-reduce (gloo through the host, no measure of "
          f"NCCL) median {statistics.median(ms for _, ms in grads):.2f} ms "
          f"of {grads[0][0]} bytes a step, beside the one-process step at "
          f"batch 2 {statistics.median(ref_ms):.2f} ms; DP vs one process: "
          f"{show_cmp(dp)}; the control without the gradients' all-reduce "
          f"vs one process: {show_cmp(control)}; two-video "
          f"MultiVideoOptimizer vs single-video steps by rank: {mvo}; "
          f"launches {launches['gloo_dp2']};"
          f" {c_line}; phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, rank_a


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


# phase 11: the input pipeline (data/prefetch.py, the loop's log
# pipeline), the profiler and ShutterStock preprocessing
PIPE_TRACK, PIPE_GAPS = "smoke_recipe", (1, 2, 4)  # phase 3's track
# a warm-up epoch, the traced epoch 2 (--profile_dir), two untraced main
# epochs whose steps are timed
PIPE_EPOCHS, PIPE_TIMED = 4, (3, 4)
# two runs at one seed part once the depth net trains: the warp's backward
# adds in atomic order and cuDNN's weight gradients may, and training
# amplifies the last-bit differences (float32 recipe, 24 main steps: up to
# 1.5e-2 relative on the card). So the streaming run of (a) starts each
# main step from the cached run's depth-net parameters before that step;
# its losses are then held to the cached run's at PIPE_RTOL.
PIPE_RTOL = 1e-5
LOSS_KEYS = ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss", "acc_reg")
# the kernels A-D by the names of their CUDA functions in a trace
TRACE_KERNELS = {"A": ("warp_fwd", "warp_bwd"), "B": ("mlp_fwd",),
                 "C": ("chain_bwd",), "D": ("loss_fwd", "loss_bwd")}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SS_FRAMES, SS_HW, SS_GAPS = 8, (432, 768), (1, 2)
# stage 1 on the card against the CPU: MiDaS's depth (cuDNN against the
# CPU's convolutions) and what follows from its scale, relative to each
# array's largest value, as phase 7 holds the card's losses to the CPU's
SS_RTOL = 1e-4


def pipeline_run(dev, workdir: str, cached: bool, bf16: bool,
                 profile_dir: str = None, depth_out: list = None,
                 depth_in: list = None):
    """The recipe on phase 3's track through the train entry, MiDaS at
    full width (the fixture's biased output conv): ``PIPE_EPOCHS`` epochs
    of every pair once, the first a warm-up; no visualization, no per-epoch
    nets, ``checkpoint.pt`` at the last epoch. Before each main step the
    depth net's parameters are appended to ``depth_out`` (device copies)
    or set from the next entry of ``depth_in``. Returns the trainer, the
    (frame_id_1, frame_id_2) each step took, and the run's launch counts
    and variants (counts set to 0 just before training)."""
    import torch

    from dynamic_video_depth_tpu_torch.ops import cuda as kernels_mod
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)
    from dynamic_video_depth_tpu_torch.train.cli import build_run

    tag = ("cached" if cached else "streaming") + ("_bf16" if bf16 else "")
    argv = recipe_flags(PIPE_TRACK) + [
        "--epoch_batches", str(track_pairs(workdir, PIPE_TRACK)),
        "--vali_batches", "2", "--batch_size", "1", "--device", str(dev),
        "--epoch", str(PIPE_EPOCHS), "--warm_sf", "1", "--data_root", workdir,
        "--track_id", PIPE_TRACK, "--gaps", ",".join(map(str, PIPE_GAPS)),
        "--logdir", os.path.join(workdir, "pipeline_" + tag),
        "--manual_seed", "0", "--save_net", "0",
        "--save_every", str(PIPE_EPOCHS), "--vis_every_train", "0",
        "--vis_every_vali", "0"]
    if bf16:
        argv.append("--mixed_precision_training")
    if not cached:
        argv.append("--no_device_cache")
    if profile_dir:
        argv += ["--profile_dir", profile_dir]
    run = build_run(argv)
    step = run.model.step
    bias_midas_output(step.net_depth)
    seen = []
    train_step = step.train_step
    states = iter(depth_in) if depth_in is not None else None

    def recording(batch, steps, warm):
        seen.append(torch.stack([batch["frame_id_1"], batch["frame_id_2"]]))
        if not warm:
            params = list(step.net_depth.parameters())
            if depth_out is not None:
                depth_out.append([p.detach().clone() for p in params])
            if states is not None:
                with torch.no_grad():
                    for p, q in zip(params, next(states)):
                        p.copy_(q)
        return train_step(batch, steps, warm)

    step.train_step = recording
    kernels_mod.reset_launches()
    run.trainer.train()
    torch.cuda.synchronize()
    counts = kernels_mod.launch_counts()
    variants = kernels_mod.launch_variants()
    del step.train_step
    pairs = [tuple(t.reshape(-1).tolist()) for t in seen]
    shutil.rmtree(run.logdir)
    return run.trainer, pairs, counts, variants


def losses_agree(a: list, b: list) -> tuple:
    """Two runs' per-step logs: (every loss within ``PIPE_RTOL``, the
    largest relative difference, the steps bit-equal)."""
    worst, equal = 0.0, 0
    for x, y in zip(a, b):
        diffs = [abs(x[k] - y[k]) / abs(y[k]) if y[k] else
                 float(x[k] != y[k]) for k in LOSS_KEYS]
        worst = max(worst, *diffs)
        equal += all(x[k] == y[k] for k in LOSS_KEYS)
    return len(a) == len(b) and worst <= PIPE_RTOL, worst, equal


def check_cache(label: str, cache, dev) -> int:
    """Every kept batch of a ``DeviceCache`` equals a fresh ``to_device``
    of its source bit for bit, and its bytes are the sum of its batches'
    sizes. Returns its bytes."""
    from dynamic_video_depth_tpu_torch.data.batches import to_device

    total = 0
    for idx in list(cache.keys()):
        kept = cache.get(idx)[0]
        if not state_equal(kept, to_device(cache.dataset[idx], dev)):
            fail(f"pipeline (a): {label}: cached batch {idx} differs from "
                 "a fresh copy of its file")
        total += sum(t.numel() * t.element_size() for t in kept.values())
    if not cache.keys() or cache.nbytes != total:
        fail(f"pipeline (a): {label}: {cache.nbytes} bytes kept, the "
             f"batches hold {total}")
    return total


def trace_reading(path: str, steps: int) -> dict:
    """A ``--profile_dir`` trace: the kernels A-D found by name, the step
    spans, and the device's idle share of the traced epoch (the window from
    the first data wait to the last device activity; busy is the union of
    kernels, copies and memsets)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = collections.Counter(e.get("name") for e in events
                                if e.get("cat") == "user_annotation")
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                    for e in events if e.get("cat") in DEVICE_CATS)
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    found = {k: all(any(n in name for name in names) for n in v)
             for k, v in TRACE_KERNELS.items()}
    if spans["dvd/step"] != steps or spans["dvd/data_wait"] != steps or \
            not all(found.values()) or not device:
        fail(f"pipeline (c): the trace holds step spans {spans['dvd/step']}"
             f", data waits {spans['dvd/data_wait']} (want {steps}), "
             f"kernels {found}, {len(device)} device events")
    start = min(float(e["ts"]) for e in events
                if e.get("name") == "dvd/data_wait")
    end = max(b for _, b in device)
    busy, cur_a, cur_b = 0.0, None, None
    for a, b in device:
        a = max(a, start)
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    window = end - start
    return {"idle": 1.0 - busy / window, "window_ms": window / 1e3,
            "busy_ms": busy / 1e3, "kernels": len(device),
            "bytes": os.path.getsize(path), "found": found}


def step_stats(trainer) -> dict:
    """Medians over the untraced main epochs: the step at gap 2 (its span
    on the device clock and the interval between step ends), every main
    step, and the host's wait for data."""
    hist = [r for r in trainer.history if r["epoch"] in PIPE_TIMED]
    gap2 = [r for r in hist if r["gap"] == 2]
    return {"gap2_ms": statistics.median(1e3 * r["seconds"] for r in gap2),
            "gap2_interval_ms": statistics.median(1e3 * r["interval"]
                                                  for r in gap2),
            "main_ms": statistics.median(1e3 * r["seconds"] for r in hist),
            "data_ms": statistics.median(1e3 * r["data_time"]
                                         for r in hist),
            "n_gap2": len(gap2)}


def host_batch_ms(dataset, dev) -> tuple:
    """Median host ms of one ``dataset[i]`` + collate + copy to the card,
    synchronised: from pageable numpy (``to_device``), and through pinned
    tensors (``host_tensors(pin=True)``, the reader thread's half)."""
    import torch

    from dynamic_video_depth_tpu_torch.data.batches import (collate_batches,
                                                            host_tensors,
                                                            to_device)

    walls = {"pageable": [], "pinned": []}
    for _ in range(2):
        for i in range(len(dataset)):
            for kind in walls:
                torch.cuda.synchronize()
                t = time.perf_counter()
                host = collate_batches([dataset[i]])
                if kind == "pinned":
                    host = host_tensors(host, pin=True)
                to_device(host, dev)
                torch.cuda.synchronize()
                walls[kind].append(1e3 * (time.perf_counter() - t))
    return (statistics.median(walls["pageable"]),
            statistics.median(walls["pinned"]))


def shutterstock_raw(n: int, h: int, w: int):
    """ShutterStock stage-1 inputs in memory: ``make_raw_davis``'s frames
    and camera path, an MVS depth per frame (a slanted plane 2-6 m away,
    invalid (0) in its top quarter), ``T_1_G`` and ``K``."""
    import numpy as np

    from dynamic_video_depth_tpu_torch.data.synthetic import make_raw_davis

    imgs, matrices, K, _, _ = make_raw_davis(n, h, w, seed=2)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    mvs = []
    for i in range(n):
        d = (2.0 + 3.0 * yy + 1.0 * xx + 0.05 * i).astype(np.float32)
        d[: h // 4] = 0.0
        mvs.append(d)
    t_1_g = np.stack([np.linalg.inv(m) for m in matrices])
    return imgs, mvs, t_1_g, np.repeat(K[None].astype(np.float32), n, 0)


def phase_shutterstock(dev, workdir: str) -> tuple:
    """Phase 11 (e): stage 1 of ``preprocess/run_shutterstock.py`` with
    MiDaS on the card and on the CPU (the same arrays, seed-0 weights with
    the fixture's biased output conv), stages 2-3 on the card, the pairs
    through ``--dataset shutterstock``. Returns the line's text and the
    launch variants of stages 1-3."""
    import numpy as np

    from dynamic_video_depth_tpu_torch.data import get_dataset
    from dynamic_video_depth_tpu_torch.ops import cuda as kernels_mod
    from dynamic_video_depth_tpu_torch.preprocess import (flows, frames,
                                                          pairs,
                                                          run_shutterstock)
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)

    root, track = os.path.join(workdir, "shutterstock_pre"), "0001"
    frame_dir = os.path.join(root, "frames_midas", track)
    flow_dir = os.path.join(root, "flow_pairs", track)
    seq_dir = os.path.join(root, "sequences_select_pairs_midas", track, "001")
    cpu_dir = os.path.join(workdir, "shutterstock_cpu")
    imgs, mvs, t_1_g, K = shutterstock_raw(SS_FRAMES, *SS_HW)
    wh = run_shutterstock.get_im_size(*SS_HW)
    if wh != (H, W):
        fail(f"pipeline (e): get_im_size{SS_HW} = {wh}, want {(H, W)}")

    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    midas_hw = run_shutterstock.midas_input_size(*SS_HW)
    depth_fn = frames.make_midas_depth_fn(resize=midas_hw, device=dev)
    bias_midas_output(depth_fn.net)
    scale = run_shutterstock.process_shutterstock_track(
        imgs, mvs, t_1_g, K, frame_dir, depth_fn)
    t1 = time.perf_counter()
    flows.process_track(frame_dir, flow_dir, gaps=SS_GAPS, device=dev)
    t2 = time.perf_counter()
    pairs.pack_track(frame_dir, flow_dir, seq_dir, gaps=SS_GAPS)
    t3 = time.perf_counter()
    counts = kernels_mod.launch_counts()
    variants = kernels_mod.launch_variants()
    n_flows = sum(SS_FRAMES - g for g in SS_GAPS)
    if counts["corr_lookup"] != flows.RAFT_ITERS * n_flows:
        fail(f"pipeline (e): {counts['corr_lookup']} lookups for {n_flows} "
             f"RAFT calls of {flows.RAFT_ITERS} iterations")
    others = {k: v for k, v in counts.items()
              if v and k not in PREPROCESS_KERNELS}
    if others:
        fail(f"pipeline (e): launched kernels of another path: {others}")
    del depth_fn

    # stage 1 on the CPU from the same arrays and weights
    cpu_fn = frames.make_midas_depth_fn(resize=midas_hw, device="cpu")
    bias_midas_output(cpu_fn.net)
    t4 = time.perf_counter()
    cpu_scale = run_shutterstock.process_shutterstock_track(
        imgs, mvs, t_1_g, K, cpu_dir, cpu_fn)
    t5 = time.perf_counter()
    del cpu_fn
    worst = {}
    for i in range(SS_FRAMES):
        name = f"frame_{i:05d}.npz"
        with np.load(os.path.join(frame_dir, name)) as a, \
                np.load(os.path.join(cpu_dir, name)) as b:
            if sorted(a.files) != sorted(b.files):
                fail(f"pipeline (e): {name} keys {a.files} vs {b.files}")
            for k in a.files:
                x, y = a[k], b[k]
                if x.shape != y.shape or x.dtype != y.dtype or \
                        not np.isfinite(x).all():
                    fail(f"pipeline (e): {name}:{k} {x.shape} {x.dtype}")
                err = float(np.abs(x - y).max() / max(np.abs(y).max(),
                                                       1e-30))
                worst[k] = max(worst.get(k, 0.0), err)
            if a["img"].shape != (H, W, 3):
                fail(f"pipeline (e): {name} img {a['img'].shape}")
    if max(worst.values()) > SS_RTOL or \
            abs(scale - cpu_scale) > SS_RTOL * abs(cpu_scale):
        fail(f"pipeline (e): stage 1 on the card vs the CPU: scale {scale} "
             f"vs {cpu_scale}, worst relative difference by key {worst}")

    opt = argparse.Namespace(track_id="0", gaps=",".join(map(str, SS_GAPS)),
                             subsample=False, data_root=root)
    ds = get_dataset("shutterstock")(opt, "train")
    want = sum(SS_FRAMES - 1 - g for g in SS_GAPS)
    if opt.track_id != track or len(ds) != want:
        fail(f"pipeline (e): --dataset shutterstock read track "
             f"{opt.track_id} with {len(ds)} pairs, want {track} with {want}")
    for i in range(len(ds)):
        b = ds[i]
        if b["img_1"].shape != (1, H, W, 3) or \
                not np.isfinite(b["flow_1_2"]).all():
            fail(f"pipeline (e): packed pair {i} does not load as a batch")
    if "h5py" in sys.modules:
        fail("pipeline (e): h5py was imported")
    text = (f"(e) ShutterStock {SS_FRAMES} frames {SS_HW[0]}x{SS_HW[1]} -> "
            f"{wh[0]}x{wh[1]} (MiDaS at {midas_hw}): stage 1 "
            f"{1e3 * (t1 - t0) / SS_FRAMES:.2f} ms/frame on the card (the "
            f"MiDaS build included), "
            f"{1e3 * (t5 - t4) / SS_FRAMES:.2f} on the CPU, scale "
            f"{scale:.6f} / {cpu_scale:.6f}, card vs CPU worst relative "
            "difference " + ", ".join(f"{k} {v:.2e}" for k, v in
                                      sorted(worst.items()))
            + f" (tol {SS_RTOL}); stage 2 {1e3 * (t2 - t1) / n_flows:.2f} "
            f"ms/pair over {n_flows} RAFT calls, lookup launches "
            f"{counts['corr_lookup']} ({counts['corr_lookup'] // n_flows} a "
            f"call); stage 3 {1e3 * (t3 - t2):.2f} ms; {len(ds)} pairs "
            f"through --dataset shutterstock")
    shutil.rmtree(root)
    shutil.rmtree(cpu_dir)
    return text, variants


def phase_pipeline(dev, workdir: str, card: str, checked: set,
                   fleet_a: dict) -> dict:
    """Phase 11, the input pipeline, the profiler and ShutterStock
    preprocessing, on phase 3's track at full width:
    (a) the float32 recipe cached and with ``--no_device_cache`` at one
    seed, the streaming run starting each main step from the cached run's
    depth-net parameters: the losses within ``PIPE_RTOL`` step by step,
    the same pairs, every cached batch a fresh copy of its file bit for
    bit after training, the cache's bytes its batches' sizes;
    (b) the bf16 recipe streaming and cached (the cached run traced): the
    median main step at gap 2 and data wait of each of the four runs, the
    host time of one batch's read, collate and copy, the cache's bytes;
    (c) the traced epoch 2 of the cached bf16 run (``--profile_dir``):
    kernels A-D by name, the step spans, the device's idle share;
    (d) the fleet entry at ``--dp 1`` streaming against phase 10 (a)'s
    cached run: the losses within ``PIPE_RTOL`` on the steps both runs
    start from the same state (the warm-up epoch and the first main step;
    the later ones are printed);
    (e) ShutterStock preprocessing (``phase_shutterstock``).
    Prints ``[pipeline]``; returns the launch variants of its paths."""
    import torch

    from dynamic_video_depth_tpu_torch.data.prefetch import DeviceCache
    from dynamic_video_depth_tpu_torch.train import fleet

    t_phase = time.perf_counter()
    n_pairs = track_pairs(workdir, PIPE_TRACK)
    variants = collections.Counter()
    stats, hists, pairs_seen = {}, {}, {}
    cache_bytes = 0
    trace_dir = os.path.join(workdir, "pipeline_trace")
    depth_states = []
    for name, cached, bf16 in (("f32_cached", True, False),
                               ("f32_streaming", False, False),
                               ("bf16_streaming", False, True),
                               ("bf16_cached", True, True)):
        trainer, pairs_seen[name], counts, run_variants = pipeline_run(
            dev, workdir, cached, bf16,
            trace_dir if name == "bf16_cached" else None,
            depth_out=depth_states if name == "f32_cached" else None,
            depth_in=depth_states if name == "f32_streaming" else None)
        if name == "f32_streaming":
            depth_states.clear()
        variants.update(run_variants)
        if isinstance(trainer.train_source, DeviceCache) != cached:
            fail(f"pipeline: {name} read {type(trainer.train_source)}")
        if cached:
            missing = [k for k in MIDAS_KERNELS if counts[k] <= 0]
            if missing:
                fail(f"pipeline: the cached {name} path did not launch "
                     f"{missing} ({counts})")
        if name == "f32_cached":
            cache_bytes = check_cache(name, trainer.train_source, dev)
            check_cache(name + " vali", trainer.vali_source, dev)
        hists[name] = trainer.history
        stats[name] = step_stats(trainer)
        if not all(math.isfinite(r[k]) for r in trainer.history
                   for k in LOSS_KEYS):
            fail(f"pipeline: {name}: a non-finite loss")
        if name == "f32_streaming":
            host_ms = host_batch_ms(trainer.dataset_train, dev)
        del trainer
        torch.cuda.empty_cache()

    # (a) the cache changes nothing
    ok, worst, equal = losses_agree(hists["f32_cached"],
                                    hists["f32_streaming"])
    if not ok or pairs_seen["f32_cached"] != pairs_seen["f32_streaming"]:
        fail(f"pipeline (a): cached vs streaming float32: losses within "
             f"{worst:.3e} (tol {PIPE_RTOL}), pairs equal "
             f"{pairs_seen['f32_cached'] == pairs_seen['f32_streaming']}")
    _, bf_worst, bf_equal = losses_agree(hists["bf16_cached"],
                                         hists["bf16_streaming"])
    if pairs_seen["bf16_cached"] != pairs_seen["f32_cached"]:
        fail("pipeline: the bf16 runs visited other pairs")

    def show(name):
        s = stats[name]
        return (f"{name} gap 2 {s['gap2_ms']:.2f} ms span / "
                f"{s['gap2_interval_ms']:.2f} ms interval (n {s['n_gap2']}),"
                f" all main {s['main_ms']:.2f} ms, data wait "
                f"{s['data_ms']:.3f} ms")

    print(f"[pipeline] {card}: (a) MiDaS {H}x{W} float32 cached vs "
          f"--no_device_cache (each main step from the cached run's depth "
          f"parameters), {len(hists['f32_cached'])} steps: losses "
          f"within {worst:.3e} (tol {PIPE_RTOL}), {equal} steps bit-equal, "
          f"the same pairs, every cached batch equal to a fresh copy, "
          f"{cache_bytes} bytes cached ({n_pairs} pairs); bf16 cached vs "
          f"streaming, each run on its own, within {bf_worst:.3e}, "
          f"{bf_equal} steps bit-equal",
          flush=True)
    print(f"[pipeline] {card}: (b) medians over epochs {PIPE_TIMED} of "
          f"{PIPE_EPOCHS} (span: the step's device-clock span; interval: "
          f"from the previous step's end event): "
          + "; ".join(show(n) for n in ("f32_cached", "f32_streaming",
                                        "bf16_streaming", "bf16_cached"))
          + f"; one batch read + collate + copy on the host {host_ms[0]:.3f}"
          f" ms pageable, {host_ms[1]:.3f} ms pinned", flush=True)

    # (c) the trace
    reading = trace_reading(os.path.join(trace_dir, "trace.json"), n_pairs)
    shutil.rmtree(trace_dir)

    print(f"[pipeline] {card}: (c) --profile_dir, cached bf16 epoch 2 of "
          f"{n_pairs} steps: trace {reading['bytes']} bytes, kernels A-D "
          f"{reading['found']}, {reading['kernels']} device events; device "
          f"idle share {reading['idle']:.4f} of {reading['window_ms']:.2f} "
          f"ms ({reading['busy_ms']:.2f} ms busy, "
          f"{reading['window_ms'] / n_pairs:.2f} ms a step with the "
          f"profiler on)", flush=True)

    # (d) the fleet at --dp 1 streaming against phase 10 (a)'s cached run
    logdir = os.path.join(workdir, "fleet_streaming")
    old_env = os.environ.get("DVD_MIDAS_CKPT")
    os.environ["DVD_MIDAS_CKPT"] = os.path.join(workdir, "midas_biased.pt")
    try:
        out = fleet.main(fleet_flags(dev, workdir, logdir, FLEET_TRACK,
                                     "--no_device_cache"))
    finally:
        if old_env is None:
            os.environ.pop("DVD_MIDAS_CKPT", None)
        else:
            os.environ["DVD_MIDAS_CKPT"] = old_env
    check_fleet_run("pipeline (d)", out, checked, 1, "nccl")
    streamed = out["ranks"][0]
    for r in out["ranks"]:
        variants.update({tuple(k): n for k, n in r["variants"]})
    # the steps both start from the same state: the warm-up epoch and the
    # first main step
    same = [i for i, r in enumerate(fleet_a["records"]) if r["warm"]]
    same.append(len(same))
    fl_ok, fl_worst, fl_equal = losses_agree(
        [fleet_a["records"][i] for i in same],
        [streamed["records"][i] for i in same])
    _, fl_later, _ = losses_agree(fleet_a["records"], streamed["records"])
    if not fl_ok or len(fleet_a["records"]) != len(streamed["records"]) \
            or not fleet_a["cache_bytes"] or \
            streamed["cache_bytes"] is not None:
        fail(f"pipeline (d): the fleet's cached run vs streaming over the "
             f"steps from the same state: losses within {fl_worst:.3e} (tol "
             f"{PIPE_RTOL}), cache bytes {fleet_a['cache_bytes']} / "
             f"{streamed['cache_bytes']}")
    shutil.rmtree(logdir)
    torch.cuda.empty_cache()

    print(f"[pipeline] {card}: (d) fleet entry, NCCL, 1 video x dp 1: "
          f"cached ({fleet_a['cache_bytes']} bytes) vs --no_device_cache "
          f"losses within {fl_worst:.3e} over the {len(same)} steps from "
          f"the same state ({fl_equal} bit-equal), within {fl_later:.3e} "
          f"over all {len(streamed['records'])}; median main step "
          f"{statistics.median(fleet_a['step_ms'][4:]):.2f} ms cached, "
          f"{statistics.median(streamed['step_ms'][4:]):.2f} ms streaming",
          flush=True)

    # (e) ShutterStock preprocessing
    ss_text, ss_variants = phase_shutterstock(dev, workdir)
    variants.update(ss_variants)
    unchecked = set(variants) - checked
    if unchecked:
        fail(f"pipeline: launched kernel variants phase 2 did not check: "
             f"{sorted(unchecked)}")

    print(f"[pipeline] {card}: {ss_text}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return variants


# phase 12: the tools (tools/) and DAVIS stage 1 at DAVIS's raw size
DAVIS_RAW_FRAMES, DAVIS_RAW_HW = 4, (1080, 1920)
PROFILE_ITERS = 2  # main steps in each step_profile trace
ROOFLINE_REPS = 10  # launches timed per shape and direction


def run_tool(main, argv: list) -> tuple:
    """(exit code, printed text, wall seconds) of a tool's ``main``."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def golden_case(label: str, main, argv: list, golden: str, key: str,
                perturb, workdir: str) -> tuple:
    """A golden harness on the card at its protocol size: freeze (exit 0,
    the card within the tolerance of the CPU), recheck (0), another
    artifact (2), a perturbed golden (1). Returns (card-vs-CPU error, the
    freeze run's wall seconds)."""
    import re

    import numpy as np

    rc, out, secs = run_tool(main, argv + ["--golden", golden, "--freeze"])
    err = re.search(r"card-vs-CPU: ([0-9.e+-]+)", out)
    if rc != 0 or err is None:
        fail(f"golden {label}: freeze exited {rc}: {out}")
    rc, out, _ = run_tool(main, argv + ["--golden", golden])
    if rc != 0 or "vs frozen golden" not in out:
        fail(f"golden {label}: recheck exited {rc}: {out}")
    other = os.path.join(workdir, f"{label}_other.pth")
    with open(other, "wb") as f:
        f.write(b"another artifact")
    ckpt = argv.index("--ckpt") + 1
    rc, out, _ = run_tool(main, argv[:ckpt] + [other] + argv[ckpt + 1:]
                          + ["--golden", golden])
    if rc != 2:
        fail(f"golden {label}: another artifact exited {rc}, want 2: {out}")
    bad = os.path.join(workdir, f"{label}_perturbed.npz")
    with np.load(golden) as g:
        d = dict(g)
    d[key] = perturb(d[key])
    np.savez(bad, **d)
    rc, out, _ = run_tool(main, argv + ["--golden", bad])
    if rc != 1:
        fail(f"golden {label}: a perturbed golden exited {rc}, want 1: "
             f"{out}")
    return float(err.group(1)), secs


def phase_tools(dev, workdir: str, card: str, checked: set) -> dict:
    """Phase 12: (a) the golden checks (``tools/golden_depth.py``,
    ``tools/golden_raft.py``) on fake full-width checkpoints from seeds, at
    their protocol sizes on the card; (b) DAVIS stage 1 through
    ``run_davis.main --stage frames`` on raw 1080x1920 frames; (c) the step
    profile of the MiDaS fused step at gap 2 in float32 and bf16; (d) the
    convolution roofline in float32, TF32 and bf16, its float32 sum beside
    the float32 step's convolution time. Returns the kernel variants its
    paths launched."""
    import numpy as np
    import torch

    from dynamic_video_depth_tpu_torch.data.synthetic import write_raw_davis
    from dynamic_video_depth_tpu_torch.models import (HourglassModelEmbed,
                                                      MidasNet)
    from dynamic_video_depth_tpu_torch.models.raft import RAFT
    from dynamic_video_depth_tpu_torch.ops import cuda as kernels_mod
    from dynamic_video_depth_tpu_torch.preprocess import frames, run_davis
    from dynamic_video_depth_tpu_torch.runtime import weights
    from dynamic_video_depth_tpu_torch.tools import (golden, golden_depth,
                                                     golden_raft, roofline,
                                                     step_profile)

    t_phase = time.perf_counter()
    variants = collections.Counter()

    # (a) the golden checks on fake checkpoints in the official layouts
    midas_ckpt = os.path.join(workdir, "midas_cpkt.pt")
    net = weights.bias_midas_output(MidasNet(
        generator=torch.Generator().manual_seed(0)))
    torch.save({"model": net.state_dict(), "optimizer": {}}, midas_ckpt)
    hg = HourglassModelEmbed(generator=torch.Generator().manual_seed(1))
    hg_sd = {k.removeprefix("net_depth."): v
             for k, v in hg.state_dict().items()}
    hg_sd["uncertainty_layer.0.weight"] = torch.randn(
        1, 64, 3, 3, generator=torch.Generator().manual_seed(1))
    hg_sd["uncertainty_layer.0.bias"] = torch.zeros(1)
    hg_ckpt = os.path.join(workdir, "best_depth_Ours_Bilinear_inc_3_net_G.pth")
    torch.save(hg_sd, hg_ckpt)
    raft = RAFT(generator=torch.Generator().manual_seed(3))
    raft_ckpt = os.path.join(workdir, "raft-sintel.pth")
    torch.save({"module." + k: v for k, v in raft.state_dict().items()},
               raft_ckpt)
    del net, hg, hg_sd, raft
    lines = []
    for name, ckpt in (("midas", midas_ckpt), ("hourglass", hg_ckpt)):
        err, secs = golden_case(
            name, golden_depth.main,
            ["--net", name, "--ckpt", ckpt, "--device", str(dev)],
            os.path.join(workdir, f"golden_{name}.npz"), "prediction",
            lambda p: p * 1.01, workdir)
        lines.append(f"{name} depth 224x384 rel_err card-vs-CPU {err:.3e} "
                     f"(tol 1e-3), freeze run {secs:.2f} s")
    kernels_mod.reset_launches()
    err, secs = golden_case(
        "raft", golden_raft.main,
        ["--ckpt", raft_ckpt, "--device", str(dev)],
        os.path.join(workdir, "golden_raft.npz"), "flow",
        lambda f: f + 0.1, workdir)
    launches = kernels_mod.launch_counts()["corr_lookup"]
    variants.update(kernels_mod.launch_variants())
    # freeze, recheck and the perturbed golden run RAFT on the card
    if launches != 3 * golden_raft.RAFT_ITERS:
        fail(f"golden raft: {launches} lookup launches in three calls of "
             f"{golden_raft.RAFT_ITERS} iterations")
    lines.append(f"raft 288x512 x {golden_raft.RAFT_ITERS} EPE card-vs-CPU "
                 f"{err:.3e} px (tol 0.05), freeze run {secs:.2f} s, lookup "
                 f"{launches // 3} launches a call")
    for line in lines:
        print(f"[golden] {card}: {line}; exit codes 0 freeze, 0 recheck, "
              f"2 another artifact, 1 a perturbed golden", flush=True)

    # (b) DAVIS stage 1 at the raw 1080x1920
    raw, out = os.path.join(workdir, "davis_raw"), \
        os.path.join(workdir, "davis_1080")
    write_raw_davis(raw, "raw1080", DAVIS_RAW_FRAMES, *DAVIS_RAW_HW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with golden.module_attrs(weights, MIDAS_PRETRAIN_PATH=midas_ckpt):
        run_davis.main(["--raw_root", raw, "--track", "raw1080",
                        "--out_root", out, "--stage", "frames",
                        "--device", str(dev)])
    torch.cuda.synchronize()
    stage1_ms = 1e3 * (time.perf_counter() - t0) / DAVIS_RAW_FRAMES
    wh = frames.working_resolution(*DAVIS_RAW_HW)
    fdir = os.path.join(out, "frames_midas", "raw1080")
    depths = []
    for i in range(DAVIS_RAW_FRAMES):
        with np.load(os.path.join(fdir, f"frame_{i:05d}.npz")) as f:
            depths.append(f["depth_pred"])
            if f["img_orig"].shape != DAVIS_RAW_HW + (3,):
                fail(f"davis 1080: frame {i} img_orig {f['img_orig'].shape}")
        if depths[-1].shape != wh or not np.isfinite(depths[-1]).all():
            fail(f"davis 1080: frame {i} depth {depths[-1].shape}, want {wh}"
                 f" and finite")
    print(f"[davis1080] {card}: stage 1 on {DAVIS_RAW_FRAMES} raw "
          f"{DAVIS_RAW_HW[0]}x{DAVIS_RAW_HW[1]} frames, MiDaS at "
          f"{frames.midas_input_size(*DAVIS_RAW_HW)}, depth at the working "
          f"{wh}: {stage1_ms:.1f} ms a frame (JPEG reads, MiDaS, "
          f"calibration, npz writes); depth {min(map(np.min, depths)):.4g} "
          f".. {max(map(np.max, depths)):.4g}", flush=True)
    shutil.rmtree(out)

    # (c) the step profile of the MiDaS fused step at gap 2
    profiles = {}
    for label, bf16 in (("float32", False), ("bf16", True)):
        kernels_mod.reset_launches()
        outdir = os.path.join(workdir, f"profile_{label}")
        t0 = time.perf_counter()
        step_profile.capture(outdir, iters=PROFILE_ITERS, bf16=bf16)
        counts = kernels_mod.launch_counts()
        variants.update(kernels_mod.launch_variants())
        missing = [k for k in FLEET_KERNELS if not counts[k]]
        if missing:
            fail(f"profile {label}: the step launched none of {missing}")
        events, tcard, _ = step_profile.load_trace(outdir)
        r = step_profile.analyze(events, tcard, top=5)
        profiles[label] = r
        hand = {k: v["ms"] for k, v in r["by_category"].items()
                if k[:2] in ("A ", "B ", "C ", "D ")}
        if set(hand) < {"A warp", "B mlp_embed", "C chain",
                        "D projection loss"}:
            fail(f"profile {label}: the trace lacks kernels A-D: {hand}")
        cats = ", ".join(f"{k} {v['ms']:.3f}" for k, v in
                         r["by_category"].items())
        print(f"[profile] {r['card']}: MiDaS fused 224x384 gap 2 {label}, "
              f"{r['n_steps']} steps, device span "
              f"{statistics.median(r['step_spans_ms']):.3f} ms, busy "
              f"{r['busy_ms']:.3f} ms (share {r['busy_share']:.4f}, idle "
              f"{r['idle_share']:.4f}), convolutions {r['conv_ms']:.3f} ms; "
              f"capture and analysis {time.perf_counter() - t0:.1f} s",
              flush=True)
        print(f"[profile] {label} by category ms a step: {cats}", flush=True)
        print(f"[profile] {label} A-D ms a step: " + ", ".join(
            f"{k} {v:.4f}" for k, v in hand.items()), flush=True)
        for row in r["conv_by_shape"][:5]:
            print(f"[profile] {label} conv shape {row['ms']:.3f} ms "
                  f"{row['shape']}", flush=True)
        shutil.rmtree(outdir)

    # (d) the roofline of every MiDaS convolution shape
    sums = {}
    for dtype in roofline.DTYPES:
        t0 = time.perf_counter()
        r = roofline.run(dtype, reps=ROOFLINE_REPS)
        sums[dtype] = r["sum_step_ms"]
        c = r["caps"]
        print(f"[roofline] {r['card']}: {dtype} (peak {r['peak_tflops']:g} "
              f"TFLOP/s): {r['n_convs']} convolutions of {r['n_shapes']} "
              f"shapes, {r['gflop_fwd']:.1f} GFLOP a forward; sums fwd "
              f"{r['sum_ms']['fwd']:.3f} ms, dgrad "
              f"{r['sum_ms']['dgrad']:.3f}, wgrad {r['sum_ms']['wgrad']:.3f}"
              f", a step {r['sum_step_ms']:.3f} ms; caps matmul "
              f"{c['matmul_tflops']:.2f}, conv {c['conv_tflops']:.2f} "
              f"TFLOP/s; {time.perf_counter() - t0:.1f} s", flush=True)
        for rows in roofline.top_shapes(r, 10):
            print(f"[roofline] {dtype} {rows[0]['shape']} "
                  f"x{rows[0]['count']}: " + "; ".join(
                      f"{x['dir']} {x['algorithm']} {x['ms']:.4f} ms "
                      f"{x['tflops']:.2f} TFLOP/s share {x['share']:.4f}"
                      for x in rows)
                  + f"; ms x count {sum(x['ms_x_count'] for x in rows):.3f}",
                  flush=True)
    step_conv = profiles["float32"]["conv_ms"]
    print(f"[roofline] {card}: float32 convolutions, roofline sum "
          f"{sums['float32']:.3f} ms vs the step's {step_conv:.3f} ms "
          f"(step_profile), ratio step/sum {step_conv / sums['float32']:.3f}"
          f"; phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    unchecked = set(variants) - checked
    if unchecked:
        fail(f"tools: launched kernel variants phase 2 did not check: "
             f"{sorted(unchecked)}")
    return variants

# the card's error against a float64 CPU run, at most this many times the
# float32 CPU run's (float32 rounding; a wrong op or layout is off by ~1)
MASK_FACTOR = 10
SAVER_SPAN_STEPS = 4  # steps a turn, without and with a write in flight


def phase_reference(dev, workdir: str, card: str) -> dict:
    """Phase 13: (a) the recipe's saves through ``AsyncSaver``, (b) the
    MidasNet_mod mask head, (c) the reference's unfused geometry. Prints
    ``[saver]``, ``[mask]`` and ``[geometry]``; returns the launch
    variants of its paths."""
    import torch

    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        read_checkpoint, save_checkpoint)
    from dynamic_video_depth_tpu_torch.train.cli import build_run

    t_phase = time.perf_counter()
    variants = collections.Counter()
    # (a) the recipe's saves in the background
    track, gaps = PIPE_TRACK, PIPE_GAPS
    n_pairs = track_pairs(workdir, track)
    common = ["--epoch_batches", str(n_pairs), "--vali_batches", "2",
              "--batch_size", "1", "--device", str(dev)]
    argv = recipe_flags(track) + common + [
        "--epoch", "2", "--warm_sf", "1", "--save_every", "1",
        "--save_net", "1", "--data_root", workdir, "--track_id", track,
        "--gaps", ",".join(map(str, gaps)),
        "--logdir", os.path.join(workdir, "saver"),
        "--test_template", os.path.join(HERE, TEST_TEMPLATE),
        "--manual_seed", "0"]
    run = build_run(argv)
    logdir, step = run.logdir, run.model.step
    _, run_variants, walls = phase_trainer(dev, "saver", run.trainer, gaps,
                                           MIDAS_KERNELS, midas=True)
    variants.update(run_variants)
    peak = torch.cuda.max_memory_allocated()
    run.chain_test()
    if not os.path.isfile(os.path.join(logdir, "test",
                                       "epochbest_test.json")):
        fail("saver: the chained test entry wrote no summary")
    records = list(run.saves)
    if run.saver.writing(logdir) or len(records) < 5:
        fail(f"saver: {len(records)} writes landed, want checkpoint.pt, "
             "nets/%04d.pt and best.pt of the first epoch and checkpoint.pt "
             "and nets/0002.pt of the second at least")

    # the last epoch's files against a synchronous save of the same state
    sync_s, compared = [], []
    for rec in records[-3:]:
        saved = read_checkpoint(rec.path)
        if saved["epoch"] != 2:
            continue
        ref = os.path.join(workdir, "sync_" + os.path.basename(rec.path))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(ref, step, epoch=saved["epoch"], best=saved["best"],
                        include_opt="optimizers" in saved)
        sync_s.append(time.perf_counter() - t0)
        if not state_equal(saved, read_checkpoint(ref)):
            fail(f"saver: {rec.path} differs from a synchronous save of "
                 "the same state")
        compared.append(os.path.relpath(rec.path, logdir))
        os.remove(ref)
    if "checkpoint.pt" not in compared or "nets/0002.pt" not in compared:
        fail(f"saver: compared {compared}, want checkpoint.pt and "
             "nets/0002.pt of epoch 2")

    # the next step, resumed from checkpoint.pt and unbroken
    resumed = build_run(["--full_logdir", logdir, "--resume", "-1",
                         "--epoch", "3"] + common)
    batch = gap_batch(run.trainer.dataset_train, 2, dev)
    logs = [{k: float(v) for k, v in s.train_step(batch, 2, False).items()}
            for s in (step, resumed.model.step)]
    torch.cuda.synchronize()
    if resumed.start_epoch != 3 or any(logs[0][k] != logs[1][k]
                                       for k in LOSS_KEYS):
        fail(f"saver: the resumed step's losses {logs[1]} differ from the "
             f"unbroken run's {logs[0]}")
    other = resumed.model.step
    param_diff = max(
        (a - b).abs().max().item()
        for mine, theirs in ((step.net_depth, other.net_depth),
                             (step.net_sf, other.net_sf))
        for a, b in zip(mine.parameters(), theirs.parameters()))
    del resumed, other

    # a main step at gap 2 (host clock to its losses) without and with a
    # write of a fresh snapshot in flight, in turns; a step that ends after
    # the write landed is not counted as with one
    spans = {"without": [], "with": []}
    probe = os.path.join(workdir, "saver_probe.pt")
    for turn in ("without", "with", "without", "with"):
        if turn == "with":
            run.saver.invalidate()  # a fresh snapshot to write
            run.saver.save(probe, step)
        for _ in range(SAVER_SPAN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step.train_step(batch, 2, False)
            torch.cuda.synchronize()
            if turn == "without" or run.saver.writing(probe):
                spans[turn].append(1e3 * (time.perf_counter() - t0))
        run.saver.flush()
    run.saver.close()
    os.remove(probe)
    hist = run.trainer.history
    outside = {e: 1 - sum(r["seconds"] for r in hist if r["epoch"] == e)
               / walls[e] for e in walls}

    def med(xs):
        return f"{statistics.median(xs):.2f}" if xs else "none"

    by_file = collections.defaultdict(list)
    for rec in records:
        name = ("nets/%04d.pt" if "/nets/" in rec.path
                else os.path.basename(rec.path))
        by_file[name].append(rec)
    files = "; ".join(
        f"{name} {len(v)} writes: blocking "
        + "/".join(f"{1e3 * r.blocking:.2f}" for r in v) + " ms, writer "
        + "/".join(f"{r.seconds:.3f}" for r in v) + f" s, {v[-1].bytes} bytes"
        for name, v in sorted(by_file.items()))
    print(f"[saver] {card}: MiDaS {H}x{W}, {n_pairs} steps an epoch, 2 "
          f"epochs; {files}; a synchronous save_checkpoint of the same "
          "state " + "/".join(f"{x:.3f}" for x in sync_s) + " s (blocking); "
          f"{', '.join(compared)} equal to it bit for bit; main step at gap "
          f"2 (host clock to its losses, in turns) with a write in flight "
          f"{med(spans['with'])} ms (n {len(spans['with'])}: "
          + "/".join(f"{x:.1f}" for x in spans["with"])
          + f"), without {med(spans['without'])} ms (n "
          f"{len(spans['without'])}: "
          + "/".join(f"{x:.1f}" for x in spans["without"])
          + "); share of epoch wall outside the train steps "
          + ", ".join(f"{outside[e]:.3f} epoch {e} ({walls[e]:.2f} s)"
                      for e in sorted(walls))
          + f"; peak device memory {peak / 2**30:.2f} GiB; resumed next step "
          f"losses bit-equal, parameters after it within {param_diff:.3e}",
          flush=True)
    shutil.rmtree(logdir)
    del run, step, batch
    gc.collect()  # a Run and its hooks hold each other
    torch.cuda.empty_cache()
    saver_turns(dev, workdir, card, argv)

    phase_mask_head(dev, card)
    variants.update(phase_geometry(dev, card))
    print(f"[phase 13] {time.perf_counter() - t_phase:.1f} s", flush=True)
    return variants


class SyncSaver:
    """The train entry's saves made inline by ``save_checkpoint``, as before
    the background writer; phase 13 swaps it into a ``Run`` to time the two
    in turns. Each record's blocking time is its write's."""

    def __init__(self):
        self.records = []

    def save(self, path, step, epoch=0, best=float("inf"), include_opt=True):
        from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
            SaveRecord, save_checkpoint)
        t0 = time.perf_counter()
        save_checkpoint(path, step, epoch=epoch, best=best,
                        include_opt=include_opt)
        sec = time.perf_counter() - t0
        self.records.append(SaveRecord(path, sec, os.path.getsize(path), sec))

    def invalidate(self):
        pass

    def flush(self):
        pass

    close = flush


def saver_turns(dev, workdir: str, card: str, argv: list) -> None:
    """Phase 13 (a), the recipe's cost of saving: the same run (2 epochs,
    a save of each kind every epoch) with synchronous saves and with the
    background writer, in turns (sync, async, async, sync); each run's
    epoch walls, its whole ``train`` (the last writes' wait included), the
    writes' blocking seconds and its peak device memory (``[saver turns]``).
    """
    import torch

    from dynamic_video_depth_tpu_torch.train.cli import build_run

    logdir_at = argv.index("--logdir") + 1
    out = {"sync": [], "async": []}
    for i, kind in enumerate(("sync", "async", "async", "sync")):
        turn = list(argv)
        turn[logdir_at] = os.path.join(workdir, f"saver_turn{i}")
        run = build_run(turn)
        if kind == "sync":
            run.saver = SyncSaver()
            run.saves = run.saver.records
        trainer, train = run.trainer, run.trainer.train
        total = []

        def timed(train=train, total=total):
            t0 = time.perf_counter()
            train()
            torch.cuda.synchronize()
            total.append(time.perf_counter() - t0)

        trainer.train = timed
        _, _, walls = phase_trainer(dev, f"saver turn {i} {kind}", trainer,
                                    PIPE_GAPS, MIDAS_KERNELS, midas=True)
        peak = torch.cuda.max_memory_allocated()
        steps = {e: sum(r["seconds"] for r in trainer.history
                        if r["epoch"] == e) for e in walls}
        out[kind].append({
            "walls": [walls[e] for e in sorted(walls)],
            "steps": [steps[e] for e in sorted(walls)],
            "train": total[0],
            "blocking": sum(r.blocking for r in run.saves),
            "n": len(run.saves), "peak": peak})
        shutil.rmtree(run.logdir)
        del run, trainer, train, timed
        gc.collect()
        torch.cuda.empty_cache()

    def show(r):
        return ("epochs " + "/".join(f"{w:.3f}" for w in r["walls"])
                + " s (steps " + "/".join(f"{x:.3f}" for x in r["steps"])
                + f" s), train {r['train']:.3f} s, {r['n']} saves blocking "
                f"{r['blocking']:.3f} s, peak {r['peak'] / 2**30:.2f} GiB")

    print(f"[saver turns] {card}: the recipe's run in turns, sync / async / "
          f"async / sync: " + "; ".join(
              f"{kind} {show(r)}" for kind, r in
              (("sync", out["sync"][0]), ("async", out["async"][0]),
               ("async", out["async"][1]), ("sync", out["sync"][1]))),
          flush=True)


def phase_mask_head(dev, card: str) -> None:
    """Phase 13 (b): MidasNet_mod at 224x384 on the card and on the CPU in
    float32 against the CPU in float64, forward and backward; the card's
    error against float64 within ``MASK_FACTOR`` times the CPU float32
    run's (each output, and the heads' gradients, worst over parameters);
    and the mask head's device time at the step's batch of 2."""
    import copy

    import torch

    from dynamic_video_depth_tpu_torch.models import MidasNet
    from dynamic_video_depth_tpu_torch.runtime.weights import (
        bias_midas_output)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    cpu = bias_midas_output(MidasNet(mask_branch=True, freeze_backbone=True,
                                     generator=gen))
    net = MidasNet(mask_branch=True, freeze_backbone=True).to(dev)
    net.load_state_dict(cpu.state_dict())
    img = torch.rand(1, H, W, 3, generator=gen)
    outs = []
    for model, x in ((copy.deepcopy(cpu).double(), img.double()),
                     (cpu, img), (net, img.to(dev))):
        depth, mask = model(x)
        (1e-3 * depth.sum() + mask.sum()).backward()
        outs.append([depth.detach().cpu().double(),
                     mask.detach().cpu().double()]
                    + [None if p.grad is None else p.grad.cpu().double()
                       for p in model.parameters()])
    names = ["depth", "mask"] + [n for n, _ in net.named_parameters()]
    ref, f32, card_out = outs
    errs = {"cpu": {}, "card": {}}
    for i, name in enumerate(names):
        if name.startswith("pretrained."):
            if f32[i] is not None or card_out[i] is not None:
                fail(f"mask: the frozen backbone took a gradient ({name})")
            continue
        errs["cpu"][name] = rel_err(f32[i], ref[i])[1]
        errs["card"][name] = rel_err(card_out[i], ref[i])[1]
    worst = {}
    for side, e in errs.items():
        grads = {k: v for k, v in e.items() if k not in ("depth", "mask")}
        worst[side] = (e["depth"], e["mask"], max(grads.values()),
                       max(grads, key=grads.get))
    over = [what for what, c, f in zip(("depth", "mask", "gradients"),
                                       worst["card"], worst["cpu"])
            if not c <= MASK_FACTOR * f]
    if over:
        fail(f"mask: the card against float64 {worst['card'][:3]}, more "
             f"than {MASK_FACTOR}x the CPU float32 run's {worst['cpu'][:3]} "
             f"({over})")
    if not (0.0 < float(card_out[1].min()) and float(card_out[1].max()) < 1.0):
        fail("mask: the mask is not inside (0, 1)")
    gen = torch.Generator().manual_seed(1)

    path1 = torch.randn(2, 256, H // 2, W // 2, generator=gen).to(dev)
    scratch = net.scratch
    with torch.no_grad():
        head_ms = time_ms(lambda: scratch.output_conv_mask(path1), reps=5,
                          warmup=1)
        conv0_ms = time_ms(lambda: scratch.output_conv_mask[0](path1),
                           reps=5, warmup=1)
        depth_head_ms = time_ms(lambda: scratch.output_conv(path1), reps=5,
                                warmup=1)
    card_w, cpu_w = worst["card"], worst["cpu"]
    print(f"[mask] {card}: MidasNet_mod {H}x{W}, against the CPU in "
          f"float64: the card depth {card_w[0]:.3e}, mask {card_w[1]:.3e}, "
          f"the heads' gradients {card_w[2]:.3e} ({card_w[3]}); the CPU in "
          f"float32 {cpu_w[0]:.3e}, {cpu_w[1]:.3e}, {cpu_w[2]:.3e} "
          f"({cpu_w[3]}); backbone frozen (no gradient); mask head "
          f"forward {head_ms:.2f} ms on path1 [2,256,{H // 2},{W // 2}], "
          f"its output_conv_mask[0] (3x3 256->128) {conv0_ms:.2f} ms, the "
          f"depth head {depth_head_ms:.2f} ms (float32, TF32 off)",
          flush=True)
    del net, cpu, outs, ref, f32, card_out
    torch.cuda.empty_cache()


def phase_geometry(dev, card: str) -> dict:
    """Phase 13 (c): the reference's unfused geometry at 224x384 on the
    card against the CPU, the fused stages against it on the card; returns
    kernel A's launch variants by the unfused functions (counts set to 0
    just before)."""
    import torch

    from dynamic_video_depth_tpu_torch.ops import cuda as kernels_mod
    from dynamic_video_depth_tpu_torch.ops import geometry
    from dynamic_video_depth_tpu_torch.ops.camera import Camera

    tol = TOL["warp_bwd"]
    gen = torch.Generator().manual_seed(2)
    f = 0.8 * W
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])[None]

    def rotation(angle=0.1):
        k = torch.randn(3, generator=gen)
        k = k / k.norm() * angle
        kx = torch.tensor([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                           [-k[1], k[0], 0]])
        return torch.linalg.matrix_exp(kx)[None]

    cams = [(rotation(), 0.05 * torch.randn(1, 3, generator=gen), K,
             torch.linalg.inv(K)) for _ in range(2)]
    d1 = 2.0 + 3.0 * torch.rand(1, H, W, generator=gen)
    d2 = 2.0 + 3.0 * torch.rand(1, H, W, generator=gen)
    flow = track_flows(H, W, 2)
    sf = 0.05 * torch.randn(1, H, W, 3, generator=gen)
    results, variants = [], {}
    for device in (torch.device("cpu"), dev):
        card_run = device.type == "cuda"
        c1, c2 = (Camera(*(t.to(device) for t in c)) for c in cams)
        x1, x2 = (d.to(device, copy=True).requires_grad_() for d in (d1, d2))
        fl, s = flow.to(device), sf.to(device)
        if card_run:
            torch.cuda.synchronize()
            kernels_mod.reset_launches()
        fbd = geometry.flow_by_depth(x1, x2, fl, c1, c2)
        pr = geometry.scene_flow_projection(x1, x2, fl, c1, c2, s)
        (fbd["sf_by_depth"].abs().sum() + pr["dflow_1_2"].abs().sum()
         + pr["depth_warp_1_2"].abs().sum()).backward()
        if card_run:
            torch.cuda.synchronize()
            variants = kernels_mod.launch_variants()
        rig, _ = geometry.rigidity_loss(fbd["global_p1"].detach(), s,
                                        x1.detach())
        stage = geometry.depth_warp_stage(x1.detach(), x2.detach(), fl, c1,
                                          c2)
        fused = dict(geometry.projection_stage(x1.detach(), x2.detach(), c2,
                                               s, stage),
                     sf_by_depth=stage["sf_by_depth"])
        results.append((fbd, pr, (x1.grad, x2.grad), rig, fused))
    want = {("warp_fwd", 3): 1, ("warp_bwd", 3): 1, ("warp_fwd", 4): 1,
            ("warp_bwd", 4): 1}
    if dict(variants) != want:
        fail(f"geometry: kernel A launched {dict(variants)}, want {want}")
    (f0, p0, g0, r0, _), (f1, p1, g1, r1, fused) = results
    worst = {}
    for name, a, b in ([(f"flow_by_depth.{k}", f1[k], f0[k]) for k in f0]
                       + [(f"scene_flow_projection.{k}", p1[k], p0[k])
                          for k in p0]
                       + [("grad depth_1", g1[0], g0[0]),
                          ("grad depth_2", g1[1], g0[1]),
                          ("rigidity_loss", r1, r0)]):
        worst[name] = rel_err(a.detach().cpu(), b.detach())[1]
    identity = {k: rel_err(fused[k], (f1 if k == "sf_by_depth" else p1)[k]
                           .detach())[1] for k in fused}
    bad = {k: v for k, v in list(worst.items()) + [
        ("fused." + k, v) for k, v in identity.items()] if not v <= tol}
    if bad:
        fail(f"geometry: above {tol}: {bad}")
    top = max(worst, key=worst.get)
    print(f"[geometry] {card}: flow_by_depth, scene_flow_projection and "
          f"rigidity_loss at {H}x{W} on the card vs the CPU: worst "
          f"{worst[top]:.3e} ({top}), gradients {worst['grad depth_1']:.3e} /"
          f" {worst['grad depth_2']:.3e}; fused stages vs the unfused "
          f"functions on the card: worst {max(identity.values()):.3e} "
          f"(tol {tol}); kernel A launches {dict(variants)}", flush=True)
    return variants



# phase 14: the kernels each leg family of the bench must launch: A-D on the
# MiDaS legs (every evaluation's backward runs in the chain, C, so B's
# backward on none), A and B on the hourglass legs.
BENCH_KERNELS = {"midas": ("warp_fwd", "warp_bwd", "mlp_fwd", "chain_bwd",
                           "loss_fwd", "loss_bwd"),
                 "hourglass": ("warp_fwd", "warp_bwd", "mlp_fwd")}


def run_bench(bench, argv: list, card: str) -> dict:
    """``bench.main(argv)`` in this process, its output captured; its
    ``[bench]`` leg lines printed with ``card`` in front and its JSON line
    parsed (a nonzero status or an unparsable last line fails)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    lines = out.getvalue().strip().splitlines()
    if rc != 0:
        fail(f"the bench {argv} exited {rc}: {lines[-3:]}")
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError) as exc:
        fail(f"the bench {argv} printed no JSON line last: {exc}")
    for line in lines[1:-1]:  # the first is the card's
        print(line.replace("[bench] ", f"[bench] {card}: ", 1), flush=True)
    print(f"[bench json] {json.dumps(result)}", flush=True)
    return result


def phase_bench(dev, card: str, checked: set, shapes: set) -> dict:
    """Phase 14: ``tools/bench.py``'s legs through its ``main`` on the card,
    then ``--wide``. Each JSON line parses; every leg's loss is finite and
    not 0; each leg launched ``BENCH_KERNELS`` of its family; every kernel
    and variant a leg launched was checked in phase 2 at that variant, the
    leg's (h, w) and a batch at least the leg's (``shapes``), and every
    variant the bench launched too (``checked``). Returns the bench's
    launches by variant."""
    import torch

    from dynamic_video_depth_tpu_torch.tools import bench

    t0 = time.perf_counter()
    variants = collections.Counter()
    for argv in ([], ["--wide"]):
        result = run_bench(bench, argv, card)
        for leg in result["legs"]:
            net, b, h, w = leg["net"], leg["batch"], leg["h"], leg["w"]
            if not (math.isfinite(leg["loss"]) and leg["loss"] != 0.0):
                fail(f"bench {leg['name']}: loss {leg['loss']}")
            missing = [k for k in BENCH_KERNELS[net]
                       if not leg["launches"].get(k)]
            if missing:
                fail(f"bench {leg['name']}: kernels not launched: {missing}")
            by_kernel = collections.defaultdict(set)
            for name, *key, n in leg["variants"]:
                by_kernel[name].add(tuple(key))
                variants[(name, *key)] += n
            for k in leg["launches"]:
                for key in by_kernel.get(k, {()}):
                    if not any(s[:2] == (k, key) and s[3:] == (h, w)
                               and s[2] >= b for s in shapes):
                        fail(f"bench {leg['name']}: {k} {key} ran at batch "
                             f"{b}, {h}x{w}, a shape phase 2 did not check")
        torch.cuda.empty_cache()
    unchecked = set(variants) - checked
    if unchecked:
        fail(f"the bench launched kernel variants that phase 2 did not "
             f"check: {sorted(unchecked)}")
    print(f"[phase 14] {time.perf_counter() - t0:.1f} s", flush=True)
    return variants


def phase_mlp(dev, results: dict) -> None:
    """Phase 2's lines for the tiles that kernels B, C and fused_mlp share:
    B, then C, then the dense stack."""
    from dynamic_video_depth_tpu_torch.ops.cuda import chain_kernel

    phase_build([chain_kernel])
    phase_kernel_b(dev, results)
    phase_kernel_c(dev, results)
    phase_dense(dev, results)


# --only: the kernel family's module and phase
ONLY = {"warp": ("warp_kernel", phase_kernel_a),
        "loss": ("loss_kernel", phase_kernel_d),
        "corr": ("corr_kernel", phase_lookup),
        "mlp": ("mlp_kernel", phase_mlp)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=sorted(ONLY),
                        help="build and time one kernel family alone "
                        "(phase 2's lines for it), print no result")
    parser.add_argument("--warp_only", action="store_const", dest="only",
                        const="warp", help="the same as --only warp")
    parser.add_argument("--repo", default=HERE,
                        help="the checkout whose package is driven (with "
                        "--only: another tree's kernels, for a "
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
    if args.only:
        import importlib

        module_name, phase = ONLY[args.only]
        print(f"[tree] {os.path.abspath(args.repo)}: --only {args.only}",
              flush=True)
        phase_build([importlib.import_module(
            f"dynamic_video_depth_tpu_torch.ops.cuda.{module_name}")])
        phase(dev, {})
        return
    phase_build()
    results = {}
    phase_kernel_a(dev, results)
    phase_kernel_b(dev, results)
    phase_kernel_c(dev, results)
    phase_kernel_d(dev, results)
    phase_lookup(dev, results)
    phase_dense(dev, results)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        counts, midas_variants, f32_run = phase_recipe(dev, workdir, card)
        torch.cuda.empty_cache()
        hourglass, hourglass_variants = phase_hourglass(dev, workdir)
        torch.cuda.empty_cache()
        pre_counts, pre_variants = phase_preprocess(dev, workdir, card,
                                                    results)
        torch.cuda.empty_cache()
        bf16, bf16_variants = phase_bf16(dev, workdir, card, f32_run)
        del f32_run
        torch.cuda.empty_cache()
        var_counts, var_variants = phase_variants(dev, workdir, card)
        torch.cuda.empty_cache()
        _, fleet_a = phase_fleet(dev, workdir, card, results["checked"])
        torch.cuda.empty_cache()
        pipe_variants = phase_pipeline(dev, workdir, card,
                                       results["checked"], fleet_a)
        torch.cuda.empty_cache()
        tool_variants = phase_tools(dev, workdir, card, results["checked"])
        torch.cuda.empty_cache()
        ref_variants = phase_reference(dev, workdir, card)
        torch.cuda.empty_cache()
        bench_variants = phase_bench(dev, card, results["checked"],
                                     results.pop("shapes"))
        torch.cuda.empty_cache()
    if not (bf16_variants.get(("warp_fwd", 3))
            and var_variants.get(("warp_fwd", 3))):
        fail(f"the bf16 or variant path did not launch the warp at 3 "
             f"channels: {bf16_variants}, {var_variants}")
    if hourglass["chain_bwd"] or hourglass["loss_fwd"]:
        fail(f"the hourglass path with the fused paths off launched kernel "
             f"C or D: {hourglass}")
    if not (midas_variants.get(("warp_fwd", 3))
            and midas_variants.get(("warp_bwd", 3))):
        fail(f"the MiDaS path did not launch the warp at 3 channels: "
             f"{midas_variants}")
    unchecked = (set(midas_variants) | set(hourglass_variants)
                 | set(pre_variants) | set(bf16_variants)
                 | set(var_variants) | set(pipe_variants)
                 | set(tool_variants) | set(ref_variants)
                 | set(bench_variants)) \
        - results.pop("checked")
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
