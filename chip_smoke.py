#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.

1. Builds the hand-written kernels (``dynamic_video_depth_tpu_torch/csrc``),
   one nvcc per library, all at once, and prints the card's name and power
   limit.
2. Holds every kernel against its plain PyTorch version on the card, at the
   train step's shapes, and times both: the warp (A) at 224x384 with 4
   channels (the depth warp) and 3 (the fused loss's point warp), the
   embedded MLP (B) at 224x384; the Euler-chain backward (C) at 86,016
   points for (n_steps, n_evals) = (1, 2), (2, 2), (4, 4) and (8, 8), the
   chains of gaps 1, 2, 4 and 8; the projection-loss forward and backward
   (D) at 224x384 and 320x576 in the use_disp, MiDaS, warm-up and main
   configurations.
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
5. Runs a warm-up and a main step of the hourglass slice on a small input
   on the card (fused paths) and on the CPU (plain, unfused) and compares
   the losses.

Prints one JSON line with the kernels' results, then the card's name and
power limit, then ``{"ok": true, "device": {...}}`` last. Exits nonzero,
printing no result, when any phase fails or no CUDA device is present. It
imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 224, 384
N_PTS = H * W
WIDE = (320, 576)
# tolerances: max |kernel - plain| / max |plain| per tensor, and for the
# four sums of the loss forward |kernel - plain| / |plain| per sum (see
# PERF.md for the readings)
TOL = {"warp_fwd": 1e-6, "warp_bwd": 1e-5, "mlp_fwd": 1e-4, "mlp_bwd": 1e-5,
       "chain_fwd": 1e-5, "chain_bwd": 1e-5, "loss_fwd": 1e-5,
       "loss_bwd": 1e-5}
CHAINS = ((1, 2), (2, 2), (4, 4), (8, 8))  # (n_steps, n_evals) of gaps 1-8
SOURCE = {"warp_fwd": "warp.cu", "warp_bwd": "warp.cu",
          "mlp_fwd": "mlp_embed.cu", "mlp_bwd": "mlp_embed.cu",
          "chain_bwd": "mlp_chain.cu", "loss_fwd": "projection_loss.cu",
          "loss_bwd": "projection_loss.cu"}
PALLAS = "dynamic_video_depth_tpu/ops/pallas/"
REPLACES = {"warp_fwd": PALLAS + "warp_kernel.py:257",
            "warp_bwd": PALLAS + "warp_kernel.py:295",
            "mlp_fwd": PALLAS + "mlp_kernel.py:343",
            "mlp_bwd": PALLAS + "mlp_kernel.py:405",
            "chain_bwd": PALLAS + "mlp_kernel.py:772",
            "loss_fwd": PALLAS + "loss_kernel.py:317",
            "loss_bwd": PALLAS + "loss_kernel.py:353"}
# kernels each trainer path must launch
HOURGLASS_KERNELS = ("warp_fwd", "warp_bwd", "mlp_fwd", "mlp_bwd")
MIDAS_KERNELS = tuple(SOURCE)


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


def rel_err(a, b) -> tuple:
    """(max abs error, max abs error / max |reference|)."""
    err = (a - b).abs().max().item()
    return err, err / max(b.abs().max().item(), 1e-30)


def rel_err_each(a, b) -> tuple:
    """(max abs error, max over elements of |a - b| / |b|)."""
    diff = (a - b).abs()
    return (diff.max().item(),
            (diff / b.abs().clamp_min(1e-30)).max().item())


def phase_build():
    """Build every kernel library at once (one nvcc each) and print the
    compiler's register and spill report."""
    from dynamic_video_depth_tpu_torch.ops.cuda import KERNEL_MODULES, build

    with ThreadPoolExecutor(len(KERNEL_MODULES)) as pool:
        for future in [pool.submit(mod._lib) for mod in KERNEL_MODULES]:
            future.result()
    for mod in KERNEL_MODULES:
        report = build.library_path(mod.LIBRARY, mod.SOURCES,
                                    mod.FLAGS).with_suffix(".ptxas.txt")
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {mod.LIBRARY}] {line.strip()}")


def report(results: dict, name: str, err: tuple, ms: float,
           plain_ms: float, what: str = "", variant: tuple = ()) -> None:
    """Print one comparison, fail past the tolerance, and keep the worst
    error and the first timing of each kernel; ``variant`` names the
    branch checked, as ``ops.cuda.launch_variants`` keys it."""
    ok = err[1] <= TOL[name]
    print(f"[kernel] {name}{what}: max_abs_err {err[0]:.3e} rel {err[1]:.3e} "
          f"(tol {TOL[name]:.0e}) {'ok' if ok else 'FAIL'}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    if not ok:
        fail(f"{name}{what} disagrees with its plain version: rel "
             f"{err[1]:.3e}")
    if name in results:
        old = results[name]
        results[name] = dict(old, err=max(old["err"], err[0]))
    else:
        results[name] = {"err": err[0], "ms": ms, "plain_ms": plain_ms}
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


def phase_kernels_ab(dev, results: dict) -> None:
    """Kernels A and B against their plain versions at 224x384."""
    import torch

    from dynamic_video_depth_tpu_torch.ops.cuda import mlp_kernel, warp_kernel

    gen = torch.Generator().manual_seed(0)

    # kernel A at [1, 224, 384, C] for the depth warp's C = 4 (the vector
    # forward) and the fused loss's C = 3; flows of up to +-60 px send
    # samples past every border, and a row of exact-border targets hits
    # x == W-1
    flow = (60.0 * torch.randn(1, H, W, 2, generator=gen)).to(dev)
    xs = torch.arange(W, device=dev, dtype=torch.float32)
    flow[0, 0, :, 0] = (W - 1) - xs  # first row lands exactly on x = W-1
    for c in (4, 3):
        src = torch.randn(1, H, W, c, generator=gen).to(dev)
        g = torch.randn(1, H, W, c, generator=gen).to(dev)
        out_k = warp_kernel.warp_forward_cuda(src, flow)
        out_p = warp_kernel.backward_warp_plain(src, flow)
        src_p = src.clone().requires_grad_(True)
        (warp_kernel.backward_warp_plain(src_p, flow) * g).sum().backward()
        dsrc_k = warp_kernel.warp_backward_cuda(g, flow)
        torch.cuda.synchronize()

        def plain_bwd():
            s = src.clone().requires_grad_(True)
            (warp_kernel.backward_warp_plain(s, flow) * g).sum().backward()

        what = f" [1,{H},{W},{c}]"
        report(results, "warp_fwd", rel_err(out_k, out_p),
               time_ms(lambda: warp_kernel.warp_forward_cuda(src, flow)),
               time_ms(lambda: warp_kernel.backward_warp_plain(src, flow)),
               what, (c,))
        report(results, "warp_bwd", rel_err(dsrc_k, src_p.grad),
               time_ms(lambda: warp_kernel.warp_backward_cuda(g, flow)),
               time_ms(plain_bwd), what, (c,))

    # kernel B at N = 224 * 384 with the canonical field's random weights
    ws, bs = field_weights(gen, dev)
    pts, ts = field_points(gen, dev)
    gm = torch.randn(N_PTS, 3, generator=gen).to(dev)
    consts = mlp_kernel.embed_consts(16, 16, True, dev)
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
    report(results, "mlp_fwd", rel_err(fwd_k, plain_fwd()),
           time_ms(lambda: mlp_kernel.mlp_forward_cuda(pts, ts, consts, ws,
                                                       bs)),
           time_ms(plain_fwd))
    report(results, "mlp_bwd", bwd_err,
           time_ms(lambda: mlp_kernel.mlp_backward_cuda(
               pts, ts, consts, ws, bs, gm), reps=10),
           time_ms(plain_grads, reps=10))


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
    gs = [(torch.randn(N_PTS, 3, generator=gen) / N_PTS).to(dev)
          for _ in range(3)]
    for n_steps, n_evals in CHAINS:
        args = (n_steps, n_evals, 100.0)
        acc, f0, f1, stash = chain_kernel.chain_forward_cuda(
            pts, ts, dt, consts, ws, bs, *args)

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
        report(results, "chain_bwd",
               max((rel_err(a, b) for a, b in zip(got, want)),
                   key=lambda e: e[1]),
               time_ms(kernel_bwd, reps=5), time_ms(plain_bwd, reps=5),
               what, (n_steps, n_evals))
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
            report(results, "loss_fwd", rel_err_each(sums, ref.detach()),
                   time_ms(lambda: loss_kernel.loss_forward_cuda(args,
                                                                 flags)),
                   time_ms(lambda: loss_kernel.projection_loss_plain(
                       *args, *cfg)), what)
            report(results, "loss_bwd",
                   max((rel_err(a, b) for a, b in zip(grads, ref_grads)),
                       key=lambda e: e[1]),
                   time_ms(lambda: loss_kernel.loss_backward_cuda(
                       args, flags, cot)), time_ms(plain_bwd), what)


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
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    phase_build()
    results = {}
    phase_kernels_ab(dev, results)
    phase_kernel_c(dev, results)
    phase_kernel_d(dev, results)
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
    if hourglass["chain_bwd"] or hourglass["loss_fwd"]:
        fail(f"the hourglass path with the fused paths off launched kernel "
             f"C or D: {hourglass}")
    if not (midas_variants.get(("warp_fwd", 3))
            and midas_variants.get(("warp_bwd", 3))):
        fail(f"the MiDaS path did not launch the warp at 3 channels: "
             f"{midas_variants}")
    unchecked = (set(midas_variants) | set(hourglass_variants)) - \
        results.pop("checked")
    if unchecked:
        fail(f"the trainer paths launched kernel variants that phase 2 did "
             f"not check: {sorted(unchecked)}")
    phase_small_reference(dev)
    if "jax" in sys.modules or "dynamic_video_depth_tpu" in sys.modules:
        fail("JAX was imported")
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"dynamic_video_depth_tpu_torch/csrc/{SOURCE[name]}",
        "replaces": REPLACES[name], "launches": counts[name],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
    } for name, r in results.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
