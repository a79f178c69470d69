"""Rank processes of ``tests/test_torch_parallel.py`` (no JAX here).

``run(rank, world, init_file, cases_file, out_dir, devices, backend)``
joins a process group (gloo by default) through a ``file://`` rendezvous,
runs every case of ``cases_file`` (a pickle written by the test) through
the port's ``parallel`` classes on ``devices[rank]`` (the CPU by default,
with one thread), and pickles this rank's results to
``out_dir/rank<r>.pkl``: per case the logs of each step and both nets'
state dicts (numpy), or the error ``place`` raised. A case's ``init`` is
the JAX package's initial variables, or ``None`` for the port's seed-0
nets.
"""

import os
import pickle
import sys

import numpy as np
import torch

from torch_threads import THREADS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def make_step(cfg, init, device="cpu"):
    """The port's step on ``device`` from the JAX package's initial
    variables ``init = (depth, sf)``, or from seed 0 when ``init`` is
    ``None``."""
    from dynamic_video_depth_tpu_torch.runtime import weights
    from dynamic_video_depth_tpu_torch.train import SceneFlowMotionFieldStep

    step = SceneFlowMotionFieldStep(cfg, device=device)
    if init is not None:
        weights.load_flax(step.net_depth, init[0])
        weights.load_flax(step.net_sf, init[1])
    return step


def numpy_state(step):
    return [{k: v.detach().cpu().numpy().copy()
             for k, v in net.state_dict().items()}
            for net in (step.net_depth, step.net_sf)]


def run_steps(scheme, batch, schedule):
    """``schedule``: (steps, warm) pairs; the logs of each step as floats."""
    return [{k: float(v) for k, v in scheme.train_step(batch, s, w).items()}
            for s, w in schedule]


def run_case(case, rank, world, device):
    import torch.distributed as dist

    from dynamic_video_depth_tpu_torch.parallel import (
        DataParallelStep, Layout, MultiVideoDataParallel, MultiVideoOptimizer)

    kind = case["kind"]
    if kind == "place":
        # the refusal comes before any collective; the group then still
        # meets at the barrier
        dp = DataParallelStep(make_step(case["cfg"], case["init"], device))
        try:
            dp.place(case["batch"])
            out = {"error": None}
        except ValueError as exc:
            out = {"error": str(exc)}
        dist.barrier()
        return out
    # every rank starts from its own seed's nets: the broadcast must make
    # them equal
    step = make_step(case["cfg"], case["init"], device)
    with torch.no_grad():
        for p in step.net_sf.parameters():
            p.add_(1e-3 * rank)
    if kind == "dp":
        scheme = DataParallelStep(step)
        scheme.broadcast_state()
        batch = scheme.place(case["batch"])
    elif kind == "mvo":
        scheme = MultiVideoOptimizer(step)
        scheme.broadcast_state(0)
        batch = {k: v.to(device) for k, v in
                 _tensors(case["batches"][rank]).items()}
    else:  # "mvdp": videos x dp over the layout's rows
        layout = Layout(len(case["batches"]), world // len(case["batches"]),
                        "cpu")
        scheme = MultiVideoDataParallel(step, layout)
        scheme.broadcast_state(0)
        batch = scheme.place(case["batches"][layout.video(rank)])
    logs = run_steps(scheme, batch, case["schedule"])
    return {"logs": logs, "state": numpy_state(step)}


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in batch.items()}


def run(rank, world, init_file, cases_file, out_dir, devices=None,
        backend="gloo"):
    import torch.distributed as dist

    from dynamic_video_depth_tpu_torch.parallel import initialize_distributed

    device = torch.device(devices[rank] if devices else "cpu")
    torch.set_num_threads(THREADS)
    initialize_distributed(backend, "file://" + init_file, world, rank,
                           device)
    try:
        with open(cases_file, "rb") as f:
            cases = pickle.load(f)
        results = {name: run_case(case, rank, world, device)
                   for name, case in cases.items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
