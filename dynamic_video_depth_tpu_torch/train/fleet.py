"""Fleet training entry: ``python -m dynamic_video_depth_tpu_torch.train.fleet
--tracks a,b [--dp D] [the train entry's flags]`` (counterpart of the JAX
package's ``train_fleet.py``).

Optimizes several videos in lockstep, one video per row of ``--dp`` ranks
(``parallel/``): at ``--dp 1`` one video per rank with no collective in the
step, at ``--dp D`` each video's ``--batch_size`` pairs split in order over
its D ranks with the gradient all-reduce of ``DataParallelStep``. The entry
spawns its V x D worker processes itself (``torch.multiprocessing``), one
per card, ``cuda:0 ..`` (NCCL), or on ``--device cpu`` (gloo);
``--dist_backend gloo`` runs gloo on the cards. The kernels are built once,
before the workers start. The rendezvous is ``--init_url``, by default a
file in a fresh temporary directory.

As in ``train_fleet.py``:
- the layout must fit the cards, and at ``--dp`` above 1 ``--batch_size``
  must be a multiple of it;
- every video starts from rank 0's state; ``--resume -1`` restores each
  track's ``checkpoint.pt`` where one exists (the fleet then continues
  after the smallest epoch) and each track's best validation loss;
- each step draws its gap in proportion to the pairs the videos have of it
  and then, video after video, a pair (``--dp 1``: one pair per video
  whatever ``--batch_size`` says) or ``--batch_size`` pairs; every rank
  replays all of the fleet's draws from ``--manual_seed`` and keeps its
  own;
- rank 0 logs the fleet's mean losses (progress bar, ``epoch_loss.csv``,
  ``opt.json``) under ``--logdir`` (default ``./checkpoints/fleet``), and a
  non-finite loss on any rank stops every rank;
- after each epoch (and before the first with ``--vali_at_start``) each
  video validates on its first ``--vali_batches`` frames, and the first
  rank of its row writes ``<logdir>/<track>/vali_loss.csv``,
  ``checkpoint.pt`` and, on a better loss, ``best.pt`` (the reference's
  torch format).
Each rank also writes ``fleet_rank<r>.json``: its video, device, the kernel
launches of its run, its step times and per-step logs, and with
``--log_time`` the time and size of each of its reductions.

Scan dispatch (``--steps_per_dispatch`` other than 1) is refused; the
device batch cache, the static (gap, warm) buckets, dispatch retries and
the compilation cache of ``train_fleet.py`` have no counterpart here.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys
import tempfile
import time
from os.path import isfile, join
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import get_dataset
from ..data.batches import collate_batches, to_device
from ..ops import cuda as cuda_kernels
from ..parallel import (Layout, MultiVideoDataParallel, MultiVideoOptimizer,
                        initialize_distributed)
from ..parallel.mesh import BACKENDS
from ..parallel.multi_video import shard_bounds
from ..runtime.checkpoint import (load_checkpoint, read_best,
                                  read_checkpoint, save_checkpoint, save_opt)
from ..runtime.device import resolve_device
from ..runtime.loggers import (ComposeLogger, CsvLogger, LogCumulator,
                               ProgbarLogger)
from ..utils.printing import set_manual_seed
from .cli import build_parser as build_train_parser
from .loop import LOG_KEYS, group_by_gap, print_step
from .scene_flow_motion_field import Model


def build_parser():
    p = build_train_parser()
    p.prog = "python -m dynamic_video_depth_tpu_torch.train.fleet"
    a = p.add_argument
    a("--tracks", required=True, help="the videos, comma-separated")
    a("--dp", type=int, default=1, help="ranks per video (data parallel)")
    a("--dist_backend", choices=BACKENDS, default=None,
      help="default: nccl on cuda, gloo on the CPU")
    a("--init_url", default="",
      help="the rendezvous (file:// or tcp://); default a file in a fresh "
           "temporary directory")
    a("--steps_per_dispatch", type=int, default=1, help="only 1 is ported")
    return p


class FleetRank:
    """One rank's share of the fleet: its video's model and data, the
    fleet's draws, and (rank 0, or the first rank of a row) the logs and
    files."""

    def __init__(self, opt, tracks, layout: Layout, rank: int):
        self.opt, self.tracks = opt, tracks
        self.layout, self.rank = layout, rank
        self.video = layout.video(rank)
        self.data_index = layout.data_index(rank)
        self.device = layout.device(rank)
        self.writer = self.data_index == 0
        self.logdir = opt.logdir or "./checkpoints/fleet"
        dataset = get_dataset(opt.dataset)
        self.datasets, self.vali_sets = [], []
        for t in tracks:
            o = copy.copy(opt)
            o.track_id = t
            self.datasets.append(dataset(o, "train"))
            self.vali_sets.append(dataset(o, "vali"))
            if t == tracks[self.video]:
                self.model = Model(o, device=self.device,
                                   seed=opt.manual_seed or 0)
        step = self.model.step
        if layout.dp > 1:
            self.fleet = MultiVideoDataParallel(step, layout,
                                                timed=opt.log_time)
        else:
            self.fleet = MultiVideoOptimizer(step)
        self.fleet.broadcast_state(0)
        self.best = float("inf")
        self.start_epoch = self._resume()
        self.records, self.step_ms = [], []
        self.logger = self._loggers()

    def _resume(self) -> int:
        """``--resume -1``: each track's ``checkpoint.pt`` where one exists
        (JAX train_fleet.py:132-152, 186-196); the fleet continues after
        the smallest epoch."""
        if self.opt.resume != -1:
            return 1
        epochs = []
        for t in self.tracks:
            p = join(self.logdir, t, "checkpoint.pt")
            epochs.append(int(read_checkpoint(p, mmap=True).get("epoch", 0))
                          if isfile(p) else 0)
        if not any(epochs):
            return 1
        track = self.tracks[self.video]
        p = join(self.logdir, track, "checkpoint.pt")
        if isfile(p):
            load_checkpoint(p, self.model.step)
        start = min(epochs) + 1
        if start > 1:
            best = read_best(join(self.logdir, track, "best.pt"))
            if best is not None:
                self.best = best
        if self.rank == 0:
            print(f"Resumed fleet at epoch {start - 1}", flush=True)
        return start

    def _loggers(self) -> ComposeLogger:
        """Rank 0 logs the fleet: progress and ``epoch_loss.csv`` (the NaN
        guard is ``_fleet_mean``'s, on every rank); the other ranks log
        nothing."""
        opt = self.opt
        if self.rank != 0:
            return ComposeLogger([])
        os.makedirs(self.logdir, exist_ok=True)
        save_opt(self.logdir, opt)
        cumulator = LogCumulator()
        return ComposeLogger([
            cumulator, ProgbarLogger(interval=opt.progbar_interval),
            CsvLogger(join(self.logdir, "epoch_loss.csv"), cumulator)])

    def _fleet_mean(self, values: torch.Tensor) -> torch.Tensor:
        """The mean over the videos of a vector that every rank of a row
        holds alike (one all-reduce over the world; each row's first rank
        contributes), and the count of non-finite values on any rank, last.
        A non-finite count stops every rank together."""
        mine = values if self.writer else torch.zeros_like(values)
        flag = (~torch.isfinite(values)).sum().to(values.dtype)
        packed = torch.cat([mine, flag[None]])
        torch.distributed.all_reduce(packed)
        if packed[-1].item() > 0:
            raise FloatingPointError(
                "a non-finite loss in the fleet: every rank stops")
        return packed[:-1] / self.layout.n_videos

    def _draws(self, rng, orders, gaps, gap_probs, bsz: int):
        """One step's draws for the whole fleet (JAX train_fleet.py:307,
        339-349): the gap, then the pairs video after video; this rank's
        share of its video's."""
        gap = gaps[rng.choice(len(gaps), p=gap_probs)]
        n_videos, dp = self.layout.n_videos, self.layout.dp
        if dp > 1:
            idx = [[orders[v][gap][rng.randint(len(orders[v][gap]))]
                    for _ in range(bsz)] for v in range(n_videos)]
            lo, hi = shard_bounds(bsz, dp, self.data_index)
            return idx[self.video][lo:hi]
        idx = [orders[v][gap][rng.randint(len(orders[v][gap]))]
               for v in range(n_videos)]
        return [idx[self.video]]

    def validate_and_save(self, epoch: int) -> None:
        """Each video's mean validation loss over its first frames, the
        fleet's mean to the loggers, then the track's files (JAX
        train_fleet.py:254-292)."""
        opt, step = self.opt, self.model.step
        n_vali = min(min(len(v) for v in self.vali_sets),
                     opt.vali_batches or 10 ** 9)
        ds = self.vali_sets[self.video]
        loss = np.zeros(1)
        for fi in range(n_vali):
            _, logs = self.fleet.vali_step(to_device(ds[fi], self.device))
            loss += (np.asarray([logs["loss"].item()], np.float32)
                     / max(n_vali, 1))
        mean = self._fleet_mean(torch.tensor(loss, dtype=torch.float64,
                                             device=self.device))
        self.logger.on_epoch_end(epoch, {"loss": float(mean[0])})
        if not self.writer:
            return
        track_dir = join(self.logdir, self.tracks[self.video])
        os.makedirs(track_dir, exist_ok=True)
        hist = join(track_dir, "vali_loss.csv")
        new_file = not isfile(hist)
        with open(hist, "a") as f:
            if new_file:
                f.write("epoch,vali_loss\n")
            f.write(f"{epoch},{float(loss[0]):.8g}\n")
        save_checkpoint(join(track_dir, "checkpoint.pt"), step, epoch=epoch,
                        best=self.best)
        if loss[0] < self.best:
            self.best = float(loss[0])
            save_checkpoint(join(track_dir, "best.pt"), step, epoch=epoch,
                            best=self.best)

    def train(self) -> None:
        opt = self.opt
        n_videos = self.layout.n_videos
        orders = [group_by_gap(ds) for ds in self.datasets]
        gaps = sorted(set.intersection(*[set(o) for o in orders]))
        counts = np.array([sum(len(o[g]) for o in orders) for g in gaps],
                          np.float64)
        gap_probs = counts / counts.sum()
        rng = np.random.RandomState(opt.manual_seed or 0)
        dataset = self.datasets[self.video]
        self.logger.set_params({"epochs": opt.epoch,
                                "steps": opt.epoch_batches
                                or len(self.datasets[0])})
        self.logger.on_train_begin()
        cuda_kernels.reset_launches()
        try:
            if opt.vali_at_start:
                e0 = max(self.start_epoch - 1, 0)
                self.logger.on_epoch_begin(e0)
                self.validate_and_save(e0)
            for epoch in range(self.start_epoch, opt.epoch + 1):
                warm = epoch <= opt.warm_sf
                self.logger.on_epoch_begin(epoch)
                n_steps = opt.epoch_batches or min(len(d)
                                                   for d in self.datasets)
                for it in range(n_steps):
                    mine = self._draws(rng, orders, gaps, gap_probs,
                                       opt.batch_size)
                    t0 = time.perf_counter()
                    host = collate_batches([dataset[j] for j in mine])
                    logs = self.fleet.train_step(
                        to_device(host, self.device), host["steps"], warm)
                    keys = LOG_KEYS + tuple(sorted(set(logs) - set(LOG_KEYS)))
                    local = torch.stack([logs[k] for k in keys])
                    mean = dict(zip(keys, self._fleet_mean(local).tolist()))
                    ms = 1e3 * (time.perf_counter() - t0)
                    self.step_ms.append(ms)
                    self.records.append(dict(
                        zip(keys, local.tolist()), epoch=epoch, step=it,
                        gap=host["steps"], warm=warm, ms=ms))
                    if self.rank == 0:
                        print_step(epoch, it, n_steps, host["steps"], warm,
                                   mean, ms / 1e3)
                    self.logger.on_batch_end(it, dict(mean, size=n_videos))
                self.validate_and_save(epoch)
        finally:
            self.logger.on_train_end()
        if self.rank == 0:
            print(f"fleet of {n_videos} videos done; checkpoints under "
                  f"{self.logdir}/<track>/", flush=True)

    def summary(self) -> dict:
        reductions = getattr(self.fleet, "reductions", [])
        return {
            "rank": self.rank, "video": self.video,
            "track": self.tracks[self.video],
            "data_index": self.data_index, "device": str(self.device),
            "backend": torch.distributed.get_backend(),
            "launches": cuda_kernels.launch_counts(),
            "variants": [[list(key), n] for key, n in
                         sorted(cuda_kernels.launch_variants().items(),
                                key=str)],
            "step_ms": self.step_ms, "records": self.records,
            "reductions": [list(r) for r in reductions],
        }


def _rank_main(rank: int, opt, tracks, init_url: str) -> None:
    """One worker: join the process group, train, write its summary."""
    layout = Layout(len(tracks), max(opt.dp, 1),
                    resolve_device(opt.device).type)
    device = layout.device(rank)
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // layout.world_size))
    if opt.manual_seed is not None:
        set_manual_seed(opt.manual_seed)
    initialize_distributed(opt.dist_backend, init_url, layout.world_size,
                           rank, device)
    try:
        fleet = FleetRank(opt, tracks, layout, rank)
        fleet.train()
        os.makedirs(fleet.logdir, exist_ok=True)
        with open(join(fleet.logdir, f"fleet_rank{rank}.json"), "w") as f:
            json.dump(fleet.summary(), f, indent=1)
    finally:
        torch.distributed.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Check the layout and flags, build the kernels, run the fleet's
    workers; returns the logdir and every rank's summary."""
    argv = list(sys.argv[1:] if argv is None else argv)
    opt = build_parser().parse_args(argv)
    tracks = opt.tracks.split(",")
    if "--track_id" not in argv:
        opt.track_id = tracks[0]
    if opt.steps_per_dispatch != 1:
        raise NotImplementedError(
            "not ported: --steps_per_dispatch other than 1 (scan dispatch); "
            "the fleet takes one step a dispatch")
    dp = max(opt.dp, 1)
    device = resolve_device(opt.device)
    layout = Layout(len(tracks), dp, device.type)
    if dp > 1 and opt.batch_size % dp != 0:
        # no silent bump: another batch changes the optimization
        sys.exit(f"--batch_size {opt.batch_size} must be a multiple of --dp "
                 f"{dp} (each video's pair batch splits over its data "
                 f"ranks); pass e.g. --batch_size {dp}")
    if device.type == "cuda":
        cuda_kernels.build_all()
    logdir = opt.logdir or "./checkpoints/fleet"
    tmp = None
    init_url = opt.init_url
    if not init_url:
        tmp = tempfile.mkdtemp(prefix="dvd_fleet_")
        init_url = "file://" + join(tmp, "rendezvous")
    try:
        torch.multiprocessing.spawn(_rank_main,
                                    args=(opt, tracks, init_url),
                                    nprocs=layout.world_size, join=True)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    ranks = []
    for r in range(layout.world_size):
        with open(join(logdir, f"fleet_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return {"logdir": logdir, "ranks": ranks}


if __name__ == "__main__":
    main()
