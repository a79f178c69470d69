"""Epoch loop (counterpart of ``dynamic_video_depth_tpu/train/loop.py``;
reference models/netinterface.py:193-360).

Each epoch walks a random order of the training samples, or, at
``--batch_size`` above 1 without ``--no_batching``, of fixed same-gap
batches; the rng draws and the index mapping are the JAX trainer's, so both
visit the same pairs at the same seed (a resumed run restarts the rng at
the seed, as the JAX trainer does). ``warm`` is ``epoch <= warm_sf``; each
batch carries its own Euler step count. Every step's losses are fetched to
the host once (one synchronisation per step; with ``--log_grad_stats``
the gradient statistics ride along), printed and handed to the loggers,
whose ``TerminateOnNaN`` stops a run on a NaN; a validation pass
follows each epoch, and its logs with the epoch's wall time go to the
loggers' ``on_epoch_end``. ``visualize_fn`` sees every train batch after
its step and every validation frame with its prediction.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.batches import collate_batches, to_device
from ..runtime.loggers import ComposeLogger, LogCumulator, TerminateOnNaN

LOG_KEYS = ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss", "acc_reg")


def print_step(epoch: int, i: int, n: int, gap: int, warm: bool,
               logs: Dict[str, float], seconds: float) -> None:
    vals = " ".join(f"{k} {logs[k]:.6g}" for k in LOG_KEYS)
    print(f"epoch {epoch} step {i + 1}/{n} gap {gap} warm {int(warm)} "
          f"{vals} step_ms {1e3 * seconds:.2f}", flush=True)


def group_by_gap(dataset) -> Dict[int, list]:
    """Sample indices bucketed by frame gap (JAX train/loop.py:72-79), in
    index order within each gap."""
    by_gap: Dict[int, list] = {}
    for i in range(len(dataset)):
        by_gap.setdefault(dataset.gap_of(i), []).append(i)
    return by_gap


def vis_index(batch_idx: int, n_steps: int, vis_at_start: bool) -> int:
    """Visualization gate index (reference models/scene_flow_motion_field.py
    :216, models/video_base.py:52): the last ``vis_batches`` batches of an
    epoch by default (the index counts down from the end), the first ones
    with ``--vis_at_start``."""
    return batch_idx if vis_at_start else n_steps - batch_idx


class Trainer:
    """Drives the per-video optimization of a ``SceneFlowMotionFieldStep``.

    ``logger`` defaults to a cumulator and the NaN guard; ``on_epoch_end
    (epoch, trainer)`` runs after the loggers' epoch end."""

    def __init__(self, step, dataset_train, dataset_vali, opt,
                 logger: Optional[ComposeLogger] = None,
                 visualize_fn: Optional[Callable] = None,
                 on_epoch_end: Optional[Callable] = None):
        self.step = step
        self.dataset_train = dataset_train
        self.dataset_vali = dataset_vali
        self.opt = opt
        self.logger = logger if logger is not None else ComposeLogger(
            [LogCumulator(), TerminateOnNaN()])
        self.visualize_fn = visualize_fn
        self.on_epoch_end = on_epoch_end
        self.log_time = bool(getattr(opt, "log_time", False))
        self.rng = np.random.RandomState(opt.manual_seed or 0)
        batch_size = max(opt.batch_size, 1)
        if batch_size > 1 and not opt.no_batching:
            self.groups = self._fixed_groups(batch_size)
        else:
            self.groups = [(i,) for i in range(len(dataset_train))]
        if not self.groups:
            raise ValueError("no training batch: fewer pairs of one gap "
                             "than --batch_size")
        self.history: List[Dict[str, float]] = []
        self.start_epoch = 1  # a resumed run's entry sets its next epoch

    def _fixed_groups(self, batch_size: int):
        """Same-gap sample groups of ``batch_size`` (a batch has one gap)."""
        groups = []
        for _, idxs in sorted(group_by_gap(self.dataset_train).items()):
            idxs = list(self.rng.permutation(idxs))
            for k in range(0, len(idxs) - batch_size + 1, batch_size):
                groups.append(tuple(idxs[k:k + batch_size]))
        return groups

    def epoch_order(self, n: int, epoch_batches: Optional[int]):
        """One permutation, replaced by ``epoch_batches`` of repeated ones
        when that is given (the first draw is still made, as the JAX
        trainer makes it)."""
        order = self.rng.permutation(n)
        if epoch_batches is not None:
            reps = math.ceil(epoch_batches / max(n, 1))
            order = np.concatenate([self.rng.permutation(n)
                                    for _ in range(reps)])[:epoch_batches]
        return order

    def train(self, start_epoch: Optional[int] = None):
        opt = self.opt
        if start_epoch is None:
            start_epoch = self.start_epoch
        self.logger.set_params({
            "epochs": opt.epoch,
            "steps": opt.epoch_batches or len(self.groups)})
        self.logger.on_train_begin()
        try:
            if getattr(opt, "vali_at_start", False):
                # the initial model's validation, logged as epoch
                # start - 1 (reference: netinterface.py:348-352)
                e0 = max(start_epoch - 1, 0)
                self.logger.on_epoch_begin(e0)
                self.logger.on_epoch_end(e0, self.validate(e0))
            for epoch in range(start_epoch, opt.epoch + 1):
                t_epoch = time.perf_counter()
                self.logger.on_epoch_begin(epoch)
                self.train_epoch(epoch)
                t_train = time.perf_counter()
                vali_logs = self.validate(epoch)
                if "loss" in vali_logs:
                    print(f"epoch {epoch} vali_loss {vali_logs['loss']:.6g}",
                          flush=True)
                t_vali = time.perf_counter()
                vali_logs["epoch_time"] = t_vali - t_epoch
                self.logger.on_epoch_end(epoch, vali_logs)
                if self.log_time:
                    print(f"[epoch {epoch} phases] train "
                          f"{t_train - t_epoch:.1f}s vali "
                          f"{t_vali - t_train:.1f}s epoch-end "
                          f"{time.perf_counter() - t_vali:.1f}s", flush=True)
                if self.on_epoch_end is not None:
                    self.on_epoch_end(epoch, self)
        finally:
            self.logger.on_train_end()
        return self

    def train_epoch(self, epoch: int):
        warm = epoch <= self.opt.warm_sf
        device = self.step.device
        order = self.epoch_order(len(self.groups), self.opt.epoch_batches)
        t_data = time.perf_counter()
        for i, gi in enumerate(order):
            host = collate_batches([self.dataset_train[j]
                                    for j in self.groups[gi]])
            t0 = time.perf_counter()
            dev = to_device(host, device)
            logs = self.step.train_step(dev, steps=host["steps"], warm=warm)
            keys = LOG_KEYS + tuple(sorted(set(logs) - set(LOG_KEYS)))
            vals = dict(zip(keys, torch.stack([logs[k] for k in keys])
                            .tolist()))
            seconds = time.perf_counter() - t0
            record = dict(vals, epoch=epoch, warm=warm, gap=host["steps"],
                          seconds=seconds)
            self.history.append(record)
            print_step(epoch, i, len(order), host["steps"], warm, record,
                       seconds)
            batch_logs = dict(vals, size=len(self.groups[gi]),
                              data_time=t0 - t_data)
            if self.log_time:
                batch_logs["batch_time"] = seconds
            self.logger.on_batch_end(i, batch_logs)
            if self.visualize_fn is not None:
                self.visualize_fn("train", epoch, i, dev, host,
                                  n_steps=len(order))
            t_data = time.perf_counter()

    def validate(self, epoch: int = 0) -> Dict[str, float]:
        """The size-weighted mean disparity loss over the first
        ``--vali_batches`` frames: ``{'loss', 'size'}``, or ``{}`` without
        validation frames."""
        ds = self.dataset_vali
        if ds is None or len(ds) == 0:
            return {}
        n = len(ds) if self.opt.vali_batches is None \
            else min(len(ds), self.opt.vali_batches)
        losses, sizes = [], []
        for i in range(n):
            host = ds[i]
            dev = to_device(host, self.step.device)
            pred, logs = self.step.vali_step(dev)
            losses.append(logs["loss"])
            sizes.append(int(host["img"].shape[0]))
            if self.visualize_fn is not None:
                self.visualize_fn("vali", epoch, i, dev, host, n_steps=n,
                                  pred=pred)
        losses = np.asarray(torch.stack(losses).cpu(), np.float64)
        total = max(sum(sizes), 1)
        return {"loss": float(np.sum(losses * np.asarray(sizes)) / total),
                "size": total}
