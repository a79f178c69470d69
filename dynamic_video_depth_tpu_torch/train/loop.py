"""Epoch loop (counterpart of ``dynamic_video_depth_tpu/train/loop.py``;
reference models/netinterface.py:193-360).

Each epoch walks a random order of the training samples, or, at
``--batch_size`` above 1 without ``--no_batching``, of fixed same-gap
batches; the rng draws and the index mapping are the JAX trainer's, so both
visit the same pairs at the same seed. ``warm`` is ``epoch <= warm_sf``;
each batch carries its own Euler step count. Every
step's losses are fetched to the host once (one synchronisation per step)
and printed; a validation pass follows each epoch.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.batches import collate_batches, to_device

LOG_KEYS = ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss", "acc_reg")


def print_step(epoch: int, i: int, n: int, gap: int, warm: bool,
               logs: Dict[str, float], seconds: float) -> None:
    vals = " ".join(f"{k} {logs[k]:.6g}" for k in LOG_KEYS)
    print(f"epoch {epoch} step {i + 1}/{n} gap {gap} warm {int(warm)} "
          f"{vals} step_ms {1e3 * seconds:.2f}", flush=True)


class Trainer:
    """Drives the per-video optimization of a ``SceneFlowMotionFieldStep``."""

    def __init__(self, step, dataset_train, dataset_vali, opt,
                 on_epoch_end: Optional[Callable] = None):
        self.step = step
        self.dataset_train = dataset_train
        self.dataset_vali = dataset_vali
        self.opt = opt
        self.on_epoch_end = on_epoch_end
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

    def _fixed_groups(self, batch_size: int):
        """Same-gap sample groups of ``batch_size`` (a batch has one gap)."""
        ds = self.dataset_train
        by_gap: Dict[int, list] = {}
        for i in range(len(ds)):
            by_gap.setdefault(ds.gap_of(i), []).append(i)
        groups = []
        for _, idxs in sorted(by_gap.items()):
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

    def train(self, start_epoch: int = 1):
        for epoch in range(start_epoch, self.opt.epoch + 1):
            self.train_epoch(epoch)
            vali = self.validate()
            if vali is not None:
                print(f"epoch {epoch} vali_loss {vali:.6g}", flush=True)
            if self.on_epoch_end is not None:
                self.on_epoch_end(epoch, self)
        return self

    def train_epoch(self, epoch: int):
        warm = epoch <= self.opt.warm_sf
        device = self.step.device
        order = self.epoch_order(len(self.groups), self.opt.epoch_batches)
        for i, gi in enumerate(order):
            host = collate_batches([self.dataset_train[j]
                                    for j in self.groups[gi]])
            t0 = time.perf_counter()
            logs = self.step.train_step(to_device(host, device),
                                        steps=host["steps"], warm=warm)
            vals = torch.stack([logs[k] for k in LOG_KEYS]).tolist()
            seconds = time.perf_counter() - t0
            record = dict(zip(LOG_KEYS, vals), epoch=epoch, warm=warm,
                          gap=host["steps"], seconds=seconds)
            if not all(math.isfinite(v) for v in vals):
                raise FloatingPointError(
                    f"non-finite loss at epoch {epoch} step {i + 1}: {record}")
            self.history.append(record)
            print_step(epoch, i, len(order), host["steps"], warm, record,
                       seconds)

    def validate(self) -> Optional[float]:
        ds = self.dataset_vali
        if ds is None or len(ds) == 0:
            return None
        n = len(ds) if self.opt.vali_batches is None \
            else min(len(ds), self.opt.vali_batches)
        losses = [self.step.vali_step(to_device(ds[i], self.step.device))[1]
                  ["loss"] for i in range(n)]
        return float(torch.stack(losses).mean())
