"""Epoch loop (counterpart of ``dynamic_video_depth_tpu/train/loop.py``;
reference models/netinterface.py:193-360).

Each epoch walks a random order of the training samples, or, at
``--batch_size`` above 1 without ``--no_batching``, of fixed same-gap
batches; the rng draws and the index mapping are the JAX trainer's, so both
visit the same pairs at the same seed (a resumed run restarts the rng at
the seed, as the JAX trainer does). ``warm`` is ``epoch <= warm_sf``; each
batch carries its own Euler step count.

The data path is the JAX trainer's: a reader thread loads, collates and
pins the next batches (``data.prefetch.BatchLoader``); the batches stay on
the card after their first use (``DeviceCache``, for the validation frames
too) unless ``--no_device_cache``, which copies them one step ahead on a
side stream instead (``DevicePrefetcher``). Each step's losses (and with
``--log_grad_stats`` the gradient statistics) are stacked on the card and
copied to pinned host memory without waiting; the host reads them up to
``LOG_PIPELINE_DEPTH`` steps later, in step order, and at the epoch's end.
Only then are they printed, kept in ``history`` and handed to the loggers,
whose ``TerminateOnNaN`` therefore stops a run up to that many steps after
a NaN, as in the JAX trainer. A step's ``seconds`` in ``history`` is its
span on the device clock, from an event recorded before its first launch
to one recorded after its last (the host clock on the CPU); ``interval``
runs from the previous step's end event, data waits included, and
``data_time`` is the host's wait for the batch.

With ``--profile_dir`` epoch ``min(2, --epoch)`` runs under
``runtime.profiling.trace_if`` (``<profile_dir>/trace.json``); the data
wait, the step (with the step's own spans inside it) and the log flush
are named spans there. A validation pass
follows each epoch, and its logs with the epoch's wall time go to the
loggers' ``on_epoch_end``. ``visualize_fn`` sees every train batch after
its step and every validation frame with its prediction.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.batches import collate_batches
from ..data.prefetch import BatchLoader, DeviceCache, DevicePrefetcher
from ..runtime.loggers import ComposeLogger, LogCumulator, TerminateOnNaN
from ..runtime.profiling import annotate, trace_if

LOG_KEYS = ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss", "acc_reg")
LOG_PIPELINE_DEPTH = 16


def print_step(epoch: int, i: int, n: int, gap: int, warm: bool,
               logs: Dict[str, float], seconds: float) -> None:
    vals = " ".join(f"{k} {logs[k]:.6g}" for k in LOG_KEYS)
    print(f"epoch {epoch} step {i + 1}/{n} gap {gap} warm {int(warm)} "
          f"{vals} step_ms {1e3 * seconds:.2f}", flush=True)


def group_by_gap(dataset) -> Dict[int, list]:
    """Sample indices bucketed by frame gap (JAX train/loop.py:72-79), in
    index order within each gap, over the dataset's files (its
    ``file_list``: ``--repeat`` adds no index)."""
    n = len(getattr(dataset, "file_list", dataset))
    by_gap: Dict[int, list] = {}
    for i in range(n):
        by_gap.setdefault(dataset.gap_of(i), []).append(i)
    return by_gap


def vis_index(batch_idx: int, n_steps: int, vis_at_start: bool) -> int:
    """Visualization gate index (reference models/scene_flow_motion_field.py
    :216, models/video_base.py:52): the last ``vis_batches`` batches of an
    epoch by default (the index counts down from the end), the first ones
    with ``--vis_at_start``."""
    return batch_idx if vis_at_start else n_steps - batch_idx


class GroupedDataset:
    """Indexable view collating fixed groups of same-gap samples (JAX
    ``_GroupedDataset``)."""

    def __init__(self, dataset, groups):
        self.dataset = dataset
        self.groups = groups

    def __len__(self):
        return len(self.groups)

    def __getitem__(self, gi: int):
        return collate_batches([self.dataset[i] for i in self.groups[gi]])


class _PendingLogs:
    """One step's logs on their way to the host: the stacked values (a
    pinned host copy on the card, with the events of the step's start and
    end), and what the flush adds to them."""

    def __init__(self, logs: Dict[str, torch.Tensor], start, meta: dict):
        self.keys = LOG_KEYS + tuple(sorted(set(logs) - set(LOG_KEYS)))
        stacked = torch.stack([logs[k] for k in self.keys])
        self.start, self.meta = start, meta
        if start is None:  # the CPU: the values are already there
            self.values, self.end = stacked, time.perf_counter()
            return
        self.values = torch.empty(stacked.shape, dtype=stacked.dtype,
                                  pin_memory=True)
        self.values.copy_(stacked, non_blocking=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.end.record()

    def read(self, prev_end):
        """(values by key, seconds, interval) once the copy has landed."""
        if self.start is None:
            seconds = self.end - self.meta["t_host"]
            interval = self.end - (prev_end if prev_end is not None
                                   else self.meta["t_host"])
        else:
            self.end.synchronize()
            seconds = self.start.elapsed_time(self.end) / 1e3
            interval = (prev_end if prev_end is not None
                        else self.start).elapsed_time(self.end) / 1e3
        return dict(zip(self.keys, self.values.tolist())), seconds, interval


class Trainer:
    """Drives the per-video optimization of a ``SceneFlowMotionFieldStep``.

    ``logger`` defaults to a cumulator and the NaN guard; ``on_epoch_end
    (epoch, trainer)`` runs after the loggers' epoch end. ``train_source``
    and ``vali_source`` are what the epochs read: the grouped training view
    and the validation frames, each in a ``DeviceCache`` unless
    ``--no_device_cache``."""

    def __init__(self, step, dataset_train, dataset_vali, opt,
                 logger: Optional[ComposeLogger] = None,
                 visualize_fn: Optional[Callable] = None,
                 on_epoch_end: Optional[Callable] = None):
        self.step = step
        self.device = torch.device(step.device)
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
        self.train_source = GroupedDataset(dataset_train, self.groups)
        self.vali_source = dataset_vali
        if not getattr(opt, "no_device_cache", False):
            self.train_source = DeviceCache(self.train_source, self.device)
            if dataset_vali is not None:
                self.vali_source = DeviceCache(dataset_vali, self.device)
        self.history: List[Dict[str, float]] = []
        self.start_epoch = 1  # a resumed run's entry sets its next epoch
        self._dead_mask_warned = False

    def _fixed_groups(self, batch_size: int):
        """Same-gap sample groups of ``batch_size`` (a batch has one gap)
        over the dataset's files (JAX ``_fixed_groups``)."""
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

    def iter_batches(self, source, order):
        """``(index, device tensors, host part)`` of ``source`` in
        ``order``: the reader thread, then the device cache or the
        one-ahead prefetcher."""
        if isinstance(source, DeviceCache):
            loader = iter(BatchLoader(source.dataset, order,
                                      device=self.device,
                                      skip=source.__contains__))
            try:
                for idx, batch in loader:
                    dev, host = source.get(idx, batch)
                    yield idx, dev, host
            finally:
                loader.close()
        else:
            yield from DevicePrefetcher(
                BatchLoader(source, order, device=self.device), self.device)

    def train(self, start_epoch: Optional[int] = None):
        opt = self.opt
        if start_epoch is None:
            start_epoch = self.start_epoch
        self.logger.set_params({
            "epochs": opt.epoch,
            "steps": opt.epoch_batches or len(self.groups)})
        self.logger.on_train_begin()
        profile_dir = getattr(opt, "profile_dir", None)
        # the second epoch when there is one (JAX train/loop.py:248-261):
        # the first carries cuDNN's algorithm search and the kernels' first
        # launches
        profile_epoch = min(2, opt.epoch or 1)
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
                with trace_if(profile_dir, epoch == profile_epoch):
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
        cuda = self.device.type == "cuda"
        order = self.epoch_order(len(self.groups), self.opt.epoch_batches)
        pending = collections.deque()
        self._prev_end = None
        batches = self.iter_batches(self.train_source, order)
        try:
            for i in range(len(order)):
                t_data = time.perf_counter()
                with annotate("dvd/data_wait"):
                    gi, dev, host = next(batches)
                t0 = time.perf_counter()
                start = None
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                with annotate("dvd/step"):
                    logs = self.step.train_step(dev, steps=host["steps"],
                                                warm=warm)
                    pending.append(_PendingLogs(logs, start, dict(
                        i=i, n=len(order), epoch=epoch, warm=warm,
                        gap=host["steps"], size=len(self.groups[gi]),
                        data_time=t0 - t_data, t_host=t0)))
                if len(pending) > LOG_PIPELINE_DEPTH:
                    self._flush(pending.popleft())
                if self.visualize_fn is not None:
                    self.visualize_fn("train", epoch, i, dev, host,
                                      n_steps=len(order))
            while pending:
                self._flush(pending.popleft())
        finally:
            batches.close()

    def _flush(self, entry: _PendingLogs) -> None:
        """One step's logs to ``history``, the console and the loggers."""
        with annotate("dvd/log_flush"):
            vals, seconds, interval = entry.read(self._prev_end)
            self._prev_end = entry.end
            m = entry.meta
            record = dict(vals, epoch=m["epoch"], warm=m["warm"],
                          gap=m["gap"], seconds=seconds, interval=interval,
                          data_time=m["data_time"])
            self.history.append(record)
            print_step(m["epoch"], m["i"], m["n"], m["gap"], m["warm"],
                       record, seconds)
            batch_logs = dict(vals, size=m["size"],
                              data_time=m["data_time"])
            if self.log_time:
                batch_logs["batch_time"] = seconds
            self._watch_dead_mask(vals)
            self.logger.on_batch_end(m["i"], batch_logs)

    def _watch_dead_mask(self, logs) -> None:
        """A main loss of exactly 0 with a flow loss of exactly 0: the
        occlusion x far-field mask has no mass anywhere (a random-weight
        MiDaS gives depth ~1e6, past the far-field cutoff of 100), so no
        gradient flows; warned once (JAX train/loop.py:376-393)."""
        if self._dead_mask_warned:
            return
        if logs.get("loss", 1.0) == 0.0 and \
                logs.get("flow_loss_1_2", 1.0) == 0.0:
            self._dead_mask_warned = True
            print("WARNING: training loss is exactly 0 - the occlusion/far-"
                  "field mask has zero mass (random-weight MiDaS depth > 100 "
                  "everywhere?). Training cannot make progress; load the "
                  "pretrained depth checkpoint or use --depth_net tiny for "
                  "smoke runs.", flush=True)

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
        batches = self.iter_batches(self.vali_source, range(n))
        try:
            for i, dev, host in batches:
                pred, logs = self.step.vali_step(dev)
                losses.append(logs["loss"])
                sizes.append(int(dev["img"].shape[0]))
                if self.visualize_fn is not None:
                    self.visualize_fn("vali", epoch, i, dev, host, n_steps=n,
                                      pred=pred)
        finally:
            batches.close()
        losses = np.asarray(torch.stack(losses).cpu(), np.float64)
        total = max(sum(sizes), 1)
        return {"loss": float(np.sum(losses * np.asarray(sizes)) / total),
                "size": total}
