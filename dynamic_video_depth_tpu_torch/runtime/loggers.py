"""Keras-style callback loggers (counterpart of
``dynamic_video_depth_tpu/runtime/loggers.py``; reference
loggers/loggers.py).

The protocol and the files are the JAX package's, so CSV consumers and the
HTML dashboard keep working:

- ``epoch_loss.csv`` with size-weighted epoch means, and its columns merged
  across a resume;
- ``batch_loss.csv`` (``--log_batch``), a row per batch as it arrives;
- best and periodic checkpoint hooks (``ModelSaveLogger``);
- the NaN guard (``TerminateOnNaN``);
- TensorBoard scalars with train/vali suffixes (``--tensorboard``), its
  writer imported when training begins; without it, one warning and no
  event files;
- the HTML progress page (``--html_logger``), its history kept across a
  resume;
- ``ComposeLogger``, which fans out to all of the above.

Batch logs may hold 0-d tensors; they become floats where they are read.
"""

from __future__ import annotations

import csv
import math
import os
import time
from os.path import join
from typing import Dict, List, Optional

import numpy as np


def _scalar(v):
    """A float from a Python number, a numpy value or a 0-d tensor."""
    try:
        return float(v)
    except TypeError:
        return float(np.asarray(v))


class BaseLogger:
    """(reference: loggers/loggers.py:25-85)"""

    def __init__(self):
        self.params = {}
        self.model = None

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self):
        pass

    def on_train_end(self):
        pass

    def on_epoch_begin(self, epoch):
        pass

    def on_epoch_end(self, epoch, logs: Optional[Dict] = None):
        pass

    def on_batch_begin(self, batch):
        pass

    def on_batch_end(self, batch, logs: Optional[Dict] = None):
        pass

    def train_begin(self):
        self.on_train_begin()

    def train_end(self):
        self.on_train_end()


class LogCumulator(BaseLogger):
    """Size-weighted epoch means (reference: loggers/loggers.py:88-110)."""

    def __init__(self):
        super().__init__()
        self.epoch_logs = {}
        self._sizes = []
        self._values: Dict[str, List[float]] = {}

    def on_epoch_begin(self, epoch):
        self._sizes = []
        self._values = {}

    def on_batch_end(self, batch, logs=None):
        logs = logs or {}
        size = int(logs.get("size", 1))
        self._sizes.append(size)
        for k, v in logs.items():
            if k == "size":
                continue
            # pair each value with ITS batch's size: a metric absent from
            # some batches (mixed log paths) must weight by the sizes of the
            # batches that actually logged it, not positionally by the first
            # n sizes (which silently mis-weights and under-normalizes)
            self._values.setdefault(k, []).append((v, size))

    def get_epoch_logs(self):
        out = {}
        for k, pairs in self._values.items():
            vals = np.asarray([_scalar(v) for v, _ in pairs], np.float64)
            sizes = np.asarray([s for _, s in pairs], np.float64)
            total = sizes.sum() if len(sizes) else 1.0
            out[k] = float((vals * sizes).sum() / total)
        return out

    def on_epoch_end(self, epoch, logs=None):
        self.epoch_logs = self.get_epoch_logs()
        # epoch-end logs (validation metrics) ride along with a vali_ prefix,
        # mirroring the reference's train/vali CSV+TB split
        for k, v in (logs or {}).items():
            if k != "size":
                self.epoch_logs[f"vali_{k}"] = _scalar(v)


class ProgbarLogger(BaseLogger):
    """Terminal progress bar with ETA (reference: loggers/Progbar.py:21-143)."""

    def __init__(self, interval: float = 0.05, metrics: Optional[List[str]] = None,
                 no_accum: bool = False):
        super().__init__()
        self.interval = interval
        self.metrics = metrics
        # --no_accum: display the CURRENT batch's value instead of the
        # running epoch mean (reference: loggers/Progbar.py:105-108)
        self.no_accum = no_accum
        self._last = 0.0

    def on_epoch_begin(self, epoch):
        self.epoch = epoch
        self.seen = 0
        self.start = time.time()
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._step_values: Dict[str, float] = {}
        print(f"Epoch {epoch}/{self.params.get('epochs', '?')}")

    def on_batch_end(self, batch, logs=None):
        logs = logs or {}
        self.seen += 1
        # size-weighted running means, like the reference's Progbar
        # (reference: loggers/Progbar.py:43-143)
        size = int(logs.get("size", 1))
        for k, v in logs.items():
            if k == "size" or (self.metrics and k not in self.metrics):
                continue
            self._sums[k] = self._sums.get(k, 0.0) + _scalar(v) * size
            self._counts[k] = self._counts.get(k, 0) + size
            if self.no_accum:
                self._step_values[k] = _scalar(v)
        now = time.time()
        if now - self._last < self.interval:
            return
        self._last = now
        self._render(final=False)

    def _render(self, final: bool):
        target = self.params.get("steps", None)
        elapsed = time.time() - self.start
        rate = self.seen / max(elapsed, 1e-9)
        if target:
            eta = (target - self.seen) / max(rate, 1e-9)
            frac = self.seen / target
            width = 30
            filled = int(width * frac)
            bar = "=" * filled + (">" if filled < width else "") + "." * (width - filled - 1)
            head = f"\r{self.seen}/{target} [{bar}] ETA {eta:5.0f}s"
        else:
            head = f"\r{self.seen} [{elapsed:5.0f}s]"
        if self.no_accum:
            stats = " - ".join(
                f"{k}: {self._step_values[k]:.4g}"
                for k in sorted(self._step_values)
            )
        else:
            stats = " - ".join(
                f"{k}: {self._sums[k] / max(self._counts[k], 1):.4g}"
                for k in sorted(self._sums)
            )
        end = "\n" if final else ""
        print(head + " " + stats + " " * 8, end=end, flush=True)

    def on_epoch_end(self, epoch, logs=None):
        self._render(final=True)


class CsvLogger(BaseLogger):
    """Epoch-level CSV (reference: loggers/loggers.py:180-222)."""

    def __init__(self, filepath: str, cumulator: LogCumulator):
        super().__init__()
        self.filepath = filepath
        self.cumulator = cumulator
        self._writer = None
        self._file = None
        self._keys = None

    def on_train_begin(self):
        os.makedirs(os.path.dirname(self.filepath), exist_ok=True)
        # an empty file (e.g. a run that crashed before its first epoch)
        # counts as fresh — appending to it would produce a headerless CSV
        self._resume_keys = None
        exists = (os.path.isfile(self.filepath)
                  and os.path.getsize(self.filepath) > 0)
        if exists:
            with open(self.filepath, newline="") as f:
                header = f.readline().strip()
            self._resume_keys = header.split(",") if header else None
        self._file = open(self.filepath, "a", newline="")
        self._writer = None
        self._append = exists and self._resume_keys is not None

    def _rewrite_merged(self, new_keys):
        """Rewrite the file with the merged header (existing columns first,
        new ones appended) so neither old rows nor new metrics are lost —
        used both across resumes and mid-run when the metric set grows
        (e.g. a --vali_at_start row precedes the first training epoch)."""
        merged = list(self._keys) + sorted(set(new_keys) - set(self._keys))
        self._file.close()
        with open(self.filepath, newline="") as f:
            old_rows = list(csv.DictReader(f))
        with open(self.filepath, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=merged, extrasaction="ignore")
            w.writeheader()
            w.writerows(old_rows)
        self._file = open(self.filepath, "a", newline="")
        self._keys = merged
        self._writer = csv.DictWriter(self._file, fieldnames=self._keys,
                                      extrasaction="ignore")

    def on_epoch_end(self, epoch, logs=None):
        logs = dict(self.cumulator.epoch_logs)
        logs["epoch"] = epoch
        if self._writer is None:
            self._keys = sorted(logs.keys())
            if self._append and self._resume_keys:
                if set(self._keys) != set(self._resume_keys):
                    print(f"Warning: resumed CSV {self.filepath} columns "
                          f"changed; rewriting with merged header")
                    old = self._keys
                    self._keys = list(self._resume_keys)
                    self._rewrite_merged(old)
                else:
                    self._keys = self._resume_keys
            if self._writer is None:
                self._writer = csv.DictWriter(
                    self._file, fieldnames=self._keys, extrasaction="ignore")
                if not self._append:
                    self._writer.writeheader()
        elif not set(logs) <= set(self._keys):
            self._rewrite_merged(sorted(logs.keys()))
        self._writer.writerow(logs)
        self._file.flush()

    def on_train_end(self):
        if self._file:
            self._file.close()


class BatchCsvLogger(BaseLogger):
    """Per-batch CSV (reference: loggers/loggers.py:225-256).

    Rows are written (and flushed) as they arrive, like the reference — a
    NaN abort mid-epoch must leave the trace UP TO the failing batch on
    disk, which is exactly the data needed to debug the divergence."""

    def __init__(self, filepath: str):
        super().__init__()
        self.filepath = filepath
        self.epoch = 0
        self._file = None
        self._writer = None

    def on_epoch_begin(self, epoch):
        self.epoch = epoch

    def on_batch_end(self, batch, logs=None):
        row = {k: _scalar(v) for k, v in (logs or {}).items()}
        row.update(epoch=self.epoch, batch=batch)
        if self._writer is None:
            os.makedirs(os.path.dirname(self.filepath), exist_ok=True)
            exists = (os.path.isfile(self.filepath)
                      and os.path.getsize(self.filepath) > 0)
            self._file = open(self.filepath, "a", newline="")
            self._writer = csv.DictWriter(
                self._file, fieldnames=sorted(row.keys()),
                extrasaction="ignore",
            )
            if not exists:
                self._writer.writeheader()
        self._writer.writerow(row)
        self._file.flush()

    def on_train_end(self):
        if self._file:
            self._file.close()
            self._file = None
            self._writer = None


class TerminateOnNaN(BaseLogger):
    """Abort on NaN metrics (reference: loggers/loggers.py:309-322).

    Batch-level like the reference: the trainer hands over host floats,
    fetched once per step, so the check costs no extra synchronisation.
    Tensors in a batch's logs are only checked at epoch end."""

    def __init__(self):
        super().__init__()
        self.stopped = False

    def _check(self, logs, where):
        for k, v in (logs or {}).items():
            if isinstance(v, (float, int, np.floating, np.integer)):
                val = float(v)
                # NaN only, like the reference (its isinf check is
                # deliberately commented out, reference loggers/loggers.py:
                # 309-322): a transient inf metric must not kill a long run.
                if math.isnan(val):
                    self.stopped = True
                    raise FloatingPointError(
                        f"NaN metric {k}={val} at {where}; terminating."
                    )

    def on_batch_end(self, batch, logs=None):
        self._check(logs, f"batch {batch}")

    def on_epoch_end(self, epoch, logs=None):
        logs = {k: _scalar(v) for k, v in (logs or {}).items()}
        self._check(logs, f"epoch {epoch}")


class ModelSaveLogger(BaseLogger):
    """Periodic + best checkpointing (reference: loggers/loggers.py:259-306).

    ``save_fn(path)`` is provided by the trainer; this logger decides when.
    """

    def __init__(self, save_fn, filepath: str, period: int = 1,
                 save_best_only: bool = False,
                 cumulator: Optional[LogCumulator] = None,
                 best_holder: Optional[dict] = None):
        super().__init__()
        self.save_fn = save_fn
        self.filepath = filepath
        self.period = period
        self.save_best_only = save_best_only
        self.cumulator = cumulator
        # shared across the periodic/best loggers of one run so every
        # checkpoint records the true best; seeded from best.pt on resume
        # (the reference reloads prev_best from best.pt, train.py:150-165)
        self._best = best_holder if best_holder is not None else {"best": float("inf")}

    @property
    def best(self) -> float:
        return self._best["best"]

    @best.setter
    def best(self, value: float):
        self._best["best"] = value

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or (self.cumulator.epoch_logs if self.cumulator else {})
        if self.save_best_only:
            loss = _scalar(logs.get("loss", float("inf")))
            if loss < self.best:
                self.best = loss
                self.save_fn(self.filepath, epoch=epoch, best=self.best)
        elif epoch % self.period == 0:
            path = self.filepath
            if "%" in path:
                path = path % epoch
            self.save_fn(path, epoch=epoch, best=self.best)


class TensorBoardLogger(BaseLogger):
    """TensorBoard scalars under train/vali suffixes
    (reference: loggers/loggers.py:325-373). The writer is imported when
    training begins; where it cannot be, one warning and nothing written."""

    def __init__(self, logdir: str, cumulator: LogCumulator, suffix: str = "train"):
        super().__init__()
        self.logdir = logdir
        self.cumulator = cumulator
        self.suffix = suffix
        self._writer = None

    def on_train_begin(self):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(self.logdir)
        except Exception as e:  # tensorboard is an optional dependency
            self._writer = None
            print(f"Warning: TensorBoard writer unavailable ({e}); no event "
                  f"files are written to {self.logdir}", flush=True)

    def on_epoch_end(self, epoch, logs=None):
        if self._writer is None:
            return
        for k, v in self.cumulator.epoch_logs.items():
            self._writer.add_scalar(f"{k}/{self.suffix}", _scalar(v), epoch)
        self._writer.flush()

    def on_train_end(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class HtmlLogger(BaseLogger):
    """Minimal HTML progress dashboard (reference: loggers/loggers.py:376-442):
    a json progress file plus one html page per epoch listing metric tables."""

    def __init__(self, logdir: str, cumulator: LogCumulator):
        super().__init__()
        self.logdir = logdir
        self.cumulator = cumulator
        self.history = []

    def on_train_begin(self):
        # seed from a previous run's progress.json so a --resume keeps the
        # dashboard's full epoch history instead of erasing it
        import json

        path = join(self.logdir, "progress.json")
        if not self.history and os.path.isfile(path):
            try:
                with open(path) as f:
                    self.history = list(json.load(f))
            except (json.JSONDecodeError, OSError):
                pass

    def on_epoch_end(self, epoch, logs=None):
        import json

        os.makedirs(self.logdir, exist_ok=True)
        entry = {"epoch": epoch, **{k: _scalar(v) for k, v in
                                     self.cumulator.epoch_logs.items()}}
        self.history.append(entry)
        with open(join(self.logdir, "progress.json"), "w") as f:
            json.dump(self.history, f, indent=1)
        # stable column order across epochs: union of keys, epoch first
        cols = ["epoch"] + sorted(
            {k for e in self.history for k in e} - {"epoch"}
        )
        rows = "".join(
            "<tr>" + "".join(f"<td>{e.get(k, '')}</td>" for k in cols)
            + "</tr>"
            for e in self.history
        )
        header = "".join(f"<th>{k}</th>" for k in cols)
        with open(join(self.logdir, "progress.html"), "w") as f:
            f.write(
                "<html><body><table border=1>"
                f"<tr>{header}</tr>{rows}</table></body></html>"
            )


class ComposeLogger(BaseLogger):
    """Fan-out (reference: loggers/loggers.py:445-515)."""

    def __init__(self, loggers: List[BaseLogger]):
        super().__init__()
        self.loggers = list(loggers)

    def add_logger(self, logger: BaseLogger):
        self.loggers.append(logger)

    def get_logger(self, cls):
        for lg in self.loggers:
            if isinstance(lg, cls):
                return lg
        return None

    def set_params(self, params):
        for lg in self.loggers:
            lg.set_params(params)

    def on_train_begin(self):
        for lg in self.loggers:
            lg.on_train_begin()

    def on_train_end(self):
        for lg in self.loggers:
            lg.on_train_end()

    def on_epoch_begin(self, epoch):
        for lg in self.loggers:
            lg.on_epoch_begin(epoch)

    def on_epoch_end(self, epoch, logs=None):
        for lg in self.loggers:
            lg.on_epoch_end(epoch, logs)

    def on_batch_begin(self, batch):
        for lg in self.loggers:
            lg.on_batch_begin(batch)

    def on_batch_end(self, batch, logs=None):
        for lg in self.loggers:
            lg.on_batch_end(batch, logs)
