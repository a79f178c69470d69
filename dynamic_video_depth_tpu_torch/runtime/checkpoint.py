"""Checkpoints and the run's option snapshot (counterpart of
``dynamic_video_depth_tpu/runtime/checkpoint.py``; reference
models/netinterface.py:528-562, train.py:150-186).

A checkpoint is the reference's torch format, the one the JAX package's
``runtime/migrate.py`` reads::

    {'nets': [depth_sd, sceneflow_sd],
     'optimizers': [depth_opt_sd, scene_opt_sd],  # absent: weights only
     'epoch': N, 'best': b}

The optimizer state dicts are torch's own: Adam's moments, or SGD's
momentum buffers under ``--optim sgd``; a resumed run rebuilds the
optimizer its ``opt.json`` names and loads them.

A run writes ``checkpoint.pt`` (every ``--save_every`` epochs and at its
last epoch), ``best.pt`` (on a better validation loss) and ``nets/%04d.pt``
(every ``--save_net`` epochs, weights only unless ``--save_net_opt``),
with ``opt.json`` and ``opt.txt`` beside them. Every file is written to a
temporary file in its directory and then renamed over the target.

``save_checkpoint`` writes synchronously (the fleet entry's saves, as the
JAX ``train_fleet.py`` makes them). The train entry saves through
``AsyncSaver`` (counterpart of the JAX ``AsyncSaver``, used as JAX
``train.py:181-200`` uses it): the caller clones the state on its device
once an epoch and queues the write; a writer thread copies the clone to
the host and writes the file. The file holds the same keys, dtypes and
values as ``save_checkpoint`` of that state, with every storage on the
CPU. A reader in this process (``read_checkpoint``, ``read_best``,
``wait_for``) first waits for the writes still queued to its path.
"""

from __future__ import annotations

import atexit
import collections
import copy
import json
import os
import queue
import tempfile
import threading
import time
import weakref
from typing import Dict, List, NamedTuple, Optional

import torch

from ..data.prefetch import explicit_device


def _atomic(path: str, write) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_checkpoint(path: str, step, epoch: int = 0,
                    best: float = float("inf"),
                    include_opt: bool = True) -> None:
    """Write a ``SceneFlowMotionFieldStep``'s nets (and, with
    ``include_opt``, both optimizers) to ``path`` atomically."""
    ckpt = {"nets": [step.net_depth.state_dict(), step.net_sf.state_dict()],
            "epoch": int(epoch), "best": float(best)}
    if include_opt:
        ckpt["optimizers"] = [o.state_dict() for o in step.optimizers]
    _atomic(path, lambda f: torch.save(ckpt, f))


def read_checkpoint(path: str, mmap: bool = False) -> Dict:
    """The checkpoint dict on the CPU (``mmap``: storages are mapped, not
    read, which suits reading one scalar out of a large file), once the
    writes queued to ``path`` have landed."""
    wait_for(path)
    return torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)


def load_checkpoint(path: str, step, load_optimizer="auto") -> Dict:
    """Load a reference-format checkpoint into ``step``: both nets with
    ``strict=True``, and both optimizers when the file has them (``'auto'``) or
    when ``load_optimizer`` is true (a file without them then raises).
    Returns the file's other entries (``epoch``, ``best``, ...)."""
    ckpt = read_checkpoint(path)
    nets = ckpt["nets"]
    if len(nets) != 2:
        raise ValueError(f"{path}: expected [net_depth, net_sceneflow], got "
                         f"{len(nets)} nets")
    step.net_depth.load_state_dict(nets[0], strict=True)
    step.net_sf.load_state_dict(nets[1], strict=True)
    if load_optimizer == "auto":
        load_optimizer = "optimizers" in ckpt
    if load_optimizer:
        for opt, sd in zip(step.optimizers, ckpt["optimizers"], strict=True):
            opt.load_state_dict(sd)
    return {k: v for k, v in ckpt.items() if k not in ("nets", "optimizers")}


def read_best(path: str) -> Optional[float]:
    """The ``best`` value recorded in a checkpoint, or ``None`` when the
    file is absent."""
    wait_for(path)
    if not os.path.isfile(path):
        return None
    return float(read_checkpoint(path, mmap=True).get("best", float("inf")))


class SaveRecord(NamedTuple):
    """One background save: the writer's seconds (device-to-host copy and
    write), the file's bytes and the caller's blocking seconds in ``save``
    (snapshot and enqueue, a wait for a queue slot included)."""

    path: str
    seconds: float
    bytes: int
    blocking: float


def _tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and tuples; other
    leaves are copied. A dict keeps its type and a state dict's
    ``_metadata``, so the saved pickle matches the original's."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        out = type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
        if hasattr(tree, "_metadata"):
            out._metadata = copy.deepcopy(tree._metadata)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return copy.deepcopy(tree)


_LIVE_SAVERS: "weakref.WeakSet" = weakref.WeakSet()


def wait_for(path: str) -> None:
    """Flush every live ``AsyncSaver`` that has a write queued to ``path``
    or, for a directory, below it (raising a write error it holds)."""
    for saver in list(_LIVE_SAVERS):
        if saver.writing(path):
            saver.flush()


class AsyncSaver:
    """Background checkpoint writer of a ``SceneFlowMotionFieldStep``.

    ``save`` clones the nets' state dicts (and, for a save with the
    optimizers, both optimizers' state dicts) on the caller's stream once
    a snapshot key (the epoch), records an event after the clone, and
    queues the write; torch's optimizers update in place, so the clone is
    what a later step cannot touch (the JAX trainer's undonated copy).
    Saves with the same key reuse the snapshot, and the writer copies it to
    the host once while they stay queued. The writer thread runs at the
    saver's explicit device: it waits for the event on a stream of its
    own, copies the tensors to the host and writes the file atomically.

    The queue holds ``QUEUE_SIZE`` saves (one epoch's ``checkpoint.pt``,
    ``best.pt`` and ``nets/%04d.pt`` with room to spare); a full queue
    blocks ``save`` and no save is dropped. A write that fails on the
    thread is raised on the caller's thread at the next ``save`` or
    ``flush``. ``flush`` waits for every queued write; ``close`` flushes
    and stops the thread (the next ``save`` starts another). At exit the
    queued writes get ``EXIT_DEADLINE_S`` seconds to land."""

    QUEUE_SIZE = 4
    EXIT_DEADLINE_S = 120.0

    def __init__(self, device):
        self.device = explicit_device(device)
        self.records: List[SaveRecord] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=self.QUEUE_SIZE)
        self._lock = threading.Lock()
        self._pending = collections.Counter()  # absolute path -> queued
        self._error: Optional[tuple] = None
        self._thread: Optional[threading.Thread] = None
        self._snap: Dict = {}
        self._host: Dict = {}
        _LIVE_SAVERS.add(self)

    # -- the caller's side
    def invalidate(self) -> None:
        """Drop the snapshot: the next save clones the state anew."""
        self._snap = {}

    def _snapshot(self, step, key, include_opt: bool) -> tuple:
        if self._snap.get("key", object()) != key:
            self._snap = {"key": key}
        snap = self._snap
        if "nets" not in snap:
            snap["nets"] = _tree_map(
                lambda t: t.detach().clone(),
                [step.net_depth.state_dict(), step.net_sf.state_dict()])
        if include_opt and "optimizers" not in snap:
            snap["optimizers"] = _tree_map(
                lambda t: t.detach().clone(),
                [o.state_dict() for o in step.optimizers])
        return snap["nets"], snap["optimizers"] if include_opt else None

    def save(self, path: str, step, epoch: int = 0,
             best: float = float("inf"), include_opt: bool = True) -> None:
        """Queue ``save_checkpoint(path, step, epoch, best, include_opt)``.
        The snapshot is the epoch's: a save of another epoch, or the first
        after ``invalidate``, clones the state anew."""
        self._raise_error()
        t0 = time.perf_counter()
        nets, opts = self._snapshot(step, epoch, include_opt)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        job = {"path": os.path.abspath(path), "nets": nets,
               "optimizers": opts, "epoch": int(epoch), "best": float(best),
               "event": event, "queued": threading.Event()}
        with self._lock:
            self._pending[job["path"]] += 1
        self._start()
        self._q.put(job)
        job["blocking"] = time.perf_counter() - t0
        job["queued"].set()

    def writing(self, path: str) -> bool:
        """Whether a write to ``path`` (or below the directory ``path``)
        is queued or under way."""
        path = os.path.abspath(path)
        with self._lock:
            return any(n > 0 and (p == path or p.startswith(path + os.sep))
                       for p, n in self._pending.items())

    def flush(self) -> None:
        """Wait for every queued write; raise a write's error."""
        self._q.join()
        self._raise_error()

    def close(self) -> None:
        """Flush and stop the writer thread."""
        try:
            self.flush()
        finally:
            thread = self._thread
            if thread is not None:
                self._q.put(None)
                thread.join()
                self._thread = None
                atexit.unregister(self._drain_at_exit)
            self.invalidate()

    def _raise_error(self) -> None:
        with self._lock:
            error, self._error = self._error, None
        if error is not None:
            path, exc = error
            raise RuntimeError(
                f"background checkpoint write of {path} failed: "
                f"{exc!r}") from exc

    def _start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="dvd-checkpoint-writer")
            self._thread.start()
            atexit.register(self._drain_at_exit)

    # -- the writer's side
    def _run(self) -> None:
        stream = None
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            stream = torch.cuda.Stream(self.device)
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                self._write(job, stream)
            except Exception as exc:  # raised on the caller's thread
                with self._lock:
                    if self._error is None:
                        self._error = (job["path"], exc)
            finally:
                if job is not None:
                    with self._lock:
                        self._pending[job["path"]] -= 1
                if self._q.empty():
                    self._host.clear()  # the host copy lives one save set
                # the job holds the device snapshot: let it go now, not at
                # the next get, which comes after the next epoch's clone
                job = None
                self._q.task_done()

    def _to_host(self, tree, stream):
        """The host copy of a snapshot part, made once while saves of it
        stay queued (held with the snapshot, so its id stays unique)."""
        if tree is None:
            return None
        hit = self._host.get(id(tree))
        if hit is None:
            if stream is None:
                host = tree
            else:
                with torch.cuda.stream(stream):
                    host = _tree_map(lambda t: t.to("cpu"), tree)
            hit = self._host[id(tree)] = (tree, host)
        return hit[1]

    def _write(self, job: Dict, stream) -> None:
        t0 = time.perf_counter()
        if job["event"] is not None:
            stream.wait_event(job["event"])
        ckpt = {"nets": self._to_host(job["nets"], stream),
                "epoch": job["epoch"], "best": job["best"]}
        if job["optimizers"] is not None:
            ckpt["optimizers"] = self._to_host(job["optimizers"], stream)
        path = job["path"]
        _atomic(path, lambda f: torch.save(ckpt, f))
        seconds = time.perf_counter() - t0
        job["queued"].wait()
        self.records.append(SaveRecord(path, seconds, os.path.getsize(path),
                                       job["blocking"]))

    def _drain_at_exit(self) -> None:
        """Bounded drain at interpreter exit: a write hung on broken
        storage must not hold the exit for good."""
        t0 = time.perf_counter()
        while (self._q.unfinished_tasks
               and time.perf_counter() - t0 < self.EXIT_DEADLINE_S):
            time.sleep(0.05)
        if self._q.unfinished_tasks:
            print(f"Warning: {self._q.unfinished_tasks} checkpoint write(s) "
                  f"still pending after {self.EXIT_DEADLINE_S:.0f} s; the "
                  "files on disk may be stale", flush=True)
        if self._error is not None:
            print(f"Warning: a background checkpoint write failed: "
                  f"{self._error[0]}: {self._error[1]!r}", flush=True)


def save_opt(logdir: str, opt) -> None:
    """The run's options as ``opt.json`` and ``opt.txt`` (reference saves
    opt.pt and opt.txt, train.py:93-96)."""
    d = {k: v for k, v in vars(opt).items() if not k.startswith("_")}
    text = json.dumps(d, indent=1, default=str).encode()
    _atomic(os.path.join(logdir, "opt.json"), lambda f: f.write(text))
    lines = "".join(f"{k}: {d[k]}\n" for k in sorted(d)).encode()
    _atomic(os.path.join(logdir, "opt.txt"), lambda f: f.write(lines))


def load_opt(logdir: str) -> Dict:
    with open(os.path.join(logdir, "opt.json")) as f:
        return json.load(f)


def resolve_resume(logdir: str, resume: int) -> Optional[str]:
    """The reference's resume convention (train.py:243-274) as a path:
    0 = fresh (``None``), -1 = the last checkpoint, -2 = the best, N = the
    nets of epoch N."""
    if resume == 0:
        return None
    if resume == -1:
        return os.path.join(logdir, "checkpoint.pt")
    if resume == -2:
        return os.path.join(logdir, "best.pt")
    return os.path.join(logdir, "nets", "%04d.pt" % resume)
