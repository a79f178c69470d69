"""Host-side batch loading and the device put (counterpart of
``dynamic_video_depth_tpu/data/prefetch.py``; reference train.py:301-327,
its ``DataLoader`` workers).

A reader thread loads, collates and pins the next batches while the card
runs the current step (``BatchLoader``); the batches then reach the card
either once, kept in device memory after their first use
(``DeviceCache``), or every step, copied one batch ahead on a side stream
(``DevicePrefetcher``). Every device put runs on the consuming thread, at
an explicit device: the current CUDA device is a per-thread setting, and a
reader thread that allocated on ``"cuda"`` would land on card 0 in a fleet
rank that owns another card.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

from .batches import host_tensors, to_device

HOST_KEYS = ("pair_path", "steps")


def explicit_device(device) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` becomes the calling
    thread's current card, fixed here so that no other thread reads its
    own."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def split_host_device(batch: Dict):
    """(device part, host part): the host keys (paths, the Euler step
    count) never reach the device."""
    dev = {k: v for k, v in batch.items() if k not in HOST_KEYS}
    host = {k: v for k, v in batch.items() if k in HOST_KEYS}
    return dev, host


class BatchLoader:
    """Yields ``(index, batch)`` in ``order`` from one reader thread and a
    bounded queue.

    With ``device`` the thread also converts each batch to float32 CPU
    tensors (``host_tensors``), page-locked for a CUDA ``device``; it never
    touches the card's memory. ``skip(index)`` true yields ``(index,
    None)`` without reading (a sample already on the card). A reader error
    is raised on the consuming thread; a consumer that stops early (the
    NaN guard, an exception) closes the iterator and the thread ends."""

    def __init__(self, dataset, order: Sequence[int], queue_size: int = 4,
                 device=None, skip: Optional[Callable[[int], bool]] = None):
        self.dataset = dataset
        self.order = list(order)
        self.queue_size = queue_size
        self.device = None if device is None else explicit_device(device)
        self.skip = skip

    def _read(self, i):
        if self.skip is not None and self.skip(i):
            return None
        batch = self.dataset[i]
        if self.device is not None:
            batch = host_tensors(batch, pin=self.device.type == "cuda")
        return batch

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        stop = threading.Event()

        def put(item) -> bool:
            # a plain q.put blocks for good on a full queue once the
            # consumer has left
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                if self.device is not None and self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                for i in self.order:
                    if stop.is_set() or not put((i, self._read(i))):
                        return
            except Exception as e:  # raised again on the consuming thread
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=worker, daemon=True,
                             name="dvd-batch-loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


class DeviceCache:
    """The samples of ``dataset`` on ``device`` as ``to_device`` gives
    them, kept by index after their first use while their bytes stay
    within ``max_bytes``; a later use hands back the same tensors.

    Per-video optimization reuses a fixed set of pairs for the whole run:
    one packed pair at 224x384 is 5,849,268 bytes on the card, so the
    recipe's gaps 1-8 of a 70-frame track fit well inside the budget.
    ``device`` is required (never the thread's current device)."""

    def __init__(self, dataset, device, max_bytes: float = 8e9):
        self.dataset = dataset
        self.device = explicit_device(device)
        self.max_bytes = max_bytes
        self.nbytes = 0
        self._cache: Dict = {}

    def __len__(self):
        return len(self.dataset)

    def __contains__(self, idx) -> bool:
        return idx in self._cache

    def keys(self):
        return self._cache.keys()

    def get(self, idx, batch: Optional[Dict] = None):
        """``(device tensors, host part)`` of sample ``idx``: the kept ones,
        else those of ``batch`` (its host batch; read now when None), kept
        while the budget allows. Call it on the consuming thread."""
        entry = self._cache.get(idx)
        if entry is not None:
            return entry
        if batch is None:
            batch = self.dataset[idx]
        dev, host = split_host_device(batch)
        entry = (to_device(dev, self.device), host)
        size = sum(t.numel() * t.element_size() for t in entry[0].values())
        if self.nbytes + size <= self.max_bytes:
            self._cache[idx] = entry
            self.nbytes += size
        return entry

    def __getitem__(self, idx):
        dev, host = self.get(idx)
        return dict(dev, **host)


class DevicePrefetcher:
    """Wraps an iterable of ``(index, batch)`` and yields ``(index, device
    tensors, host part)`` with the next batch's copy already under way.

    On a CUDA ``device`` the (pinned) tensors are copied with
    ``non_blocking=True`` on a side stream; before a batch is handed over
    the consuming stream waits for that batch's copy event, and each of its
    tensors is marked used by the consuming stream (``record_stream``), so
    the caching allocator does not hand its memory to another tensor while
    the step still reads it. On the CPU a plain one-ahead iterator."""

    def __init__(self, it: Iterable, device):
        self.it = it
        self.device = explicit_device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def _put(self, item):
        idx, batch = item
        dev, host = split_host_device(batch)
        if self.stream is None:
            return idx, to_device(dev, self.device), host, None
        with torch.cuda.stream(self.stream):
            dev = to_device(dev, self.device)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        return idx, dev, host, copied

    def _hand_over(self, item):
        idx, dev, host, copied = item
        if copied is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(copied)
            for t in dev.values():
                t.record_stream(consumer)
        return idx, dev, host

    def __iter__(self):
        it = iter(self.it)
        pending = None
        try:
            for item in it:
                ready, pending = pending, self._put(item)
                if ready is not None:
                    yield self._hand_over(ready)
            if pending is not None:
                yield self._hand_over(pending)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
