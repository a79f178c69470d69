"""Tracing and step timing (counterpart of ``dynamic_video_depth_tpu/
runtime/profiling.py``).

``trace_if`` writes a ``torch.profiler`` trace as Chrome trace JSON (open
it in Perfetto, ui.perfetto.dev, or chrome://tracing); ``annotate`` names
a span of it. ``StepTimer`` is the reference's wall-clock EMA of
data_time / batch_time (models/netinterface.py:291-302).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace_if(logdir: Optional[str], enabled: bool = True):
    """A ``torch.profiler`` trace of the block into ``logdir/trace.json``:
    CPU activity, and CUDA activity where a card is present. Disabled (or
    without ``logdir``) it does nothing and makes no directory."""
    if not enabled or not logdir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME))


def annotate(name: str):
    """A named span on the profiler's timeline (a no-op outside a
    trace)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timer with an exponential moving average."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg = None
        self._t0 = None

    def tic(self):
        self._t0 = time.time()

    def toc(self) -> float:
        dt = time.time() - self._t0
        self.avg = dt if self.avg is None else \
            self.ema * self.avg + (1 - self.ema) * dt
        return dt
