"""Tracing (counterpart of ``dynamic_video_depth_tpu/runtime/
profiling.py``).

``trace_if`` writes a ``torch.profiler`` trace as Chrome trace JSON (open
it in Perfetto, ui.perfetto.dev, or chrome://tracing); ``annotate`` names
a span of it. The trace's ``ts`` is on the wall clock, so the spans and
the device's events share one clock. The reference's wall-clock EMA of
the step (``StepTimer``) has no counterpart: the loop's CUDA events time
each step.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

TRACE_NAME = "trace.json"
# what ``annotate`` returns while no profiler runs: reusable and reentrant
_NO_SPAN = contextlib.nullcontext()


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
    """A named span on the profiler's timeline. While no profiler is
    active it returns a shared null context and builds no
    ``record_function``: a span off costs one check, under 1 µs of a CPU
    core against 12-15 µs for a ``record_function``, so spans can stay on
    the step's path."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)
