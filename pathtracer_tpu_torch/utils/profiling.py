"""Profiler hooks, the PyTorch counterpart of
``pathtracer_tpu/utils/profiling.py``.

  * trace_annotation — the program's one span helper: a named range on the
    ``torch.profiler`` timeline while a profiler runs, one shared no-op
    otherwise.  The program's spans are named ``pt.*`` (README.md lists
    them); the count of a span in a trace counts the work it covers.
  * profile_to — a capture of host and device activity written as a
    Chrome trace (``chrome://tracing``, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

_NO_SPAN = contextlib.nullcontext()


def trace_annotation(name: str):
    """Named region for profiler timelines: ``record_function(name)`` while
    a profiler runs, else the shared no-op, so a span costs one check when
    nothing records it."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_to(logdir: Optional[str]):
    """Capture a ``torch.profiler`` trace (host, and the device when CUDA
    is available) into ``<logdir>/trace.json``; yields the profiler, or
    None and captures nothing when ``logdir`` is falsy."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
