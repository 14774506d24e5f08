"""Throughput metering and profiler hooks, the PyTorch counterpart of
``pathtracer_tpu/utils/profiling.py``.

  * RaysPerSecond — ray-segment throughput over timed sections (the caller
    ends each section's device work, e.g. with ``torch.cuda.synchronize``,
    before it closes).
  * trace_annotation / profile_to — thin wrappers over ``torch.profiler``:
    a named range on the timeline, and a capture written as a Chrome trace
    (``chrome://tracing``, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class RaysPerSecond:
    """Accumulates (rays, seconds) across timed sections."""

    def __init__(self):
        self.rays = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_rays: int):
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0
        self.rays += n_rays

    @property
    def value(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else 0.0

    def __repr__(self):
        return f"{self.value:.3e} rays/s ({self.rays} rays in {self.seconds:.2f}s)"


def trace_annotation(name: str):
    """Named region for profiler timelines."""
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
