"""Wall-clock timer that waits for the device, and CUDA-event timing."""

from __future__ import annotations

import statistics
import time

import torch


class Timer:
    """Host clock around device work.  With a CUDA ``device`` it calls
    ``torch.cuda.synchronize`` before reading the clock, so queued kernels
    are counted and not merely their enqueue."""

    def __init__(self, device=None):
        self._device = None if device is None else torch.device(device)
        self.start()

    def _sync(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def start(self) -> None:
        self._sync()
        self._start = time.perf_counter()

    reset = start

    def seconds(self) -> float:
        self._sync()
        return time.perf_counter() - self._start


def device_ms(fn, calls: int, runs: int = 3):
    """(median, all runs) of the device time in ms per call of ``fn`` on
    the current CUDA device, after one warm-up call.  Each run is ``calls``
    back-to-back calls between two CUDA events, so the host's preparation
    of a call overlaps the device work of the one before, as in a render;
    a single call would also count the idle device while the host prepares
    it."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), times
