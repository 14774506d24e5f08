"""Wall-clock timer that waits for the device."""

from __future__ import annotations

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

