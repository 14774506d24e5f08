"""The traced window: ``torch.profiler`` over the window, its Chrome trace
read back into device intervals and the benchmark's spans.

Spans are ``record_function`` ranges the harness opens around the window
(``bench.window``) and around each request (``bench.request``); they sit
in the trace on the same clock as the device's kernels.  Device time is
the union of kernel, copy and set intervals.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[str, float, float]        # (name, start us, end us)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
TOP = 10


def profiler():
    """A started profiler of host and device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


@dataclasses.dataclass
class RankTrace:
    """One process's traced window."""
    device: List[Interval]        # kernels, copies and sets
    kernels: List[Interval]
    spans: List[Interval]         # user annotations
    host: List[Interval]          # host operators and annotations

    def window(self) -> Optional[Tuple[float, float]]:
        w = [s for s in self.spans if s[0] == "bench.window"]
        return (w[0][1], w[0][2]) if w else None

    def requests(self) -> List[Interval]:
        return sorted((s for s in self.spans if s[0] == "bench.request"),
                      key=lambda s: s[1])

    def in_window(self, intervals: Sequence[Interval]) -> List[Interval]:
        lo, hi = self.window()
        return [(n, max(a, lo), min(b, hi)) for n, a, b in intervals
                if b > lo and a < hi]

    def busy_us(self) -> float:
        return union_us(self.in_window(self.device))

    def window_us(self) -> float:
        lo, hi = self.window()
        return hi - lo

    def named(self, part: str) -> List[Interval]:
        """Kernels whose name holds ``part``, in start order."""
        return sorted((k for k in self.kernels if part in k[0]),
                      key=lambda k: k[1])

    def per_request(self, intervals: Sequence[Interval]
                    ) -> List[List[Interval]]:
        """``intervals`` grouped by the request whose span holds their
        start (a request ends in a synchronise, so its device work lies in
        its span)."""
        reqs = self.requests()
        out = [[] for _ in reqs]
        j = 0
        for iv in sorted(intervals, key=lambda k: k[1]):
            while j < len(reqs) and reqs[j][2] < iv[1]:
                j += 1
            if j < len(reqs) and reqs[j][1] <= iv[1]:
                out[j].append(iv)
        return out


def union_us(intervals: Sequence[Interval]) -> float:
    total, end = 0.0, None
    for _, a, b in sorted(intervals, key=lambda k: k[1]):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def load_chrome(path: str) -> RankTrace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, kernels, spans, host = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        iv = (e.get("name", ""), float(e["ts"]), float(e["ts"]) + e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(iv)
            if cat == "kernel":
                kernels.append(iv)
        if cat == "user_annotation":
            spans.append(iv)
        if cat in HOST_CATS:
            host.append(iv)
    return RankTrace(device, kernels, spans, host)


def export(prof, directory: str, rank: int = 0) -> str:
    path = os.path.join(directory, f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    return path


@dataclasses.dataclass
class TraceRun:
    """What the per-layer readers read: each rank's traced window, the
    requests the window completed, the work they needed (operation counts
    by kernel, computed by ``benchmark/counts``) and the device's kind."""
    ranks: List[RankTrace]
    requests: int
    work: Dict[str, float]
    kind: str

    def busy_s(self) -> float:
        return sum(r.busy_us() for r in self.ranks) / len(self.ranks) / 1e6

    def window_s(self) -> float:
        return sum(r.window_us() for r in self.ranks) / len(self.ranks) / 1e6

    def idle_share(self) -> Optional[float]:
        """Percent of the traced window with nothing on the device, over
        every rank; None when the trace holds no device activity."""
        if not any(r.device for r in self.ranks):
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s())

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps of rank 0, each gap named by the host operation that ran at
        its middle."""
        r = self.ranks[0]
        ops: Dict[str, float] = {}
        for name, a, b in r.in_window(r.device):
            ops[name[:100]] = ops.get(name[:100], 0.0) + (b - a) / 1e6
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        lo, hi = r.window()
        gaps, end = [], lo
        for _, a, b in sorted(r.in_window(r.device), key=lambda k: k[1]):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for a, b in gaps:
            mid = (a + b) / 2
            inside = [h for h in r.host if h[1] <= mid <= h[2]
                      and h[0] not in ("bench.window",)]
            name = max(inside, key=lambda h: h[1])[0] if inside else "idle"
            named.append([name[:100], (b - a) / 1e6])
        return {"device_ops": [[n, s] for n, s in top_ops],
                "idle_gaps": named}
