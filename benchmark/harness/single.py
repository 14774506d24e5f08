"""The run of a one-process cell: set-up and warm-up, the closed-loop
window (traced when asked), the peak memory, then the check."""

from __future__ import annotations

import shutil
import sys
import tempfile
import time

from ..reference import compare
from . import trace as tr
from .core import Context, Run, Window, closed_loop


def device_info(ctx: Context, count: int, peak: int, traced=None) -> dict:
    import torch
    kind = (torch.cuda.get_device_name(0) if ctx.device == "cuda"
            else ctx.device)
    out = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
           "kind": kind, "count": count, "memory_peak_bytes": int(peak)}
    if traced is not None:
        out["busy_s"] = traced.busy_s()
        out["window_s"] = traced.window_s()
    return out


def run(ctx: Context, cell, built: float) -> Run:
    """``cell`` (made at ``built`` on the host clock): ``warmup()``,
    ``request(i)``, ``work(i)``, ``trace_work(n)`` (operation counts of the first n requests), ``release()`` (drop the
    program's state, keep its outputs) and ``check(n)`` (the numbers
    compared, by name)."""
    import torch
    from torch.profiler import record_function

    cuda = ctx.device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cell.warmup()
    sync()
    setup_s = time.perf_counter() - ctx.t0
    print(f"setup {setup_s:.3f} s: {built - ctx.t0:.3f} s to the cell's "
          f"inputs and state, {setup_s - (built - ctx.t0):.3f} s of "
          f"warm-up", file=sys.stderr)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = tr.profiler() if ctx.trace else None
    with record_function("bench.window"):
        spans = closed_loop(cell.request, sync, ctx.seconds, record_function)
    traced = None
    if prof is not None:
        prof.stop()
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            ranks = [tr.load_chrome(tr.export(prof, tmp))]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n = len(spans)
    window = Window(setup_s, spans, [cell.work(i) for i in range(n)])
    work = cell.trace_work(n) if ctx.trace else {}
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    verdict = compare.verdict(cell.check(n), ctx.workload["limits"])
    if ctx.trace:
        traced = tr.TraceRun(ranks, n, work,
                             device_info(ctx, 1, 0)["kind"])
    return Run(window, verdict["checks"], verdict["correct"],
               device_info(ctx, 1, peak, traced), traced)
