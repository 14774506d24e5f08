"""The trace kernel's share of its roofline, in percent: the operations
the window's paths need (benchmark/counts: every live segment tests every
triangle with the Plücker test) at the card's fp32 peak, over the
kernel's device time summed over the ranks (in a render sharded over
cards, every band of every job at one card's peak)."""

from benchmark.harness.peaks import fp32_flops

KERNEL = "trace_kernel"


def read(trace):
    ops, peak = trace.work.get(KERNEL), fp32_flops(trace.kind)
    us = sum(b - a for r in trace.ranks for _, a, b in r.named(KERNEL))
    if not ops or not peak or us <= 0:
        return None
    return 100.0 * (ops / peak) / (us / 1e6)
