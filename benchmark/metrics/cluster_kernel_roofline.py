"""The cluster kernel's share of its roofline, in percent: the operations
an exact two-level traversal of the window's paths needs (benchmark/counts,
the rule and box layout of ``beam_kernel_roofline``) at the card's fp32
peak, over the device time of the window's kernels whose name holds
``cluster_kernel``."""

from benchmark.harness.peaks import fp32_flops

KERNEL = "cluster_kernel"


def read(trace):
    ops, peak = trace.work.get(KERNEL), fp32_flops(trace.kind)
    us = sum(b - a for r in trace.ranks
             for _, a, b in r.in_window(r.named(KERNEL)))
    if not ops or not peak or us <= 0:
        return None
    return 100.0 * (ops / peak) / (us / 1e6)
