"""Spread of the ranks' trace-kernel time a job, in percent of the
slowest: (slowest - fastest) / slowest.  The job waits for its slowest
band."""

KERNEL = "trace_kernel"


def read(trace):
    if len(trace.ranks) < 2:
        return None
    per_rank = [sum(b - a for _, a, b in r.in_window(r.named(KERNEL)))
                for r in trace.ranks]
    if min(per_rank) <= 0:
        return None
    return 100.0 * (max(per_rank) - min(per_rank)) / max(per_rank)
