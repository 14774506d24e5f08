"""The cluster kernel's share of the window's busy device time, in
percent: the union of the window's kernels whose name holds
``cluster_kernel`` over the union of every kernel, copy and set.  None
where the window ran no such kernel."""

from benchmark.harness.trace import union_us

KERNEL = "cluster_kernel"


def read(trace):
    r = trace.ranks[0]
    own, busy = union_us(r.in_window(r.named(KERNEL))), r.busy_us()
    if own <= 0 or busy <= 0:
        return None
    return 100.0 * own / busy
