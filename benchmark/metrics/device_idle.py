"""Share of the traced window, in percent, in which no kernel, copy or set
ran on the device, averaged over the ranks.  It reads every
``device_idle.<cells>`` metric: each moves its own cells' end-to-end
metric.  A rank that waits for the others' bands waits inside the
collective's kernel, which counts as busy: ``gather_ms.sharded`` and
``rank_skew.sharded`` show that wait."""


def read(trace):
    return trace.idle_share()
