"""Host microseconds a trace-kernel launch: the summed ``pt.trace.launches``
time inside the window (the program's launch loop) over the count of
trace-kernel kernels in the window; the inside view of
``launch_gap_us.cornell``.  None where the window holds no
``pt.trace.launches`` span (a program without spans) or no such kernel."""

FAMILY, KERNEL = "pt.trace.launches", "trace_kernel"


def read(trace):
    host_us, launches = 0.0, 0
    for r in trace.ranks:
        loops = [s for s in r.in_window(r.spans) if s[0] == FAMILY]
        if not loops:
            return None
        host_us += sum(b - a for _, a, b in loops)
        launches += len(r.in_window(r.named(KERNEL)))
    return host_us / launches if launches else None
