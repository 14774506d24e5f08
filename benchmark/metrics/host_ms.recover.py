"""Host milliseconds a recovery step spends enqueuing: the summed
``pt.train_step`` time inside the window less the summed ``pt.step.sync``
time (the host's wait for the loss), over the steps.  None where the
window holds no ``pt.train_step`` span (a program without spans)."""

FAMILY, SYNC = "pt.train_step", "pt.step.sync"


def read(trace):
    r = trace.ranks[0]
    spans = r.in_window(r.spans)
    if not any(s[0] == FAMILY for s in spans):
        return None
    own = sum(b - a for n, a, b in spans if n == FAMILY)
    own -= sum(b - a for n, a, b in spans if n == SYNC)
    return own / trace.requests / 1e3
