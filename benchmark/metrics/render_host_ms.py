"""Host milliseconds a recovery step spends in the program's
differentiable renders: the window's summed ``pt.diff.render`` spans (two
a paired step) over the steps.  None where the window holds no such span
(a program without it)."""

SPAN = "pt.diff.render"


def read(trace):
    r = trace.ranks[0]
    spans = [s for s in r.in_window(r.spans) if s[0] == SPAN]
    if not spans:
        return None
    return sum(b - a for _, a, b in spans) / trace.requests / 1e3
