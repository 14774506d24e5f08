"""Film resets a frame: the count of the program's ``pt.realtime.reset``
spans inside the window, over the requests (each request is one frame).
None where the window holds no ``pt.realtime.step`` span (a program
without spans)."""

FAMILY, SPAN = "pt.realtime.step", "pt.realtime.reset"


def read(trace):
    counts = []
    for r in trace.ranks:
        names = [s[0] for s in r.in_window(r.spans)]
        if FAMILY not in names:
            return None
        counts.append(names.count(SPAN))
    return sum(counts) / len(counts) / trace.requests
