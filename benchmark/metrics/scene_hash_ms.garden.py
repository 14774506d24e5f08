"""Milliseconds a request in which the program hashes the scene's host
bytes: the union of its ``pt.scene.hash`` spans inside the window, over
the requests.  None where the window holds no ``pt.render_film`` span (a
program without spans)."""

from benchmark.harness.trace import union_us

FAMILY, SPAN = "pt.render_film", "pt.scene.hash"


def read(trace):
    per_rank = []
    for r in trace.ranks:
        spans = r.in_window(r.spans)
        if not any(s[0] == FAMILY for s in spans):
            return None
        per_rank.append(union_us([s for s in spans if s[0] == SPAN]))
    return sum(per_rank) / len(per_rank) / trace.requests / 1e3
