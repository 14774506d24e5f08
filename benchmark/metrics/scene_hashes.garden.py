"""Times a request that the program hashes the scene's host bytes: the
count of ``pt.scene.hash`` spans inside the window, over the requests.
None where the window holds no ``pt.render_film`` span (a program without
spans)."""

FAMILY, SPAN = "pt.render_film", "pt.scene.hash"


def read(trace):
    counts = []
    for r in trace.ranks:
        names = [s[0] for s in r.in_window(r.spans)]
        if FAMILY not in names:
            return None
        counts.append(names.count(SPAN))
    return sum(counts) / len(counts) / trace.requests
