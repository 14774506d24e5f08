"""Mean time, in milliseconds, from a job's span start to its first
beam-kernel start on the device: the host's preparation of a large-mesh
render (the scene's byte fingerprint, the accel cache lookup, the launch
set-up), which the device waits for."""

KERNEL = "beam_kernel"


def read(trace):
    waits = []
    for r in trace.ranks:
        for span, job in zip(r.requests(), r.per_request(r.named(KERNEL))):
            if job:
                waits.append((job[0][1] - span[1]) / 1e3)
    return sum(waits) / len(waits) if waits else None
