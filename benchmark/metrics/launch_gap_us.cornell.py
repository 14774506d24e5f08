"""Mean device gap, in microseconds, between consecutive trace-kernel
launches within a job (render.render_film -> render_sum_cuda): the time
the device waits on the host's loop of launches."""

KERNEL = "trace_kernel"


def read(trace):
    gaps = []
    for r in trace.ranks:
        for job in r.per_request(r.named(KERNEL)):
            gaps += [b[1] - a[2] for a, b in zip(job, job[1:])]
    return sum(gaps) / len(gaps) if gaps else None
