"""Device time of the program's collectives (NCCL kernels) a job on rank
0, in milliseconds: the bands' all-gather of parallel/shard.py, with the
wait for the slowest rank's band that happens inside the collective's
kernel.  The harness's own go signal before each job, a broadcast, is
left out."""


def read(trace):
    r = trace.ranks[0]
    us = sum(b - a for n, a, b in r.in_window(r.kernels)
             if "nccl" in n.lower() and "broadcast" not in n.lower())
    return us / 1e3 / trace.requests if us > 0 else None
