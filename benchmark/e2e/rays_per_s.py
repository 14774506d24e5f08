"""Rays a second: width x height x samples x depth of every job the
window completed, over the wall time from the first job's start to the
last job's synchronised end (over cards, from the first job's go on
every rank to the last assembled film on rank 0).  It reads
``rays_per_s.<route>`` too: routes whose runs spread wider carry their own
bound (PERF.md)."""


def compute(window):
    return sum(window.work) / window.seconds
