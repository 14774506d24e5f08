"""Device kernels launched a recovery step (inverse._train_step ->
diff.render_film_diff, the paired loss, its backward and Adam)."""


def read(trace):
    r = trace.ranks[0]
    kernels = r.in_window(r.kernels)
    return len(kernels) / trace.requests if kernels else None
