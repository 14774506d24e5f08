"""Device ops: intersection, the bounce loop, the wavefront pipeline and
the CUDA kernels."""
