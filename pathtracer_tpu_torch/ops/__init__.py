"""Device ops: intersection, the bounce loop and the CUDA kernels."""
