"""Host wrappers of the CUDA kernels in ``csrc/``."""
