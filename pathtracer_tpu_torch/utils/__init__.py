"""Timer, render checkpoints and the CUDA kernel build."""
