"""Random number generation (L1), the PyTorch counterpart of
``pathtracer_tpu/rng.py``.

``Lcg`` is the host-side reference LCG.  ``hash_u32`` / ``rand01`` are the
per-(pixel, sample) xorshift/multiply hash streams of the render path.

States are uint32 values held in int64 tensors: PyTorch on the CPU has no
right shift for ``torch.uint32``.  Every step masks with ``0xFFFFFFFF`` and
multiplies in 16-bit halves, so no int64 product overflows and the states
equal the JAX package's uint32 states bit for bit.  The CUDA kernel uses
native ``uint32_t`` for the same streams.
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 1
MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
SEED_MIX = 0x85EBCA6B
_HASH_XOR = 2747636419
_HASH_MUL = 2654435769


class Lcg:
    """The reference LCG (a=1664525, c=1013904223, m=2^32). Host-side only."""

    A = np.uint64(1664525)
    C = np.uint64(1013904223)
    M = np.uint64(4294967296)

    def __init__(self, seed: int = SEED):
        self.state = np.uint64(seed)

    def next_u32(self) -> int:
        self.state = (self.A * self.state + self.C) % self.M
        return int(self.state)

    def rand01(self) -> float:
        return float(np.float32(self.next_u32()) / np.float32(self.M))

    def seed(self, seed: int) -> None:
        self.state = np.uint64(seed)


def _u32(x) -> torch.Tensor:
    """Any integer tensor or int -> int64 tensor holding its uint32 value."""
    return torch.as_tensor(x).to(torch.int64) & MASK


def _mul_u32(s: torch.Tensor, c: int) -> torch.Tensor:
    """(s * c) mod 2^32 for s in [0, 2^32), without int64 overflow."""
    lo = s * (c & 0xFFFF)
    hi = ((s * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def hash_u32(state) -> torch.Tensor:
    """One step of the GPU hash RNG; uint32 values in, uint32 values out."""
    s = _u32(state) ^ _HASH_XOR
    s = _mul_u32(s, _HASH_MUL)
    s = s ^ (s >> 16)
    s = _mul_u32(s, _HASH_MUL)
    s = s ^ (s >> 16)
    return _mul_u32(s, _HASH_MUL)


def rand01(state):
    """Advance the hash state; return (new_state, uniform in [0, 1)) with
    ``u = float32(int32(state >> 8)) * 2^-24``."""
    state = hash_u32(state)
    u = (state >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return state, u


def randn01(state, n: int):
    """Draw ``n`` uniforms per lane; returns (state, u) with u of shape
    ``(n, *state.shape)``."""
    us = []
    for _ in range(n):
        state, u = rand01(state)
        us.append(u)
    return state, torch.stack(us, dim=0)


def pixel_seed(w, h, res_y, frame=None) -> torch.Tensor:
    """The reference megakernel's per-pixel seed: the float expression
    ``(h + 0.5) + (w + 0.5) * res_y + 1`` (times ``frame`` on ``h`` in the
    realtime form), truncated to uint32."""
    fx = w.to(torch.float32) + 0.5
    fy = h.to(torch.float32) + 0.5
    if frame is None:
        val = fy + fx * float(res_y) + 1.0
    else:
        val = float(np.float32(frame)) * fy + fx * float(res_y) + 1.0
    return val.to(torch.int64) & MASK


def sample_seed(w, h, res_y, sample_idx, base_seed: int = SEED):
    """One decorrelated uint32 stream per (pixel, sample):
    ``hash(hash(pix ^ sidx * GOLDEN) ^ mix)`` with
    ``pix = h + w * res_y + 1`` and ``mix = base_seed * SEED_MIX``."""
    pix = (_u32(h) + _mul_u32(_u32(w), int(res_y) & MASK) + 1) & MASK
    s = hash_u32(pix ^ _mul_u32(_u32(sample_idx), GOLDEN))
    mix = (int(base_seed) * SEED_MIX) & MASK
    return hash_u32(s ^ mix)
