"""The renderer's random streams, in plain PyTorch.

One uint32 hash stream per (pixel, sample), and for the coherent-beam
renderer one per (tile, sample).  States are uint32 values held in int64
tensors, every product split into 16-bit halves so no int64 product
overflows.  Written from the stream definitions the renderer documents:
``hash(hash(pix ^ sidx * GOLDEN) ^ seed * SEED_MIX)`` with
``pix = h + w * res_y + 1``, and ``u = (state >> 8) * 2^-24``.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
SEED_MIX = 0x85EBCA6B
HASH_XOR = 2747636419
HASH_MUL = 2654435769
TILE_MIX = 0x9E377


def u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & MASK


def mul_u32(s: torch.Tensor, c: int) -> torch.Tensor:
    lo = s * (c & 0xFFFF)
    hi = ((s * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def hash_u32(state) -> torch.Tensor:
    s = u32(state) ^ HASH_XOR
    s = mul_u32(s, HASH_MUL)
    s = s ^ (s >> 16)
    s = mul_u32(s, HASH_MUL)
    s = s ^ (s >> 16)
    return mul_u32(s, HASH_MUL)


def rand01(state, dtype=torch.float32):
    """(new state, uniform in [0, 1)) in ``dtype``."""
    state = hash_u32(state)
    u = (state >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return state, u.to(dtype)


def sample_seed(w, h, res_y: int, sidx, seed: int) -> torch.Tensor:
    """The stream of each (pixel, sample)."""
    pix = (u32(h) + mul_u32(u32(w), int(res_y) & MASK) + 1) & MASK
    s = hash_u32(pix ^ mul_u32(u32(sidx), GOLDEN))
    return hash_u32(s ^ ((int(seed) * SEED_MIX) & MASK))


def tile_seed(tiles, sidx: int, seed: int) -> torch.Tensor:
    """The bounce stream of each (tile, sample) of the beam renderer."""
    golden = (int(sidx) * GOLDEN) & MASK
    state = hash_u32(((u32(tiles) + TILE_MIX) & MASK) ^ golden)
    return hash_u32(state ^ ((int(seed) * SEED_MIX) & MASK))
