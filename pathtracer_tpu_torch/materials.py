"""Materials and BRDF sampling (L2), the PyTorch counterpart of
``pathtracer_tpu/materials.py``.

Types: EMIT=1, DIFFUSE=2, SPECULAR=3 (0 marks padding).  The specular
sampler draws a fixed ``SPECULAR_TRIES`` cube jitters per bounce and takes
the first one above the surface, falling back to the pure mirror.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng as prng
from .linalg import dot, normalize

EMIT = 1
DIFFUSE = 2
SPECULAR = 3

SPECULAR_TRIES = 8

_TWO_PI = float(np.float32(2.0 * math.pi))


def hemisphere_sample(u, v, normal):
    """Uniform hemisphere sample about ``normal``: with x = 2u - 1,
    (sqrt(1 - x^2) cos(2 pi v), sqrt(1 - x^2) sin(2 pi v), -x), flipped to
    the normal's side.  u, v: (...,); normal: (..., 3)."""
    x = 2.0 * u - 1.0
    ct = torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0))
    phi = _TWO_PI * v
    sample = torch.stack([ct * torch.cos(phi), ct * torch.sin(phi), -x],
                         dim=-1)
    flip = torch.where(dot(sample, normal)[..., None] < 0.0, -1.0, 1.0)
    return sample * flip


def specular_sample(ray_d, normal, roughness, cube_u):
    """Jittered mirror reflection.

    ray_d, normal: (..., 3); roughness: (...,) or (..., 1);
    cube_u: (K, ..., 3) uniforms for K fixed tries.  Returns a unit vector.
    """
    if roughness.dim() == ray_d.dim() - 1:
        roughness = roughness[..., None]
    reflected = ray_d - normal * (2.0 * dot(ray_d, normal))[..., None]
    chosen = reflected  # fallback: the pure mirror direction
    # Walk the tries from last to first so that the FIRST acceptable wins.
    for k in range(cube_u.shape[0] - 1, -1, -1):
        cand = reflected + (cube_u[k] - 0.5) * roughness
        ok = dot(cand, normal)[..., None] >= 0.0
        chosen = torch.where(ok, cand, chosen)
    return normalize(chosen)


def draw_bounce_uniforms(state, has_specular: bool = True):
    """One bounce's uniforms: u, v, then (only with speculars in the scene)
    3 * SPECULAR_TRIES cube jitters.  Returns (state, (u, v, cube)), cube
    of shape (SPECULAR_TRIES, ..., 3) or None."""
    state, u = prng.rand01(state)
    state, v = prng.rand01(state)
    if not has_specular:
        return state, (u, v, None)
    state, flat = prng.randn01(state, 3 * SPECULAR_TRIES)
    cube = torch.movedim(
        flat.reshape((SPECULAR_TRIES, 3) + tuple(flat.shape[1:])), 1, -1)
    return state, (u, v, cube)


def sample_direction(mat_type, roughness, ray_d, normal, u, v, cube_u):
    """Material-dispatched bounce direction: SPECULAR takes the jittered
    mirror, everything else the hemisphere sample."""
    diff = hemisphere_sample(u, v, normal)
    spec = specular_sample(ray_d, normal, roughness, cube_u)
    return torch.where((mat_type == SPECULAR)[..., None], spec, diff)
