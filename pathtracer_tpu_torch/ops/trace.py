"""The bounce loop, the PyTorch counterpart of ``pathtracer_tpu/ops/trace.py``.

Forward accumulation: carry a throughput, add ``throughput * emit`` at every
hit and multiply by ``2 * albedo * cos`` on every continuing bounce.  A
miss kills the path; an EMIT hit adds its emission and kills the path; the
next origin is ``hit_p + normal * SHIFT_BIAS``.  Dead rays are masked.

Per-triangle shading constants live in one (T, 12) table, gathered by hit
triangle id (``gather_features``): where a gradient flows into a table of up
to ``ONEHOT_GATHER_MAX_ROWS`` rows, a one-hot matmul, whose backward is a
matmul; else, on the card, the gather kernel pair
(``ops/cuda/gather_kernel.gather_rows``), whose backward is an order-fixed
segment sum; on the CPU its plain version, ``index_select``.  Neither
backward takes ``index_add_``'s float atomics.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import materials as mat
from ..camera import Camera, get_rays
from ..linalg import SHIFT_BIAS, cross, dot
from ..rng import rand01, sample_seed
from ..scene import Scene
from .cuda.gather_kernel import gather_rows, gather_rows_reference
from .intersect import intersect_brute

# Shade-table column layout.
_ALBEDO = slice(0, 3)
_EMIT = slice(3, 6)
_ROUGH = 6
_NORMAL = slice(7, 10)
_IS_EMIT = 10
_IS_SPEC = 11
TABLE_COLS = 12

IntersectFn = Callable[[torch.Tensor, torch.Tensor],
                       Tuple[torch.Tensor, torch.Tensor]]


def shade_table(scene: Scene) -> torch.Tensor:
    """The (T, 12) table: [albedo, emit, roughness, unit geometric normal,
    is_emit, is_specular].  Padding rows get a zero normal."""
    n = cross(scene.v2 - scene.v1, scene.v3 - scene.v1)
    norm = torch.sqrt(dot(n, n))[:, None]
    n = n / torch.where(norm > 0, norm, 1.0)
    return torch.cat([
        scene.albedo,
        scene.emit,
        scene.roughness[:, None],
        n,
        (scene.mat_type == mat.EMIT)[:, None].to(torch.float32),
        (scene.mat_type == mat.SPECULAR)[:, None].to(torch.float32),
    ], dim=-1)


# Largest table gathered by one-hot matmul on the gradient path, as in the
# JAX package: the backward keeps the (rays, T) one-hot, linear in T.
ONEHOT_GATHER_MAX_ROWS = 4096


def gather_features(table: torch.Tensor, tid: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` by triangle id: (...,) -> (..., C); id -1 (a miss)
    gives an all-zero row.

    Where autograd records the table and it has at most
    ``ONEHOT_GATHER_MAX_ROWS`` rows, the gather is ``one_hot(tid) @
    table``: the rows come out exact (products by 0 and 1, in float32), and
    the table's gradient is the matmul ``one_hot.T @ grad``, a sum in a
    fixed order.  That needs float32 matmuls without TF32, which keeps ten
    bits of mantissa: with ``torch.backends.cuda.matmul.allow_tf32`` set on
    a CUDA table it raises.  Every other call on a CUDA table takes the
    gather kernel pair (``gather_rows``: int32 ids, a contiguous table; a
    copy forward, a sum in a fixed order backward), and on a CPU table its
    plain version, ``gather_rows_reference``."""
    T = table.shape[0]
    if table.requires_grad and torch.is_grad_enabled() \
            and T <= ONEHOT_GATHER_MAX_ROWS:
        if table.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "gather_features: the one-hot gather needs full float32 "
                "matmuls; torch.backends.cuda.matmul.allow_tf32 is set")
        ids = torch.arange(T, device=table.device, dtype=tid.dtype)
        return (tid[..., None] == ids).to(table.dtype) @ table
    if table.is_cuda:
        return gather_rows(table, tid)
    return gather_rows_reference(table, tid)


def park_pose(scene: Scene):
    """Guaranteed-miss pose for dead rays: beyond the scene AABB's upper
    corner, pointing +x away from it.  The offset is relative to the
    extent, so it survives float32 rounding at large coordinates.

    Kept on the scene beside the host vertex arrays it was computed from,
    and reused while the scene returns those very arrays (until a vertex
    tensor is edited): the bounds of a 100k-triangle mesh take the host
    milliseconds, and the differentiable path asks twice a step."""
    hv = scene._fresh("_host_v")
    memo = getattr(scene, "_park_pose", None)
    if memo is not None and memo[0] is hv:
        return memo[1]
    v1h, v2h, v3h = (a[:scene.num_tris] for a in hv)
    hi = np.maximum(np.maximum(v1h, v2h), v3h).max(0)
    lo = np.minimum(np.minimum(v1h, v2h), v3h).min(0)
    off = max(1.0, 1e-3 * float((hi - lo).max()))
    pose = (tuple(float(x) + off for x in hi), (1.0, 0.0, 0.0))
    object.__setattr__(scene, "_park_pose", (hv, pose))
    return pose


def park_tensors(pose, shape, device):
    """The (origin, direction) of a :func:`park_pose`, each broadcast to
    ``shape + (3,)`` on ``device``.  Filled on the device: a host-to-device
    copy would synchronise."""
    return tuple(torch.stack([
        torch.full(shape, float(x), dtype=torch.float32, device=device)
        for x in p], dim=-1) for p in pose)


def trace_rays(table: torch.Tensor, intersect: IntersectFn,
               ray_o: torch.Tensor, ray_d: torch.Tensor, depth: int,
               rng_state: torch.Tensor, has_specular: bool = True,
               park_pose: Optional[tuple] = None,
               primary_intersect: Optional[IntersectFn] = None,
               live: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Trace a ray batch to radiance (..., 3).

    table: (T, 12) from :func:`shade_table`; intersect: (o, d) -> (t, tid);
    ray_o, ray_d: (..., 3); rng_state: (...,) uint32 values in int64.
    park_pose: optional ((3,), (3,)) guaranteed-miss (origin, direction);
    dead rays are moved there instead of keeping their last pose, so they
    fail every box test of the cluster kernel (and its optional ray sort
    packs them together).  The radiance is the same either way.
    primary_intersect: the intersector of bounce 0, where every ray starts
    at the camera (default ``intersect``).
    live: a list that receives, per bounce, the (...,) mask of the rays
    whose path is alive: the ray segments a path tracer must trace.
    """
    if park_pose is not None:
        park_o, park_d = park_tensors(park_pose, ray_o.shape[:-1],
                                      ray_o.device)
    thr = torch.ones_like(ray_o)
    rad = torch.zeros_like(ray_o)
    alive = torch.ones(ray_o.shape[:-1], dtype=torch.bool,
                       device=ray_o.device)
    for b in range(depth):
        if live is not None:
            live.append(alive)
        if b == 0 and primary_intersect is not None:
            t, tid = primary_intersect(ray_o, ray_d)
        else:
            t, tid = intersect(ray_o, ray_d)
        hit = (tid >= 0) & alive
        hitm = hit[..., None]

        feat = gather_features(table, torch.where(hit, tid, -1))
        albedo = feat[..., _ALBEDO]
        emit = feat[..., _EMIT]
        rough = feat[..., _ROUGH]
        n_geo = feat[..., _NORMAL]
        is_emit = feat[..., _IS_EMIT] > 0.5
        is_spec = feat[..., _IS_SPEC] > 0.5

        rad = rad + torch.where(hitm, thr * emit, 0.0)
        cont = hit & ~is_emit
        contm = cont[..., None]

        # Double-sided normal, flipped toward the incoming ray.
        n = torch.where((dot(n_geo, ray_d) < 0.0)[..., None], n_geo, -n_geo)

        rng_state, (u, v, cube) = mat.draw_bounce_uniforms(
            rng_state, has_specular)
        new_d = mat.hemisphere_sample(u, v, n)
        if has_specular:
            spec_d = mat.specular_sample(ray_d, n, rough, cube)
            new_d = torch.where(is_spec[..., None], spec_d, new_d)

        cos = dot(n, new_d)
        thr = thr * torch.where(contm, 2.0 * albedo * cos[..., None], 1.0)
        hit_p = ray_o + ray_d * t[..., None]
        if park_pose is not None:
            ray_o = torch.where(contm, hit_p + n * SHIFT_BIAS, park_o)
            ray_d = torch.where(contm, new_d, park_d)
        else:
            ray_o = torch.where(contm, hit_p + n * SHIFT_BIAS, ray_o)
            ray_d = torch.where(contm, new_d, ray_d)
        alive = cont
    return rad


def sample_radiance(camera: Camera, scene: Scene, table: torch.Tensor,
                    w: torch.Tensor, h: torch.Tensor, sidx: torch.Tensor,
                    depth: int, seed: int,
                    intersect: Optional[IntersectFn] = None,
                    park_pose: Optional[tuple] = None,
                    primary_intersect: Optional[IntersectFn] = None,
                    live: Optional[List[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Radiance (S, *w.shape, 3) of the samples ``sidx`` (S,) at pixels
    (w, h): per-(pixel, sample) seed, two jitter draws, camera ray, then
    :func:`trace_rays` over ``intersect`` (default
    :func:`intersect_brute`; ``primary_intersect`` and ``live`` as in
    :func:`trace_rays`).  This is the whole per-sample path of the tile
    driver and of the megakernel's plain version."""
    sidx = sidx.reshape((-1,) + (1,) * w.dim())
    state = sample_seed(w[None], h[None], camera.height, sidx, seed)
    state, u1 = rand01(state)
    state, u2 = rand01(state)
    ray_o, ray_d = get_rays(camera, w[None], h[None], u1, u2)

    if intersect is None:
        def intersect(o, d):
            return intersect_brute(o, d, scene.v1, scene.v2, scene.v3)

    return trace_rays(table, intersect, ray_o, ray_d, depth, state,
                      has_specular=scene.has_specular, park_pose=park_pose,
                      primary_intersect=primary_intersect, live=live)
