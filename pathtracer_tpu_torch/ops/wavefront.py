"""Wavefront path tracing: a staged bounce pipeline over SoA ray queues, the
PyTorch counterpart of ``pathtracer_tpu/ops/wavefront.py``.

The megakernel (``ops/cuda/trace_kernel.py``) gives every path a thread for
its whole life.  The wavefront instead runs each bounce as separate stages
over a queue of rays:

  stage                 CUDA wavefront              this module
  -------------------   -------------------------   -------------------------
  ray-gen               kernel over pixel queue     ``raygen`` (eager ops)
  traverse/intersect    persistent-threads kernel   backend intersect
                                                    (dense / per-ray BVH /
                                                    CUDA cluster kernel)
  shade/scatter         kernel + film atomics       ``bounce_stage`` + a
                                                    reshape-sum of the
                                                    block's contributions
                                                    by pixel (no atomics)
  compact               global stream compaction    PARKING: dead rays move
                                                    to a guaranteed-miss
                                                    pose, where they fail
                                                    every box test of the
                                                    cluster kernel; or, with
                                                    ``compact_every``, the
                                                    stable partition
                                                    ``compact``

Python loops run the sample blocks and the bounces.  Before every bounce
after the first, one host check (``bool(alive.any())``, a synchronisation)
skips the block's remaining bounces once its queue is empty.  The module
counts the checks (``SYNCS``), the bounce stages run (``LIVE_BOUNCES``: one
intersect call each, so one cluster-kernel launch each on the cluster
backend) and the bounces skipped (``SKIPPED``), as ``cluster_kernel``
counts its ``LAUNCHES``.

The film is deterministic.  A block's queue holds one ray per (sample,
pixel), sample-major, so a bounce's film is its contributions reshaped to
(samples, pixels, 3) and summed over the samples.  With compaction each
ray carries its block slot (``"slot"``) through ``compact``, and the
contributions are written back to their slots (unique indices) before the
same sum: ``compact_every=1`` and ``0`` give bit-identical films.

On a CUDA scene the only kernel on this path is the cluster kernel
(backend ``"cluster"``, which ``"auto"`` picks above 512 padded triangles);
every other stage is eager PyTorch.  ``render.render_film(backend=
"wavefront")`` routes here; its ``"auto"`` backend never picks it.

MEASURED on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
(one card run when this pipeline was ported, recorded in CHANGES.md
under the wavefront's bring-up; Cornell box, 512^2, 64 spp): the
megakernel renders in 6.54 ms at depth 5 and 10.52 ms at depth 16; this
pipeline on the cluster kernel in 158.42 ms and 467.12 ms (24x and 44x
behind), on the dense intersector in 1115.88 ms and 3533.51 ms;
explicit compaction adds 7.7% and 10.0%.  On sphere_in_box(50, 100)
(512^2, 16 spp) it takes 52.46 ms to render_film's cluster backend's
50.28 ms and trails the beam kernel (3.26 ms) 16x.  The cluster kernel
is 6.2-6.8% of the device time: every bounce runs ~150 eager launches
over the whole queue, dead rays included, and synchronises once, while
the megakernel's dead lanes cost it little (its segments/s double from
depth 5 to 16).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import materials as mat
from ..camera import get_rays
from ..diff import _intersect_brute_chunked
from ..linalg import SHIFT_BIAS, dot
from ..render import BRUTE_MAX, _tile_intersect
from ..rng import rand01, sample_seed
from ..scene import Scene
from .trace import (_ALBEDO, _EMIT, _IS_EMIT, _IS_SPEC, _NORMAL, _ROUGH,
                    gather_features, park_tensors, shade_table)

BACKENDS = ("brute", "bvh", "cluster")
BLOCK_RAYS = 1 << 21     # queue entries per sample block

SYNCS = 0          # any-alive host checks since the last reset
LIVE_BOUNCES = 0   # bounce stages run (intersect calls)
SKIPPED = 0        # bounces skipped because a block's queue was empty


def raygen(camera, w, h, state):
    """Stage 1: camera rays for pixel coords (R,) with jitter from the
    per-ray streams.  Returns (ray_o, ray_d, state)."""
    state, u1 = rand01(state)
    state, u2 = rand01(state)
    ray_o, ray_d = get_rays(camera, w, h, u1, u2)
    return ray_o, ray_d, state


def bounce_stage(table, intersect_fn, queue, has_specular: bool,
                 park=None):
    """One wavefront bounce: intersect + shade/scatter + continuation.

    queue: dict with ray_o, ray_d (R, 3); thr (R, 3); pix (R,); state (R,)
    uint32 values in int64; alive (R,) bool; any other key (the block slot
    of a compacting render) passes through.
    Returns (radiance_contrib (R, 3), new_queue).  The contribution is the
    per-ray ``throughput * emit`` of this bounce (zero for dead/missed).
    ``park``: optional ((3,), (3,)) miss pose for dead rays, floats or
    tensors on the queue's device (see the module docstring).
    """
    ray_o, ray_d = queue["ray_o"], queue["ray_d"]
    t, tid = intersect_fn(ray_o, ray_d)
    hit = (tid >= 0) & queue["alive"]

    feat = gather_features(table, torch.where(hit, tid, -1))
    albedo = feat[..., _ALBEDO]
    emit = feat[..., _EMIT]
    rough = feat[..., _ROUGH]
    n_geo = feat[..., _NORMAL]
    is_emit = feat[..., _IS_EMIT] > 0.5
    is_spec = feat[..., _IS_SPEC] > 0.5

    contrib = torch.where(hit[..., None], queue["thr"] * emit, 0.0)
    cont = hit & ~is_emit

    n = torch.where((dot(n_geo, ray_d) < 0.0)[..., None], n_geo, -n_geo)
    state, (u, v, cube) = mat.draw_bounce_uniforms(queue["state"],
                                                   has_specular)
    new_d = mat.hemisphere_sample(u, v, n)
    if has_specular:
        spec_d = mat.specular_sample(ray_d, n, rough, cube)
        new_d = torch.where(is_spec[..., None], spec_d, new_d)

    cos = dot(n, new_d)
    contm = cont[..., None]
    thr = queue["thr"] * torch.where(contm, 2.0 * albedo * cos[..., None],
                                     1.0)
    hit_p = ray_o + ray_d * t[..., None]

    if park is not None:
        dead_o, dead_d = (torch.as_tensor(p, dtype=torch.float32,
                                          device=ray_o.device)
                          for p in park)
    else:
        dead_o, dead_d = ray_o, ray_d

    new_queue = {
        **queue,
        "ray_o": torch.where(contm, hit_p + n * SHIFT_BIAS, dead_o),
        "ray_d": torch.where(contm, new_d, dead_d),
        "thr": thr,
        "state": state,
        "alive": cont,
    }
    return contrib, new_queue


def compact(queue):
    """Stable-partition live rays to the front; the queue keeps its length.
    Kept as the explicit-compaction reference point; the default pipeline
    parks dead rays instead (module docstring)."""
    order = torch.argsort(~queue["alive"], stable=True)
    return {k: v[order] for k, v in queue.items()}


def _make_intersect(scene: Scene, backend: str, accel):
    """(intersect, park pose) of ``backend``, resolved once per render:
    ``"brute"`` the dense test (``diff._intersect_brute_chunked``: the
    brute kernel on a CUDA scene, chunks of rays on the CPU), no park
    pose; ``"bvh"`` the per-ray ``intersect_bvh`` and ``"cluster"`` the
    CUDA cluster kernel, on ``accel`` or built (the cluster set from
    ``clusters_for``'s cache), as ``render_film``'s tile backends take
    them."""
    if backend == "brute":
        return _intersect_brute_chunked(scene), None
    return _tile_intersect(backend, scene, accel)


def render_wavefront(
    camera,
    scene: Scene,
    samples: int,
    depth: int = 5,
    *,
    bvh=None,
    seed: int = 1,
    backend: str = "auto",
    spp_per_block: Optional[int] = None,
    compact_every: int = 0,
) -> torch.Tensor:
    """Full wavefront render to a linear film (H, W, 3) on the scene's
    device.

    One queue entry per (sample-in-block, pixel); a loop over sample blocks
    and one over bounces, with the host's any-alive check between bounces.
    RNG streams are the standard per-(pixel, sample) ones, so the result
    matches ``render.render_film`` at equal seed and spp up to float32
    reassociation of the film sums.

    bvh: an optional prebuilt ``FlatBVH`` ("bvh", "cluster") or
    ``ClusterSet`` ("cluster").
    backend: "auto" (``"brute"`` up to ``BRUTE_MAX`` padded triangles,
    above that ``"cluster"`` on a CUDA scene and ``"bvh"`` on a CPU
    scene), or explicit "brute" | "bvh" | "cluster".
    spp_per_block: samples per block (default: about ``BLOCK_RAYS`` rays),
    lowered until it divides ``samples``.
    compact_every: if > 0, run the explicit ``compact`` every k bounces
    INSTEAD of parking (measurement/reference mode).
    """
    global SYNCS, LIVE_BOUNCES, SKIPPED
    width, height = camera.res
    npix = width * height
    dev = scene.device

    if backend == "auto":
        if scene.padded_size <= BRUTE_MAX:
            backend = "brute"
        else:
            backend = "cluster" if dev.type == "cuda" else "bvh"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not in {BACKENDS}")
    intersect_fn, park = _make_intersect(scene, backend, bvh)
    if park is not None and not compact_every:
        park = park_tensors(park, (), dev)
    else:
        park = None
    table = shade_table(scene)

    if spp_per_block is None:
        spp_per_block = max(1, min(samples, BLOCK_RAYS // npix))
    while samples % spp_per_block:
        spp_per_block -= 1
    n_blocks = samples // spp_per_block
    R = npix * spp_per_block

    pix = torch.arange(npix, dtype=torch.int32, device=dev).repeat(
        spp_per_block)
    w = pix % width
    h = pix // width
    s_in_block = torch.arange(spp_per_block, dtype=torch.int32,
                              device=dev).repeat_interleave(npix)

    film = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    for b in range(n_blocks):
        state = sample_seed(w, h, height, b * spp_per_block + s_in_block,
                            seed)
        ray_o, ray_d, state = raygen(camera, w, h, state)
        queue = {
            "ray_o": ray_o, "ray_d": ray_d,
            "thr": torch.ones((R, 3), dtype=torch.float32, device=dev),
            "pix": pix, "state": state,
            "alive": torch.ones((R,), dtype=torch.bool, device=dev),
        }
        if compact_every:
            queue["slot"] = torch.arange(R, device=dev)
        for k in range(depth):
            # The queue starts full: bounce 0 needs no check.
            if k:
                SYNCS += 1
                if not bool(queue["alive"].any()):
                    SKIPPED += depth - k
                    break
            contrib, queue = bounce_stage(table, intersect_fn, queue,
                                          scene.has_specular, park=park)
            LIVE_BOUNCES += 1
            if compact_every:
                contrib = torch.empty_like(contrib).index_copy_(
                    0, queue["slot"], contrib)
                if (k + 1) % compact_every == 0:
                    queue = compact(queue)
            film += contrib.view(spp_per_block, npix, 3).sum(dim=0)
    return (film / samples).reshape(height, width, 3)
