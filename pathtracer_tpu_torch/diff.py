"""Differentiable rendering: pixel gradients with respect to the material
parameters, the PyTorch counterpart of ``pathtracer_tpu/diff.py``.

Estimator (the JAX package's, unchanged): *detached sampling with
reparameterized speculars*.  For a fixed seed the per-(pixel, sample) hash
streams make the render a deterministic, piecewise-smooth function of the
material tensors, and autograd through the forward accumulation of
``ops/trace.trace_rays`` gives the standard estimator:

* albedo and emission enter the radiance polynomially through the
  throughput chain, so their gradients are exact per path;
* roughness enters through the specular jitter, smooth for fixed uniforms
  (the reparameterization trick); its pathwise gradient sees only the
  within-surface variation, not which surface the blurred reflection hits,
  which is why ``inverse.recover_materials`` takes SPSA for roughness;
* hit ids and normals are discrete: every intersector gets DETACHED rays
  (``_make_intersect``), as the JAX package's ``stop_gradient``, so no
  graph is recorded through the brute temporaries or the kernel's inputs,
  and visibility-boundary terms are ignored by design.

The gradient runs through plain PyTorch only: the shade-table gather
(``ops/trace.gather_features``) and the bounce loop.  The intersection is
the backend's: ``"brute"`` (dense Möller–Trumbore: on a CUDA scene the
brute kernel, one launch a bounce; on the CPU in chunks of rays),
``"bvh"`` (per-ray BVH traversal; ``"bvh-gather"`` is an alias, the JAX
package's name for it) or ``"cluster"`` (the CUDA cluster kernel, which on
a CUDA scene launches or raises).  Finite differences of the same
fixed-seed function see the same discontinuities, so ``gradcheck`` holds
without smoothing.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import rng as prng
from .bvh import build_bvh
from .camera import Camera
from .ops import trace as trace_ops
from .ops.cuda import brute_kernel, cluster_kernel
from .ops.intersect import intersect_brute
from .render import _tile_intersect
from .scene import Scene
from .utils.profiling import trace_annotation

MaterialParams = Dict[str, torch.Tensor]  # albedo (T,3), emit (T,3), roughness (T,)

BACKENDS = ("brute", "bvh", "cluster")
_ALIASES = {"bvh-gather": "bvh"}

# Ray-triangle pairs of one chunk of the brute intersection on the CPU:
# each of its (rays, T, 3) temporaries then holds about 0.8 GB, where a
# whole 128^2, 192-spp half-render would need 1.2 GB for each of several.
BRUTE_PAIRS = 1 << 26


def material_params(scene: Scene) -> MaterialParams:
    """The differentiable material tensors of a scene."""
    return {"albedo": scene.albedo, "emit": scene.emit,
            "roughness": scene.roughness}


def _backend(backend: str) -> str:
    backend = _ALIASES.get(backend, backend)
    if backend not in BACKENDS:
        raise ValueError(f"unknown diff backend {backend!r} "
                         f"(use one of {BACKENDS} or 'bvh-gather')")
    return backend


def _intersect_brute_chunked(scene: Scene):
    """Dense intersection, each ray's hit the one ``intersect_brute`` gives
    the whole batch: on a CUDA scene one launch of the brute kernel a call
    (``ops/cuda/brute_kernel``, memory O(rays)); on a CPU scene
    ``intersect_brute`` over flat chunks of at most BRUTE_PAIRS / T rays."""
    v1, v2, v3 = scene.v1, scene.v2, scene.v3
    if scene.device.type == "cuda":
        def intersect_cuda(o, d):
            return brute_kernel.intersect_brute_cuda(
                o.contiguous(), d.contiguous(), v1, v2, v3)
        return intersect_cuda
    chunk = max(1, BRUTE_PAIRS // scene.padded_size)

    def intersect(o, d):
        shape = o.shape[:-1]
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        parts = [intersect_brute(o[r:r + chunk], d[r:r + chunk], v1, v2, v3)
                 for r in range(0, o.shape[0], chunk)]
        return (torch.cat([t for t, _ in parts]).reshape(shape),
                torch.cat([i for _, i in parts]).reshape(shape))
    return intersect


def _make_intersect(scene: Scene, backend: str, accel):
    """(intersect, park pose) for the differentiable path.  The rays reach
    every backend detached: the hit is discrete, geometry carries no
    gradient, and a recorded graph would hold the brute temporaries (the
    rays depend on roughness through the specular sample) or the kernel
    wrapper's ray concatenation for nothing."""
    if backend == "brute":
        fn, park = _intersect_brute_chunked(scene), None
    else:
        fn, park = _tile_intersect(backend, scene, accel)

    def intersect(o, d):
        return fn(o.detach(), d.detach())
    return intersect, park


def make_accel(scene: Scene, backend: str):
    """The acceleration structure of ``backend`` on the scene's device:
    None for "brute", a FlatBVH for "bvh", the cached ClusterSet
    (``cluster_kernel.clusters_for``) for "cluster".  Geometry carries no
    gradient, so it is built once from the base scene and reused across
    optimizer steps."""
    backend = _backend(backend)
    if backend == "brute":
        return None
    if backend == "bvh":
        return build_bvh(scene).to(scene.device)
    return cluster_kernel.clusters_for(scene)


def render_film_diff(camera: Camera, scene: Scene, params: MaterialParams,
                     samples: int, depth: int = 5, *, seed: int = prng.SEED,
                     sample_offset: int = 0, backend: str = "brute",
                     accel=None) -> torch.Tensor:
    """Differentiable LINEAR film (H, W, 3): the mean over the samples
    ``[sample_offset, sample_offset + samples)`` of every pixel, traced in
    one pass, as a function of ``params`` (albedo, emit, roughness; any
    subset, the rest the scene's).  Disjoint sample windows average to the
    film of their union.  ``accel`` (from :func:`make_accel`) saves the
    build across calls.  The span ``pt.diff.render`` covers the whole
    call: two a paired recovery step."""
    with trace_annotation("pt.diff.render"):
        backend = _backend(backend)
        if backend != "brute" and accel is None:
            accel = make_accel(scene, backend)
        intersect, park = _make_intersect(scene, backend, accel)
        table = trace_ops.shade_table(scene.replace_materials(**params))
        width, height = camera.res
        dev = scene.device
        w = torch.arange(width, device=dev).expand(height, width)
        h = torch.arange(height, device=dev)[:, None].expand(height, width)
        sidx = torch.arange(sample_offset, sample_offset + samples,
                            device=dev)
        rad = trace_ops.sample_radiance(camera, scene, table, w, h, sidx,
                                        depth, seed, intersect=intersect,
                                        park_pose=park)
        return rad.mean(dim=0)


def make_loss(camera: Camera, scene: Scene, target, samples: int,
              depth: int = 5, *, seed: int = prng.SEED,
              backend: str = "brute"):
    """``loss(params, sample_offset=0)``: the mean squared difference of
    :func:`render_film_diff` from ``target`` (H, W, 3), with the
    acceleration structure built once."""
    accel = make_accel(scene, backend)
    target = torch.as_tensor(target, dtype=torch.float32, device=scene.device)

    def loss(params: MaterialParams, sample_offset: int = 0):
        film = render_film_diff(camera, scene, params, samples, depth,
                                seed=seed, sample_offset=sample_offset,
                                backend=backend, accel=accel)
        return torch.mean((film - target) ** 2)

    return loss


def gradcheck(f, params: MaterialParams, *, eps: float = 1e-3,
              indices: Optional[list] = None, mode: str = "central"):
    """Compare the autograd gradient of the scalar ``f(params)`` against
    finite differences.  Returns (max_abs_err, max_rel_err) over the probed
    coordinates; ``indices``: (key, flat index) pairs, by default every
    coordinate of every tensor.

    ``mode``: ``"central"``, central differences, right where the loss is
    smooth within +-eps; ``"one_sided"``, forward and backward differences,
    each coordinate scored by the side that agrees better: the fixed-seed
    render is only piecewise smooth in roughness (the specular sampler's
    accept/reject flips at isolated values), and next to a flip one side
    crosses the jump while the other measures the slope of the piece the
    estimator differentiates."""
    if mode not in ("central", "one_sided"):
        raise ValueError(f"unknown gradcheck mode {mode!r}")
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    grads = torch.autograd.grad(f(leaves), list(leaves.values()),
                                allow_unused=True)
    g = {k: (np.zeros(tuple(v.shape), np.float32) if gk is None
             else gk.detach().cpu().numpy())
         for (k, v), gk in zip(leaves.items(), grads)}
    if indices is None:
        indices = [(k, i) for k in params for i in range(params[k].numel())]

    def eval_at(key, i, delta):
        base = params[key].detach()
        flat = base.cpu().numpy().astype(np.float64).ravel()
        flat[i] += delta
        p = {**params, key: torch.from_numpy(
            flat.reshape(tuple(base.shape)).astype(np.float32)).to(
                base.device)}
        with torch.no_grad():
            return float(f(p))

    max_abs = max_rel = 0.0
    for key, i in indices:
        up = eval_at(key, i, eps)
        dn = eval_at(key, i, -eps)
        an = float(g[key].ravel()[i])
        if mode == "central":
            fds = [(up - dn) / (2 * eps)]
        else:
            mid = eval_at(key, i, 0.0)
            fds = [(up - mid) / eps, (mid - dn) / eps]
        fd = min(fds, key=lambda x: abs(x - an))
        err = abs(fd - an)
        max_abs = max(max_abs, err)
        max_rel = max(max_rel, err / max(abs(fd), abs(an), 1e-6))
    return max_abs, max_rel
