"""Render drivers (L4), the PyTorch counterpart of ``pathtracer_tpu/render.py``.

Backends:
  * ``"cuda"`` — the hand-written CUDA megakernel (ops/cuda/trace_kernel.py)
    for scenes of up to 512 triangles, one launch per window of about 2^24
    ray segments.
  * ``"beam"`` — the hand-written CUDA coherent-beam kernel for large scenes
    (ops/cuda/beam_kernel.py): all pixels of a 2048-pixel tile share the
    bounce uniforms (tile-correlated noise, unbiased per pixel).
  * ``"cluster"`` — the tile driver over the hand-written CUDA cluster
    intersection (ops/cuda/cluster_kernel.py), with per-pixel independent
    sampling; dead rays park at a guaranteed-miss pose.
  * ``"bvh"`` — the tile driver over per-ray BVH traversal in plain
    PyTorch (ops/intersect.intersect_bvh).
  * ``"brute"`` — the tile driver over dense Möller–Trumbore against every
    triangle (ops/intersect.intersect_brute).
  * ``"wavefront"`` — the staged bounce pipeline (ops/wavefront.py) with
    its own ``"auto"`` intersector: brute up to ``BRUTE_MAX`` padded
    triangles, above that the CUDA cluster kernel (``"bvh"`` on a CPU
    scene).  Not resumable.
On a CPU scene each kernel's wrapper takes its plain version.

``"auto"`` on a CUDA scene picks ``"cuda"`` for up to ``BRUTE_MAX`` padded
triangles, above that ``"beam"``, or ``"cluster"`` with a warning when the
beam accel cannot represent the scene; it never picks a plain backend for a
CUDA scene, nor the wavefront.  On a CPU scene it picks ``"brute"``, or
``"bvh"`` above ``BRUTE_MAX``.

RNG: one independent hash stream per (pixel, sample), consumed jitter
first, then the bounces.  Sample windows therefore sum exactly, which the
checkpointed drivers rely on.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch

from . import rng as prng
from .bvh import FlatBVH, build_bvh
from .camera import Camera, get_rays
from .clusters import MAX_BEAM_SC, ClusterSet, build_clusters
from .image import Film
from .linalg import dot
from .ops import trace as trace_ops
from .ops.cuda import beam_kernel, cluster_kernel, trace_kernel
from .ops.intersect import intersect_brute, intersect_bvh
from .scene import Scene
from .utils import checkpoint as ckpt
from .utils.profiling import trace_annotation
from .utils.timer import Timer

BRUTE_MAX = 512                  # max padded triangle count for the dense path
TARGET_RAYS_PER_PASS = 1 << 21   # rays traced per tile pass
TARGET_RAYS_PER_CALL = 1 << 24   # rays per schedule entry

BACKENDS = ("brute", "cuda", "bvh", "cluster", "beam", "wavefront")


def _plan(width: int, height: int, samples: int, n_tris: int,
          backend: str = "brute"):
    """(tile_h, spp_b, blocks_per_call) for the tile driver.  The dense
    intersector holds O(rays * n_tris) floats, so its per-pass ray budget
    shrinks for bigger scenes; the cluster backend's memory is O(rays), so
    it takes the full budget.  The last row tile may be ragged."""
    if backend == "cluster":
        per_pass = TARGET_RAYS_PER_PASS
    else:
        per_pass = max(1 << 16, TARGET_RAYS_PER_PASS // max(1, n_tris // 32))
    tile_h = max(1, min(height, per_pass // max(1, width)))
    spp_b = max(1, min(samples, per_pass // (tile_h * width)))
    blocks = max(1, min(samples // spp_b,
                        TARGET_RAYS_PER_CALL // (tile_h * width * spp_b)))
    return tile_h, spp_b, blocks


def _auto_backend(camera: Camera, scene: Scene) -> str:
    """The backend ``"auto"`` picks; see the module docstring."""
    on_cuda = scene.device.type == "cuda"
    if scene.padded_size <= BRUTE_MAX:
        return "cuda" if on_cuda else "brute"
    if not on_cuda:
        return "bvh"
    try:
        accel = beam_kernel._accel_for(scene)
        if accel.num_superclusters <= MAX_BEAM_SC:
            return "beam"
        reason = (f"{accel.num_superclusters} superclusters > "
                  f"{MAX_BEAM_SC}")
    except ValueError as e:
        reason = str(e)
    warnings.warn(
        f"auto backend: falling back from the beam kernel to the slower "
        f"'cluster' path: {reason}", stacklevel=3)
    return "cluster"


def _sample_schedule(samples: int, spp_b: int, blocks: int):
    """Deterministic [(sidx0, spp, n_blocks), ...] covering [0, samples),
    derived from the TOTAL sample count only, so a resumed render blocks
    and accumulates exactly as an uninterrupted one."""
    sched = []
    s = 0
    while s < samples:
        nb = min(blocks, (samples - s) // spp_b)
        if nb == 0:
            nb, this_spp = 1, samples - s
        else:
            this_spp = spp_b
        sched.append((s, this_spp, nb))
        s += this_spp * nb
    return sched


def _scene_keys(scene: Scene) -> dict:
    """The scene's checkpoint keys: the JAX package's float sum, and the
    byte fingerprint, which the sum is not (an edit of ``v2``, ``v3``,
    emission, roughness or the material types leaves the sum unchanged)."""
    return {"scene_sum": float(scene.host_verts()[0].sum()
                               + scene.host_materials()[1].sum()),
            "scene_fingerprint": list(scene.fingerprint())}


def _resume(checkpoint: Optional[str], meta: dict, film: torch.Tensor,
            verbose: bool):
    """(film, samples_done) from ``checkpoint`` if it exists.  A saved meta
    without ``scene_fingerprint`` was written by the JAX package, and is
    compared on the keys it has."""
    if checkpoint is None or not os.path.exists(ckpt.checkpoint_path(
            checkpoint)):
        return film, 0
    film_sum, samples_done, saved = ckpt.load_render_checkpoint(checkpoint)
    want = (meta if "scene_fingerprint" in saved else
            {k: v for k, v in meta.items() if k != "scene_fingerprint"})
    if saved != want:
        raise ValueError(
            f"checkpoint {checkpoint} was written by a different render "
            f"config:\n  saved: {saved}\n  this:  {want}")
    if verbose:
        print(f"Resuming at sample {samples_done}/{meta['samples']}.")
    return torch.from_numpy(film_sum).to(film.device), samples_done


def _tile_sum(camera: Camera, scene: Scene, table: torch.Tensor, h0: int,
              tile_h: int, sidx0: int, spp_b: int, n_blocks: int,
              depth: int, seed: int, intersect=None,
              park=None) -> torch.Tensor:
    """Radiance sum of rows [h0, h0 + tile_h) over ``n_blocks`` blocks of
    ``spp_b`` samples from ``sidx0``."""
    width = camera.width
    dev = scene.device
    w = torch.arange(width, device=dev).expand(tile_h, width)
    h = torch.arange(h0, h0 + tile_h, device=dev)[:, None].expand(tile_h,
                                                                  width)
    acc = torch.zeros((tile_h, width, 3), dtype=torch.float32, device=dev)
    for k in range(n_blocks):
        sidx = torch.arange(sidx0 + k * spp_b, sidx0 + (k + 1) * spp_b,
                            device=dev)
        rad = trace_ops.sample_radiance(camera, scene, table, w, h, sidx,
                                        depth, seed, intersect=intersect,
                                        park_pose=park)
        acc = acc + rad.sum(dim=0)
    return acc


def _flat(fn):
    """An (o, d) -> (t, tid) intersector over any ray shape, from one over
    flat (R, 3) batches."""
    def intersect(o, d):
        t, tid = fn(o.reshape(-1, 3), d.reshape(-1, 3))
        return t.reshape(o.shape[:-1]), tid.reshape(o.shape[:-1])
    return intersect


def _tile_intersect(backend: str, scene: Scene, accel):
    """(intersect, park pose) of the tile driver's backend; ``accel`` is
    the caller's FlatBVH or ClusterSet, or None (the cluster set then comes
    from ``cluster_kernel.clusters_for``'s cache)."""
    dev = scene.device
    if backend == "brute":
        return None, None
    if backend == "bvh":
        bvh = (accel if isinstance(accel, FlatBVH)
               else build_bvh(scene)).to(dev)
        fn = _flat(lambda o, d: intersect_bvh(
            o, d, bvh, scene.v1, scene.v2, scene.v3, bvh.max_leaf,
            bvh.stack_size()))
    else:
        if isinstance(accel, ClusterSet):
            cs = accel.to(dev)
        elif accel is None:
            cs = cluster_kernel.clusters_for(scene)
        else:
            cs = build_clusters(scene, bvh=accel).to(dev)
        fn = _flat(lambda o, d: cluster_kernel.intersect_clusters(o, d, cs))
    # Dead rays park at a guaranteed-miss pose outside the scene box, where
    # they fail every cluster box test (and the optional ray sort packs
    # them into blocks of their own).
    return fn, trace_ops.park_pose(scene)


def render_film(camera: Camera, scene: Scene, samples: int, depth: int = 5,
                *, bvh=None, seed: int = prng.SEED, backend: str = "auto",
                verbose: bool = False, checkpoint: Optional[str] = None,
                checkpoint_every: int = 1,
                _abort_after: Optional[int] = None) -> Film:
    """Render the sample-averaged LINEAR film (no gamma) on the scene's
    device.

    bvh: an optional prebuilt ``FlatBVH`` (backends "bvh" and "cluster")
    or ``ClusterSet`` ("cluster").
    checkpoint: path to a .npz resume file.  If it exists the render resumes
    at the recorded sample and gives a film BIT-IDENTICAL to an
    uninterrupted run; otherwise it is created and updated every
    ``checkpoint_every`` completed schedule entries.
    ``_abort_after``: testing hook — save and abort after this many
    schedule entries.
    The span ``pt.render_film`` covers the whole call, the choice of the
    ``"auto"`` backend included.
    """
    with trace_annotation("pt.render_film"):
        if scene.num_tris == 0:
            raise ValueError("No triangles in scene.")
        if backend == "auto":
            backend = _auto_backend(camera, scene)
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not in {BACKENDS}")
        if backend in ("cuda", "beam"):
            if checkpoint is None:
                if backend == "cuda":
                    return trace_kernel.render_film_cuda(
                        camera, scene, samples, depth, seed=seed)
                return beam_kernel.render_film_beam(camera, scene, samples,
                                                    depth, seed=seed)
            return _render_windows_checkpointed(
                backend, camera, scene, samples, depth, seed=seed,
                checkpoint=checkpoint, checkpoint_every=checkpoint_every,
                verbose=verbose, _abort_after=_abort_after)
        if backend == "wavefront":
            if checkpoint is not None:
                raise ValueError(
                    "backend='wavefront' does not support checkpointing "
                    "(the render keeps no host-visible sample boundary to "
                    "save at); use backend='cuda', 'beam' or the tile "
                    "backends for resumable renders")
            from .ops.wavefront import render_wavefront
            return Film(camera.res, data=render_wavefront(
                camera, scene, samples, depth, bvh=bvh, seed=seed))

        width, height = camera.res
        tile_h, spp_b, blocks = _plan(width, height, samples,
                                      scene.padded_size, backend)
        intersect, park = _tile_intersect(backend, scene, bvh)
        table = trace_ops.shade_table(scene)
        sched = _sample_schedule(samples, spp_b, blocks)
        meta = {"width": width, "height": height, "samples": samples,
                "depth": depth, "seed": seed, "backend": backend,
                "tile_h": tile_h, "spp_b": spp_b, **_scene_keys(scene)}
        film = torch.zeros((height, width, 3), dtype=torch.float32,
                           device=scene.device)
        film, samples_done = _resume(checkpoint, meta, film, verbose)

        for ei, (s0, this_spp, nb) in enumerate(sched):
            if s0 < samples_done:
                continue
            for h0 in range(0, height, tile_h):
                th = min(tile_h, height - h0)
                film[h0:h0 + th] += _tile_sum(camera, scene, table, h0, th,
                                              s0, this_spp, nb, depth, seed,
                                              intersect, park)
            samples_done = s0 + this_spp * nb
            if verbose:
                print(f"\rRendered: {samples_done}/{samples} spp.", end="",
                      flush=True)
            if checkpoint is not None and (
                    ei % checkpoint_every == checkpoint_every - 1
                    or samples_done >= samples):
                ckpt.save_render_checkpoint(checkpoint, film, samples_done,
                                            meta)
            if _abort_after is not None and ei + 1 >= _abort_after:
                if checkpoint is not None:
                    ckpt.save_render_checkpoint(checkpoint, film, samples_done,
                                                meta)
                raise KeyboardInterrupt(
                    f"aborted after {ei + 1} schedule entries (test hook)")
        if verbose:
            print()
        return Film((width, height), data=film / samples)


def _render_windows_checkpointed(backend: str, camera: Camera,
                                 scene: Scene, samples: int, depth: int, *,
                                 seed: int, checkpoint: str,
                                 checkpoint_every: int = 1,
                                 verbose: bool = False,
                                 _abort_after: Optional[int] = None) -> Film:
    """Resumable kernel render ("cuda" or "beam"): windows of one launch's
    samples, the film sum saved between windows.  The meta holds the JAX
    package's keys and the scene fingerprint, so a checkpoint the JAX
    package wrote resumes here (compared without the fingerprint)."""
    width, height = camera.res
    block_spp = max(1, min(samples, trace_kernel.RAYS_PER_CALL
                           // (width * height)))
    meta = {"width": width, "height": height, "samples": samples,
            "depth": depth, "seed": seed, "backend": backend,
            "block_spp": block_spp, **_scene_keys(scene)}
    film = torch.zeros((height, width, 3), dtype=torch.float32,
                       device=scene.device)
    film, samples_done = _resume(checkpoint, meta, film, verbose)

    if backend == "beam":
        accel = beam_kernel._accel_for(scene)

        def window(s0, spp):
            return beam_kernel.render_sum_beam(
                camera, scene, s0, spp, depth, seed=seed, accel=accel,
                spp_per_call=spp)
    else:
        def window(s0, spp):
            return trace_kernel.render_sum_cuda(
                camera, scene, s0, spp, depth, seed=seed, spp_per_call=spp)

    blocks_done = 0
    while samples_done < samples:
        spp = min(block_spp, samples - samples_done)
        film = film + window(samples_done, spp)
        samples_done += spp
        blocks_done += 1
        if blocks_done % checkpoint_every == 0 or samples_done >= samples:
            ckpt.save_render_checkpoint(checkpoint, film, samples_done, meta)
        if verbose:
            print(f"\rRendered: {samples_done}/{samples} spp.", end="",
                  flush=True)
        if _abort_after is not None and blocks_done >= _abort_after:
            ckpt.save_render_checkpoint(checkpoint, film, samples_done, meta)
            raise KeyboardInterrupt(
                f"aborted after {blocks_done} blocks (test hook)")
    if verbose:
        print()
    return Film((width, height), data=film / samples)


def render_normals(camera: Camera, scene: Scene) -> Film:
    """Debug view: first-hit double-sided normals, one centre ray per
    pixel."""
    width, height = camera.res
    dev = scene.device
    table = trace_ops.shade_table(scene)
    w = torch.arange(width, device=dev).expand(height, width)
    h = torch.arange(height, device=dev)[:, None].expand(height, width)
    half = torch.full((height, width), 0.5, dtype=torch.float32, device=dev)
    ray_o, ray_d = get_rays(camera, w, h, half, half)
    _, tid = intersect_brute(ray_o, ray_d, scene.v1, scene.v2, scene.v3)
    n = trace_ops.gather_features(table, tid)[..., 7:10]
    flip = torch.where(dot(n, ray_d)[..., None] < 0.0, 1.0, -1.0)
    return Film((width, height),
                data=torch.where((tid >= 0)[..., None], n * flip, 0.0))


def render_debug_uv(res) -> Film:
    """UV-gradient test image: color = |uv| over [-1, 1]^2."""
    width, height = int(res[0]), int(res[1])
    x = np.abs(np.linspace(-1, 1, width, dtype=np.float32))
    y = np.abs(np.linspace(-1, 1, height, dtype=np.float32))
    img = np.zeros((height, width, 3), np.float32)
    img[..., 0] = x[None, :]
    img[..., 1] = y[:, None]
    return Film((width, height), data=torch.from_numpy(img))


def render(camera: Camera, scene: Scene, samples: int, depth: int = 5,
           filename: Optional[str] = None, *, bvh=None,
           seed: int = prng.SEED, backend: str = "auto", gamma: float = 2.2,
           checkpoint: Optional[str] = None, verbose: bool = True) -> Film:
    """Full pipeline: trace, average, gamma-correct, optionally save a PNG.
    Returns the gamma-corrected film and prints wall-clock time and rays/s
    (width * height * samples * depth ray segments over the wall time,
    device work included)."""
    timer = Timer(scene.device)
    film = render_film(camera, scene, samples, depth, bvh=bvh, seed=seed,
                       backend=backend, checkpoint=checkpoint,
                       verbose=verbose)
    seconds = timer.seconds()
    if verbose:
        w, h = camera.res
        rays = w * h * samples * depth
        print(f"Done in {seconds:.2f} seconds "
              f"({rays / max(seconds, 1e-9):.3e} rays/s).")
    film.gamma_correct(gamma)
    if filename:
        film.save_png(filename)
        if verbose:
            print(f"Saved to {filename}")
    return film
