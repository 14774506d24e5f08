"""Sharded rendering and training over the (tile, sample) rank grid, the
PyTorch counterpart of ``pathtracer_tpu/parallel/shard.py``.

Layout, as the JAX package's:

  * scene, camera, shade table — replicated on every rank;
  * film rows — banded over the ``tile`` axis: each rank traces its own
    horizontal band (the kernels' ``h0`` row offset, or the beam kernel's
    ``tile0`` Morton-tile offset, make band rows bit-identical to the same
    rows of a full-film launch);
  * samples — windowed over the ``sample`` axis: each rank traces a
    disjoint window of global sample indices (every (pixel, sample) pair
    owns its RNG stream), and a band's window sums are reduced over the
    ``sample`` group;
  * material gradients — computed per rank and averaged over every rank
    before the optimizer step, so every rank holds the same parameters.

Each entry point returns the full film on every rank.  The reductions are
``distributed.all_gather`` + ``ordered_sum``: window sums are added in
rank order, as a single process adds the same windows.  The JAX kernel
paths' power-of-two width and 128-lane band rules belong to the TPU and
are not carried over.
"""

from __future__ import annotations

import torch

from .. import rng as prng
from ..camera import Camera
from ..clusters import MAX_BEAM_SC
from ..diff import _make_intersect
from ..image import Film
from ..inverse import ADAM_BETAS, ADAM_EPS
from ..ops import trace as trace_ops
from ..ops.cuda import beam_kernel as bk
from ..ops.cuda import trace_kernel as tk
from ..render import TARGET_RAYS_PER_PASS
from ..scene import Scene
from ..utils.profiling import trace_annotation
from .distributed import all_gather, ordered_sum
from .mesh import SAMPLE_AXIS, TILE_AXIS, RankMesh


def _trace_band(camera: Camera, scene: Scene, table: torch.Tensor, h0: int,
                band_h: int, sample0: int, spp: int, depth: int,
                seed: int) -> torch.Tensor:
    """Radiance SUM (band_h, W, 3) of rows [h0, h0 + band_h) over the
    samples [sample0, sample0 + spp), by the plain path over the chunked
    dense intersection; differentiable in ``table``."""
    width = camera.width
    dev = scene.device
    intersect, _ = _make_intersect(scene, "brute", None)
    w = torch.arange(width, device=dev).expand(band_h, width)
    h = torch.arange(h0, h0 + band_h, device=dev)[:, None].expand(band_h,
                                                                  width)
    block = max(1, TARGET_RAYS_PER_PASS // (band_h * width))
    acc = torch.zeros((band_h, width, 3), dtype=torch.float32, device=dev)
    for s in range(0, spp, block):
        sidx = torch.arange(sample0 + s, sample0 + min(spp, s + block),
                            device=dev)
        acc = acc + trace_ops.sample_radiance(
            camera, scene, table, w, h, sidx, depth, seed,
            intersect=intersect).sum(dim=0)
    return acc


def _split(mesh: RankMesh, camera: Camera, samples: int):
    """(band_h, spp_local) of the banded layout; raises as JAX does when
    the film or the samples do not divide."""
    height = camera.height
    n_tile, n_sample = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    if height % n_tile or samples % n_sample:
        raise ValueError(
            f"height {height} % tile {n_tile} or samples {samples} % "
            f"sample {n_sample} != 0")
    return height // n_tile, samples // n_sample


def _reduce_bands(mesh: RankMesh, band_sum: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """The full film sum from each rank's band sum: the band's windows
    added over the ``sample`` group in rank order, then the bands joined
    along ``dim`` over the ``tile`` group."""
    band = ordered_sum(all_gather(band_sum, mesh.groups[SAMPLE_AXIS],
                                  mesh.shape[SAMPLE_AXIS]))
    return torch.cat(all_gather(band, mesh.groups[TILE_AXIS],
                                mesh.shape[TILE_AXIS]), dim=dim)


def _sample_only(mesh: RankMesh, samples: int) -> tuple:
    """(sample0, spp_local) of this rank when every rank takes a sample
    window of the whole film, in rank order."""
    n = mesh.size
    if samples % n:
        raise ValueError(f"samples {samples} % ranks {n} != 0")
    ti, si = mesh.coords
    spp_local = samples // n
    return (ti * mesh.shape[SAMPLE_AXIS] + si) * spp_local, spp_local


def render_film_sharded(mesh: RankMesh, camera: Camera, scene: Scene,
                        samples: int, depth: int = 5, *,
                        seed: int = prng.SEED) -> Film:
    """Distributed render by the plain path: rows over ``tile``, samples
    over ``sample``.  Requires height % tile == 0 and samples % sample
    == 0."""
    band_h, spp_local = _split(mesh, camera, samples)
    ti, si = mesh.coords
    with torch.no_grad():
        acc = _trace_band(camera, scene, trace_ops.shade_table(scene),
                          ti * band_h, band_h, si * spp_local, spp_local,
                          depth, seed)
    return Film(camera.res, data=_reduce_bands(mesh, acc, 0) / samples)


def render_film_sharded_cuda(mesh: RankMesh, camera: Camera, scene: Scene,
                             samples: int, depth: int = 5, *,
                             seed: int = prng.SEED) -> Film:
    """Distributed render through the trace kernel (``render_sum_cuda``;
    its plain version on a CPU scene).  Banded when height % tile == 0 and
    samples % sample == 0: each rank launches on its own film band and
    sample window, and the sums are reduced over ``sample`` only, so a
    (tile, 1) grid gives the single-process film bit for bit.  Otherwise
    every rank takes a sample window of the whole film and the sums are
    reduced over every rank."""
    height = camera.height
    n_tile, n_sample = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    ti, si = mesh.coords
    if height % n_tile == 0 and samples % n_sample == 0:
        band_h, spp_local = height // n_tile, samples // n_sample
        with trace_annotation("pt.shard.band"):
            acc = tk.render_sum_cuda(camera, scene, si * spp_local,
                                     spp_local, depth, seed=seed,
                                     h0=ti * band_h, band_h=band_h)
        with trace_annotation("pt.shard.gather"):
            film = _reduce_bands(mesh, acc, 0)
    else:
        sample0, spp_local = _sample_only(mesh, samples)
        with trace_annotation("pt.shard.band"):
            acc = tk.render_sum_cuda(camera, scene, sample0, spp_local,
                                     depth, seed=seed)
        with trace_annotation("pt.shard.gather"):
            film = ordered_sum(all_gather(acc, None, mesh.size))
    return Film(camera.res, data=film / samples)


def render_film_sharded_beam(mesh: RankMesh, camera: Camera, scene: Scene,
                             samples: int, depth: int = 5, *,
                             seed: int = prng.SEED) -> Film:
    """Distributed render through the coherent-beam kernel
    (``render_tiles_beam``; its plain version on a CPU scene).  The padded
    film's Morton tiles band over ``tile`` (each rank launches on its own
    tile range through ``tile0``), samples window over ``sample``, and the
    sums are reduced over ``sample`` only.  Banded only when every rank's
    tiles cover whole 64x64 square-rows and samples % sample == 0;
    otherwise every rank takes a sample window of the whole film."""
    width, height = camera.res
    n_tile, n_sample = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    ti, si = mesh.coords
    accel = bk._accel_for(scene)
    if accel.num_superclusters > MAX_BEAM_SC:
        raise ValueError(f"{accel.num_superclusters} superclusters > "
                         f"{MAX_BEAM_SC}; rebuild with larger sc_tris")
    wp, hp = bk._padded_res(width, height)
    n_tiles = wp * hp // bk.TILE_PX
    tiles_per_sqrow = (wp // bk._SQ) * (bk._SQ_PIX // bk.TILE_PX)
    if (n_tiles % n_tile == 0
            and (n_tiles // n_tile) % tiles_per_sqrow == 0
            and samples % n_sample == 0):
        tiles_local, spp_local = n_tiles // n_tile, samples // n_sample
        with trace_annotation("pt.shard.band"):
            acc = bk.render_tiles_beam(camera, scene, si * spp_local,
                                       spp_local, depth, seed=seed,
                                       accel=accel, tile0=ti * tiles_local,
                                       n_tiles=tiles_local)
        with trace_annotation("pt.shard.gather"):
            flat = _reduce_bands(mesh, acc, 1)
    else:
        sample0, spp_local = _sample_only(mesh, samples)
        with trace_annotation("pt.shard.band"):
            acc = bk.render_tiles_beam(camera, scene, sample0, spp_local,
                                       depth, seed=seed, accel=accel)
        with trace_annotation("pt.shard.gather"):
            flat = ordered_sum(all_gather(acc, None, mesh.size))
    return Film(camera.res, data=bk._to_raster(flat, width, height) / samples)


def make_sharded_train_step(mesh: RankMesh, camera: Camera, scene: Scene,
                            target, samples: int, depth: int = 5, *,
                            seed: int = prng.SEED, optimizer=None,
                            param_transform=None):
    """A sharded inverse-rendering train step.

    Each rank renders its film band (the plain path over the dense
    intersection) over the sample window ``si * spp_local + step_idx *
    samples``, and takes the MSE of the band against ``target``'s band;
    the loss and every gradient are averaged over all ranks before the
    optimizer steps, so every rank holds bit-identical parameters.
    Returns ``(step, init)``: ``init(params)`` makes the unconstrained
    ``params`` (a dict of tensors on the scene's device) the optimizer's
    leaves and returns the optimizer, the state;
    ``step(params, opt_state, step_idx) -> (params, opt_state, loss)``
    updates ``params`` in place.  ``optimizer``: a function of the leaf
    list to a ``torch.optim`` optimizer (default Adam at 2e-2 with optax's
    defaults); ``param_transform``: unconstrained -> physical materials
    (default the identity; ``inverse.to_materials`` for the transforms of
    ``inverse.py``)."""
    if optimizer is None:
        def optimizer(leaves):
            return torch.optim.Adam(leaves, lr=2e-2, betas=ADAM_BETAS,
                                    eps=ADAM_EPS)
    if param_transform is None:
        def param_transform(p):
            return p
    band_h, spp_local = _split(mesh, camera, samples)
    ti, si = mesh.coords
    n = mesh.size
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=scene.device)
    target_band = target[ti * band_h:(ti + 1) * band_h]

    def init(params):
        leaves = [params[k].requires_grad_(True) for k in sorted(params)]
        return optimizer(leaves)

    def step(params, opt_state, step_idx):
        leaves = [params[k] for k in sorted(params)]
        if ([id(p) for g in opt_state.param_groups for p in g["params"]]
                != [id(p) for p in leaves]):
            raise ValueError("step: params are not the leaves init() gave "
                             "the optimizer")
        sc = scene.replace_materials(**param_transform(params))
        acc = _trace_band(camera, sc, trace_ops.shade_table(sc),
                          ti * band_h, band_h,
                          si * spp_local + int(step_idx) * samples,
                          spp_local, depth, seed)
        loss = torch.mean((acc / spp_local - target_band) ** 2)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))]
        # Bands partition the pixels and sample windows are independent
        # estimates of a band's loss, so both average over every rank.
        flat = torch.cat([loss.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        flat = ordered_sum(all_gather(flat, None, n)) / n
        o = 1
        for p in leaves:
            p.grad = flat[o:o + p.numel()].reshape(p.shape)
            o += p.numel()
        opt_state.step()
        return params, opt_state, flat[0]

    return step, init
