"""Coherent-beam large-scene renderer: host wrapper and plain version.

The kernel, ``csrc/beam_kernel.cu``, replaces
``pathtracer_tpu/ops/pallas/beam_kernel.py::_kernel``.  Per pixel of the
film padded to 64x64 squares it returns the radiance SUM over a sample
window, with coherent-beam sampling (Sadeghi et al. 2009): the camera
jitter comes from the pixel's own hash stream, and every bounce's uniforms
from one stream shared by the pixel's 2048-pixel tile, so all rays of a
tile bounce along one pair of directions (each ray flips the shared one to
its side of the surface).  Every pixel still gets ``spp`` independent
unbiased samples; only the noise between pixels of a tile is correlated.
Device order: Morton within each 64x64 square, squares row-major; the
wrapper de-interleaves and crops to (H, W, 3).

What bounds it on this card: fp32 issue in the box and triangle tests, and
divergence between the rays of a warp, which pay for the union of their
traversals.  Design: an exact per-ray traversal of the two-level
``BeamAccel``: a walk of its box tree over the superclusters (``sc_tree``,
in shared memory, near child first), the cluster boxes of each
supercluster entered, the 8 rows of each cluster entered.  Ties go to the
lower packed row and a box opens on ``tmin <= best_t``, so the film is that
of any exact nearest-hit traversal whatever its visit order: the plain
version, ``render_tiles_beam_reference``, tests every packed row densely.
The wrapper raises ``ValueError`` on a tree deeper than the kernel's stack.

Schedule (``launch_plan``): a block traces 256 adjacent device-order pixels
under one run of consecutive samples, the runs as long as still leave the
card ``LAUNCH_WAVES`` waves of resident blocks, so no launch waits long on
its slowest block; each sample's radiance goes to a scratch buffer and a
second kernel adds the samples to the film in sample order.

On a CUDA scene ``render_tiles_beam`` launches the kernel or raises; it
takes the plain version only when the scene lies on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ... import rng as prng
from ...camera import Camera
from ...clusters import (MAX_BEAM_SC, BeamAccel, build_beam_accel,
                         cached_accel)
from ...image import Film
from ...linalg import FLOAT_INF, SHIFT_BIAS, dot
from ...materials import _TWO_PI, SPECULAR_TRIES
from ...scene import Scene
from ...utils import build
from ...utils.profiling import trace_annotation
from ..intersect import (MOMENT_OPS, PLUCKER_OPS, SLAB_OPS, boxes_entered,
                         intersect_packed)
from .trace_kernel import MAX_DET, SHADE_OPS, _camera_params

TILE_PX = 2048        # pixels per tile sharing one bounce stream
_TILE_LOG2 = 11
_SQ = 64              # Morton square side
_SQ_PIX = _SQ * _SQ
_TILE_MIX = 0x9E377
SEGMENTS_PER_CALL = 1 << 25   # default launch size in ray segments
BLOCK_PX = 256        # pixels a block (csrc/beam_kernel.cu kThreads)
LAUNCH_WAVES = 8      # waves of resident blocks a launch is cut into, at least

LAUNCHES = 0          # sample windows launched since the last reset
BLOCKS = 0            # the kernel's blocks launched since the last reset

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
             + [ctypes.c_uint32] + [ctypes.c_int] * 3 + [ctypes.c_uint32]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])

_ACCEL_CACHE = []     # [((fingerprint, device), accel)], newest last
_RASTER_CACHE = {}    # (wp, hp, device) -> raster index tensor
_RESIDENT = {}        # (device, n_sc, tree depth, instance) -> blocks


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The kernel's grid for one launch of ``spp`` samples over ``n_pix``
    device-order pixels: block b traces the BLOCK_PX pixels from
    ``(b % pixel_blocks) * BLOCK_PX`` over the samples ``samples(b //
    pixel_blocks)``, the ``groups`` runs that cut [0, spp) into lengths
    differing by at most one."""
    n_pix: int
    spp: int
    groups: int

    @property
    def pixel_blocks(self) -> int:
        return self.n_pix // BLOCK_PX

    @property
    def blocks(self) -> int:
        return self.pixel_blocks * self.groups

    def samples(self, group: int) -> Tuple[int, int]:
        """The launch-relative samples [lo, hi) of run ``group``."""
        return (group * self.spp // self.groups,
                (group + 1) * self.spp // self.groups)


def launch_plan(n_pix: int, spp: int, resident: int) -> LaunchPlan:
    """The plan of a launch on a card that holds ``resident`` of the
    kernel's blocks at once: sample runs as long as still give
    LAUNCH_WAVES * resident blocks, or one sample a block where the launch
    has fewer (pixel, sample) blocks than that.  A block's work varies
    more than 2x across a film, and the launch lasts until its slowest
    block ends: with many waves the card refills its SMs as blocks end."""
    pixel_blocks = n_pix // BLOCK_PX
    run = max(1, spp * pixel_blocks // (LAUNCH_WAVES * resident))
    return LaunchPlan(n_pix, spp, -(-spp // run))


def _resident_blocks(lib, accel: BeamAccel, has_specular: bool,
                     index: int) -> int:
    """The kernel instance's blocks that card ``index`` holds at once, for
    the accel's shared memory (the occupancy the card reports)."""
    key = (index, accel.num_superclusters, accel.sc_tree_depth,
           bool(has_specular), bool(accel.mats_inline))
    if key not in _RESIDENT:
        fn = lib.pt_beam_resident_blocks
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
        got = fn(accel.num_superclusters, accel.sc_tree_depth,
                 int(has_specular), int(accel.mats_inline), index)
        if got < 1:
            raise RuntimeError(f"the card holds no beam kernel block: "
                               f"{build.error_string(lib, -got)} "
                               f"(cudaError {-got})")
        _RESIDENT[key] = got
    return _RESIDENT[key]


def _accel_for(scene: Scene) -> BeamAccel:
    """The scene's beam accel on the scene's device, from a small
    content-keyed cache (``clusters.cached_accel``): the host build must
    not be paid per render call.  Raises the builder's ValueError when the
    accel cannot represent the scene."""
    return cached_accel(_ACCEL_CACHE, scene, build_beam_accel)


def _padded_res(width: int, height: int) -> Tuple[int, int]:
    """Film size padded up to the 64x64 square grid."""
    return (-(-width // _SQ) * _SQ, -(-height // _SQ) * _SQ)


def _sq_to_raster(wp: int, hp: int) -> np.ndarray:
    """raster_index[device_index] for the padded wp x hp film: Morton order
    within each 64x64 square, squares row-major."""
    idx = np.arange(wp * hp, dtype=np.uint64)
    nsq_x = wp // _SQ
    sq = idx // _SQ_PIX
    in_sq = idx % _SQ_PIX

    def deint(v):
        v = v & 0x5555555555555555
        v = (v | (v >> 1)) & 0x3333333333333333
        v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
        v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
        v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
        return v

    w = (sq % nsq_x) * _SQ + deint(in_sq)
    h = (sq // nsq_x) * _SQ + deint(in_sq >> 1)
    return (h * wp + w).astype(np.int64)


def _raster_index(wp: int, hp: int, dev: torch.device) -> torch.Tensor:
    key = (wp, hp, str(dev))
    if key not in _RASTER_CACHE:
        _RASTER_CACHE[key] = torch.from_numpy(_sq_to_raster(wp, hp)).to(dev)
    return _RASTER_CACHE[key]


def _to_raster(flat: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(C, wp * hp) device-order planes -> the cropped (H, W, C) film."""
    wp, hp = _padded_res(width, height)
    img = torch.empty((wp * hp, flat.shape[0]), dtype=flat.dtype,
                      device=flat.device)
    img[_raster_index(wp, hp, flat.device)] = flat.T
    return img.reshape(hp, wp, -1)[:height, :width]


def _band(camera: Camera, tile0: int, n_tiles: Optional[int]
          ) -> Tuple[int, int]:
    wp, hp = _padded_res(*camera.res)
    total = wp * hp // TILE_PX
    n_tiles = total - tile0 if n_tiles is None else n_tiles
    if not 0 <= tile0 < total or not 0 < n_tiles <= total - tile0:
        raise ValueError(f"tiles [{tile0}, {tile0 + n_tiles}) are not inside "
                         f"the film's {total} tiles")
    return tile0, n_tiles


def _check(camera: Camera, scene: Scene, sample0: int, samples: int,
           depth: int) -> None:
    if sample0 < 0 or samples < 0 or depth < 0:
        raise ValueError(f"need sample0, samples, depth >= 0 (got "
                         f"{sample0}, {samples}, {depth})")
    if scene.num_tris == 0:
        raise ValueError("No triangles in scene.")
    if camera.device != scene.device:
        raise ValueError(f"camera on {camera.device} but scene on "
                         f"{scene.device}")


def _default_spp_per_call(camera: Camera, samples: int, depth: int) -> int:
    # From the FULL padded film, so a band launch splits its samples as
    # the full launch does and its tiles come out bit-identical.
    wp, hp = _padded_res(*camera.res)
    return max(1, min(samples, SEGMENTS_PER_CALL // (wp * hp * max(depth, 1))))


def _pixels(camera: Camera, tile0: int, n_tiles: int, dev):
    """(w, h, tile) int64 of the device-order pixels of the band."""
    wp, _ = _padded_res(*camera.res)
    pix = torch.arange(tile0 * TILE_PX, (tile0 + n_tiles) * TILE_PX,
                       device=dev)
    sq = pix >> 12
    in_sq = pix & (_SQ_PIX - 1)

    def even_bits(v):
        v = v & 0x55555555
        v = (v | (v >> 1)) & 0x33333333
        v = (v | (v >> 2)) & 0x0F0F0F0F
        v = (v | (v >> 4)) & 0x00FF00FF
        return (v | (v >> 8)) & 0x0000FFFF

    nsq_x = wp // _SQ
    w = (sq % nsq_x) * _SQ + even_bits(in_sq)
    h = (sq // nsq_x) * _SQ + even_bits(in_sq >> 1)
    return w, h, pix >> _TILE_LOG2


def _tile_draws(tiles: torch.Tensor, sidx: int, seed: int, depth: int,
                has_specular: bool):
    """Per bounce, the tile stream's (u1, u2, cube (K, 3, n) or None) for
    each tile of ``tiles``: hash(hash((tile + 0x9E377) ^ sidx * GOLDEN) ^
    seed_mix), drawn u1, u2, then all 3 * SPECULAR_TRIES cube uniforms."""
    mix = (int(seed) * prng.SEED_MIX) & prng.MASK
    golden = (int(sidx) * prng.GOLDEN) & prng.MASK
    state = prng.hash_u32(((tiles + _TILE_MIX) & prng.MASK) ^ golden)
    state = prng.hash_u32(state ^ mix)
    draws = []
    for _ in range(depth):
        state, u1 = prng.rand01(state)
        state, u2 = prng.rand01(state)
        cube = None
        if has_specular:
            state, flat = prng.randn01(state, 3 * SPECULAR_TRIES)
            cube = flat.reshape(SPECULAR_TRIES, 3, -1)
        draws.append((u1, u2, cube))
    return draws


def _one_sample(camera: Camera, cam: torch.Tensor, accel: BeamAccel,
                w, h, tile_local, tiles, sidx: int, depth: int, seed: int,
                has_specular: bool, segments: Optional[list] = None
                ) -> torch.Tensor:
    """Radiance (3, n) of sample ``sidx`` at the band's pixels, in the
    kernel's operation order.  ``segments`` receives (o, d, t, row) of the
    live rays of every bounce (t = FLOAT_INF and row = -1 on a miss)."""
    n = w.shape[0]
    dev = w.device
    state = prng.sample_seed(w, h, camera.height, sidx, seed)
    state, j1 = prng.rand01(state)
    state, j2 = prng.rand01(state)
    x = (w.to(torch.float32) + cam[15] + j1) * cam[12] - cam[13]
    y = (h.to(torch.float32) + cam[15] + j2) * cam[12] - cam[14]
    d = torch.stack([x * cam[3] + y * cam[6] + cam[9],
                     x * cam[4] + y * cam[7] + cam[10],
                     x * cam[5] + y * cam[8] + cam[11]], dim=-1)
    d = d * torch.rsqrt(dot(d, d))[:, None]
    o = cam[0:3].expand(n, 3)
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rows = accel.tri_cols
    for u1, u2, cube in _tile_draws(tiles, sidx, seed, depth, has_specular):
        best_t = torch.full((n,), FLOAT_INF, dtype=torch.float32, device=dev)
        best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        live = torch.nonzero(alive).squeeze(1)   # dead rays hit nothing
        if live.numel():
            t_l, row_l = intersect_packed(o[live], d[live], rows)
            best_t[live] = t_l
            best[live] = row_l
            if segments is not None:
                segments.append((o[live], d[live], t_l, row_l))
        hit_row = rows[best.clamp_min(0)]
        f_mat = torch.where(best >= 0, hit_row[:, 9], -1.0)
        if accel.mats_inline:
            col = torch.where((best >= 0)[:, None], hit_row[:, 13:16], 0.0)
            flags = torch.floor(f_mat * 0.125)
            rough = f_mat - 8.0 * flags
        else:
            m = accel.mats[f_mat.clamp_min(0).long()]
            m = torch.where((best >= 0)[:, None], m, 0.0)
            col, rough, flags = m[:, 0:3], m[:, 3], m[:, 4]
        nrm = torch.where((best >= 0)[:, None], hit_row[:, 10:13], 0.0)
        nrm = nrm * torch.rsqrt(torch.clamp_min(dot(nrm, nrm), 1e-30))[:, None]

        is_emit = flags > 1.5
        emitf = is_emit.to(torch.float32)[:, None]
        albf = 1.0 - emitf
        hit = (best_t < FLOAT_INF) & alive
        hitf = hit.to(torch.float32)[:, None]
        rad = rad + hitf * thr * col * emitf
        cont = hit & ~is_emit
        nrm = nrm * torch.where(dot(nrm, d) < 0.0, 1.0, -1.0)[:, None]

        xx = 2.0 * u1 - 1.0
        ct = torch.sqrt(torch.clamp_min(1.0 - xx * xx, 0.0))
        phi = _TWO_PI * u2
        sd = torch.stack([ct * torch.cos(phi), ct * torch.sin(phi), -xx],
                         dim=-1)[tile_local]
        new_d = sd * torch.where(dot(sd, nrm) < 0.0, -1.0, 1.0)[:, None]
        if has_specular:
            ddn = 2.0 * dot(d, nrm)
            mirror = d - ddn[:, None] * nrm
            cand = mirror
            for k in range(SPECULAR_TRIES - 1, -1, -1):
                j = mirror + (cube[k].T[tile_local] - 0.5) * rough[:, None]
                cand = torch.where((dot(j, nrm) >= 0.0)[:, None], j, cand)
            spec = (flags > 0.5) & ~is_emit
            new_d = torch.where(
                spec[:, None], cand * torch.rsqrt(dot(cand, cand))[:, None],
                new_d)

        w2c = 2.0 * dot(nrm, new_d)
        contm = cont[:, None]
        thr = thr * torch.where(contm, w2c[:, None] * col * albf, 1.0)
        hit_p = o + d * best_t[:, None]
        o = torch.where(contm, hit_p + nrm * SHIFT_BIAS, o)
        d = torch.where(contm, new_d, d)
        alive = cont
    return rad.T


def render_tiles_beam_reference(camera: Camera, scene: Scene, sample0: int,
                                samples: int, depth: int = 5, *,
                                seed: int = prng.SEED,
                                accel: Optional[BeamAccel] = None,
                                spp_per_call: Optional[int] = None,
                                tile0: int = 0,
                                n_tiles: Optional[int] = None,
                                segments: Optional[list] = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the scene's device: the
    (3, n_tiles * 2048) device-order radiance sums of tiles
    [tile0, tile0 + n_tiles) over the samples [sample0, sample0 + samples),
    with the nearest hit by dense Möller–Trumbore against the accel's own
    packed rows.  It sums the samples of each call one by one and adds each
    call's sum to the film, in the kernel's order.  ``segments``: as in
    ``_one_sample``."""
    _check(camera, scene, sample0, samples, depth)
    tile0, n_tiles = _band(camera, tile0, n_tiles)
    if spp_per_call is None:
        spp_per_call = _default_spp_per_call(camera, samples, depth)
    dev = scene.device
    accel = _accel_for(scene) if accel is None else accel.to(dev)
    cam = _camera_params(camera)
    w, h, tile = _pixels(camera, tile0, n_tiles, dev)
    tiles = torch.arange(tile0, tile0 + n_tiles, device=dev)
    tile_local = tile - tile0
    film = torch.zeros((3, n_tiles * TILE_PX), dtype=torch.float32,
                       device=dev)
    s = 0
    while s < samples:
        spp = min(spp_per_call, samples - s)
        acc = torch.zeros_like(film)
        for k in range(spp):
            acc = acc + _one_sample(camera, cam, accel, w, h, tile_local,
                                    tiles, sample0 + s + k, depth, seed,
                                    scene.has_specular, segments)
        film = film + acc
        s += spp
    return film


def render_tiles_beam(camera: Camera, scene: Scene, sample0: int,
                      samples: int, depth: int = 5, *, seed: int = prng.SEED,
                      accel: Optional[BeamAccel] = None,
                      spp_per_call: Optional[int] = None, tile0: int = 0,
                      n_tiles: Optional[int] = None,
                      counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (3, n_tiles * 2048) device-order radiance sums of tiles
    [tile0, tile0 + n_tiles) over the samples [sample0, sample0 + samples),
    by the CUDA kernel; a CPU scene takes the plain version.

    Each (pixel, sample) owns its jitter stream and each (tile, sample) its
    bounce stream, so adjacent sample windows sum to the combined window,
    and a band of tiles equals the same tiles of the full film bit for bit.
    ``counts``: an optional (n_tiles * 2048,) int32 CUDA tensor to which
    each pixel adds the triangle rows it tested.  Launches go on the current
    stream and are not synchronised."""
    global LAUNCHES, BLOCKS
    _check(camera, scene, sample0, samples, depth)
    tile0, n_tiles = _band(camera, tile0, n_tiles)
    dev = scene.device
    if dev.type == "cpu":
        if counts is not None:
            raise ValueError("the plain version counts no triangle tests")
        return render_tiles_beam_reference(
            camera, scene, sample0, samples, depth, seed=seed, accel=accel,
            spp_per_call=spp_per_call, tile0=tile0, n_tiles=n_tiles)
    if dev.type != "cuda":
        raise ValueError(f"the beam kernel runs on CUDA, not {dev}")
    if spp_per_call is None:
        spp_per_call = _default_spp_per_call(camera, samples, depth)
    accel = _accel_for(scene) if accel is None else accel.to(dev)
    if accel.num_superclusters > MAX_BEAM_SC:
        raise ValueError(f"{accel.num_superclusters} superclusters > "
                         f"{MAX_BEAM_SC}; rebuild with larger sc_tris")
    if accel.max_edge_product * 1.001 >= MAX_DET:
        # The row test's reciprocal is exact below 2^126 only
        # (csrc/common.cuh::rcp_in_range), and |a| <= |e1| |e2|.
        raise ValueError(
            f"a triangle's edge product reaches {MAX_DET:.3g}: the beam "
            f"kernel's reciprocal is exact only below it (scale the scene)")
    n_pix = n_tiles * TILE_PX
    cam = _camera_params(camera)
    arrays = [("cam", cam, torch.float32),
              ("sc_tree", accel.sc_tree, torch.float32),
              ("sc_first", accel.sc_first, torch.int32),
              ("sc_ncl", accel.sc_ncl, torch.int32),
              ("mats", accel.mats, torch.float32),
              ("cl_bounds", accel.cl_bounds, torch.float32),
              ("tri_cols", accel.tri_cols, torch.float32)]
    if counts is not None:
        arrays.append(("counts", counts, torch.int32))
        if tuple(counts.shape) != (n_pix,):
            raise ValueError(f"counts: need shape ({n_pix},), got "
                             f"{tuple(counts.shape)}")
    for name, x, dtype in arrays:
        if x.dtype != dtype or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name}: need contiguous {dtype} on {dev}, got "
                             f"{x.dtype} on {x.device}")
    film = torch.zeros((3, n_pix), dtype=torch.float32, device=dev)
    scratch = torch.empty((min(spp_per_call, samples), 3, n_pix),
                          dtype=torch.float32, device=dev)

    lib = build.load_library()
    build.check_tree_depth(lib, accel.sc_tree_depth, "beam accel")
    fn = lib.pt_beam_render
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    resident = _resident_blocks(lib, accel, scene.has_specular, index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    wp, _ = _padded_res(*camera.res)
    seed_mix = (int(seed) * prng.SEED_MIX) & prng.MASK
    s = 0
    with trace_annotation("pt.beam.launches"):
        while s < samples:
            spp = min(spp_per_call, samples - s)
            plan = launch_plan(n_pix, spp, resident)
            err = fn(cam.data_ptr(), accel.sc_tree.data_ptr(),
                     accel.sc_first.data_ptr(), accel.sc_ncl.data_ptr(),
                     accel.mats.data_ptr(), accel.cl_bounds.data_ptr(),
                     accel.tri_cols.data_ptr(), film.data_ptr(),
                     scratch.data_ptr(),
                     None if counts is None else counts.data_ptr(),
                     accel.num_superclusters, accel.sc_tree_depth,
                     accel.ctris, n_tiles, camera.height, wp // _SQ, tile0,
                     (sample0 + s) & prng.MASK, spp, plan.groups, depth,
                     seed_mix, int(scene.has_specular),
                     int(accel.mats_inline),
                     accel.mats.shape[0], accel.cl_bounds.shape[0],
                     accel.tri_cols.shape[0], index, stream)
            if err != 0:
                raise RuntimeError(f"beam kernel launch failed: "
                                   f"{build.error_string(lib, err)} "
                                   f"(cudaError {err})")
            LAUNCHES += 1
            BLOCKS += plan.blocks
            s += spp
    return film


def render_sum_beam_reference(camera: Camera, scene: Scene, sample0: int,
                              samples: int, depth: int = 5, *,
                              seed: int = prng.SEED,
                              accel: Optional[BeamAccel] = None,
                              spp_per_call: Optional[int] = None
                              ) -> torch.Tensor:
    """The plain version's (H, W, 3) radiance sum over the samples
    [sample0, sample0 + samples)."""
    return _to_raster(render_tiles_beam_reference(
        camera, scene, sample0, samples, depth, seed=seed, accel=accel,
        spp_per_call=spp_per_call), *camera.res)


def render_sum_beam(camera: Camera, scene: Scene, sample0: int,
                    samples: int, depth: int = 5, *, seed: int = prng.SEED,
                    accel: Optional[BeamAccel] = None,
                    spp_per_call: Optional[int] = None) -> torch.Tensor:
    """The (H, W, 3) radiance sum over the samples [sample0, sample0 +
    samples) on the scene's device, de-interleaved and cropped from the
    padded film: the kernel on a CUDA scene, the plain version on a CPU
    one.  Adjacent windows sum exactly."""
    return _to_raster(render_tiles_beam(
        camera, scene, sample0, samples, depth, seed=seed, accel=accel,
        spp_per_call=spp_per_call), *camera.res)


def render_film_beam(camera: Camera, scene: Scene, samples: int,
                     depth: int = 5, *, seed: int = prng.SEED,
                     accel: Optional[BeamAccel] = None,
                     spp_per_call: Optional[int] = None) -> Film:
    """The sample-averaged linear film.  Unbiased per pixel at any spp; the
    noise is tile-correlated (use backend='cluster' for per-pixel
    independent sampling)."""
    film = render_sum_beam(camera, scene, 0, samples, depth, seed=seed,
                           accel=accel, spp_per_call=spp_per_call)
    return Film(camera.res, data=film / samples)


def count_work(camera: Camera, scene: Scene, sample0: int, samples: int,
               depth: int = 5, *, seed: int = prng.SEED) -> dict:
    """The work a render of the whole film over the samples [sample0,
    sample0 + samples) needs of any exact two-level traversal, from the
    plain version's live ray segments.  Each segment opens the supercluster
    boxes it enters before its nearest hit and the one that holds the hit;
    in those, the cluster boxes it enters before the hit and the one that
    holds the hit; and tests the rows of every cluster so counted.  Returns
    the counts and their operations: SLAB_OPS a box, PLUCKER_OPS a row (the
    cheaper row test, as the trace kernel's bound counts it), and a
    segment's MOMENT_OPS, SHADE_OPS and three divisions for the reciprocal
    direction."""
    accel = _accel_for(scene)
    segments = []
    render_tiles_beam_reference(camera, scene, sample0, samples, depth,
                                seed=seed, accel=accel, segments=segments)
    dev = scene.device
    S, C = accel.num_superclusters, accel.num_clusters
    # Clusters are numbered supercluster by supercluster.
    cl_sc = torch.repeat_interleave(torch.arange(S, device=dev),
                                    accel.sc_ncl.long())
    sc_ids = torch.arange(S, device=dev)
    cl_ids = torch.arange(C, device=dev)
    live = sc_boxes = cl_boxes = 0
    chunk = max(1, (1 << 22) // max(C, 1))
    for o_all, d_all, t_all, row_all in segments:
        live += o_all.shape[0]
        for r0 in range(0, o_all.shape[0], chunk):
            o, d = o_all[r0:r0 + chunk], d_all[r0:r0 + chunk]
            t, inv = t_all[r0:r0 + chunk], 1.0 / d_all[r0:r0 + chunk]
            row = row_all[r0:r0 + chunk]
            hit_cl = torch.where(row >= 0, row // accel.ctris, -1)
            hit_sc = torch.where(row >= 0, cl_sc[hit_cl.clamp_min(0)], -1)
            sc_in = (boxes_entered(o, inv, t, accel.sc_bounds[:S])
                     | (sc_ids == hit_sc[:, None]))
            cl_in = ((boxes_entered(o, inv, t, accel.cl_bounds[:C])
                      & sc_in[:, cl_sc]) | (cl_ids == hit_cl[:, None]))
            sc_boxes += int(sc_in.sum())
            cl_boxes += int(cl_in.sum())
    rows = cl_boxes * accel.ctris
    return {"live_segments": live, "sc_box_tests": sc_boxes,
            "cluster_box_tests": cl_boxes, "rows": rows,
            "ops": ((sc_boxes + cl_boxes) * SLAB_OPS + rows * PLUCKER_OPS
                    + live * (MOMENT_OPS + SHADE_OPS + 3))}


def count_tri_tests(camera: Camera, scene: Scene, samples: int = 8,
                    depth: int = 5, *, seed: int = prng.SEED,
                    accel: Optional[BeamAccel] = None) -> float:
    """Mean triangle rows the kernel tests per ray segment: each pixel's
    tested rows summed over its bounces, averaged over the film's pixels
    and samples, divided by ``depth`` (a dead path's remaining bounces
    count as segments that test nothing).  A per-ray figure of this
    traversal; it is not comparable with the TPU kernel's tile-union count
    in ROOFLINE.md.  Needs a CUDA scene."""
    if scene.device.type != "cuda":
        raise ValueError("count_tri_tests counts the CUDA kernel's tests; "
                         "it needs a scene on a CUDA device")
    wp, hp = _padded_res(*camera.res)
    counts = torch.zeros(wp * hp, dtype=torch.int32, device=scene.device)
    render_tiles_beam(camera, scene, 0, samples, depth, seed=seed,
                      accel=accel, counts=counts)
    per_pixel = _to_raster(counts[None].to(torch.float64), *camera.res)
    return float(per_pixel.mean()) / samples / depth
