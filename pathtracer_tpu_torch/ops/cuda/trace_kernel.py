"""Path-tracing megakernel: host wrapper, plain version and scene packing.

The kernel, ``csrc/trace_kernel.cu``, replaces
``pathtracer_tpu/ops/pallas/trace_kernel.py::_kernel`` with both of its
intersection loops: per pixel of a film band starting at row ``h0``, the
radiance SUM over the samples ``[sample0, sample0 + samples)``, with the
whole path (hash RNG, jittered camera ray, sample loop, bounce loop, dense
test against every triangle, diffuse and specular sampling, forward
accumulation) inside one launch.  ``loop`` selects the test:

* ``"mt"``: Möller–Trumbore against rows [v1, e1, e2];
* ``"plucker"``: the JAX package's Plücker coefficient rows
  (``_triangle_params_plucker``), with the bounce-0 collapse against the
  camera position.

``None`` means ``DEFAULT_LOOP``, the loop the H100 measured faster
(PERF.md).  Each loop's film is bit-identical to its plain version on the
card; the two loops differ by float reassociation only.

What bounds it on this card: fp32 issue in the triangle loop (46
operations per Möller–Trumbore test, 38 per Plücker test and 20 at
bounce 0, every triangle per live ray segment; ``count_ops`` counts the
Plücker test, the cheaper); the only device-memory traffic is one
read-modify-write of the film per pixel per launch.  Design (see the
source): path regeneration from a warp pool (the paths of a warp's 32
pixels over 16 samples; a lane whose path ends takes the next one, and
each pixel's radiances are summed in sample order), rows in shared memory
padded to 16 bytes and to the kernel's row multiple, four independent
tests at a time, and the IEEE reciprocal without the division's range check (rows
whose determinant could reach ``MAX_DET`` are refused).

On a CUDA scene ``render_sum_cuda`` launches the kernel or raises.  It
takes the plain version, ``render_sum_reference``, only when the scene's
tensors lie on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Optional

import numpy as np
import torch

from ... import materials as mat
from ...camera import Camera
from ...image import Film
from ...rng import MASK, SEED, SEED_MIX
from ...scene import Scene
from ...utils import build
from ...utils.profiling import trace_annotation
from ..intersect import (MOMENT_OPS, PLUCKER_OPS, PLUCKER_PRIMARY_OPS,
                         intersect_plucker)
from ..trace import sample_radiance, shade_table

MAX_CUDA_TRIS = 512            # at most 96 KB of shared memory a block
RAYS_PER_CALL = 1 << 24        # paths (pixels x samples) per launch, as
                               # the TPU kernel
REFERENCE_RAYS_PER_CHUNK = 1 << 20  # bounds the plain version's memory

LOOPS = ("mt", "plucker")
DEFAULT_LOOP = "plucker"
MAX_DET = 2.0 ** 125           # determinant bound of the kernel's reciprocal
# Kernel row layouts: column j of a kernel row is column ORDER[j] of the
# packed rows with a zero column appended (see csrc/trace_kernel.cu).
_MT_ORDER = (0, 1, 2, 9, 3, 4, 5, 9, 6, 7, 8, 9)
_PLUCKER_ORDER = (0, 1, 2, 3, 4, 5, 10, 11, 12, 16, 17, 18, 7, 8, 9, 6,
                  13, 14, 15, 26, 19, 20, 21, 25, 22, 23, 24, 26)

# Operations counted from the plain formulas (comparisons not counted):
# the diffuse bounce of a path that goes on (normal flip, hemisphere sample
# with sin and cos, its flip, the cosine, the throughput, the next origin);
# the camera ray of a path (jitter, direction, normalisation).
SHADE_OPS = 48
CAMERA_OPS = 29

LAUNCHES = 0                   # kernel launches since the last reset
LOOP_LAUNCHES = {loop: 0 for loop in LOOPS}   # the same, per loop

_ROWS_CACHE = []     # [((fingerprint, camera position, device), rows)]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _resolve_loop(loop: Optional[str]) -> str:
    loop = DEFAULT_LOOP if loop is None else loop
    if loop not in LOOPS:
        raise ValueError(f"loop {loop!r} is not in {LOOPS}")
    return loop


def _camera_params(cam: Camera) -> torch.Tensor:
    """(16,) float32 on the camera's device: [pos, right, up,
    distance * forward, cell, v_res / 2, pixel_offset].  Built on the
    device: a host-to-device copy here would synchronise the stream."""
    off = torch.full((1,), cam.pixel_offset, dtype=torch.float32,
                     device=cam.device)
    return torch.cat([cam.pos, cam.right, cam.up, cam.distance * cam.forward,
                      cam.cell_size.reshape(1), cam.v_res * 0.5,
                      off]).contiguous()


def _triangle_params(scene: Scene) -> torch.Tensor:
    """(T, 9) = [v1, e1, e2] of the REAL triangles; padding is dropped."""
    n = scene.num_tris
    v1 = scene.v1[:n]
    return torch.cat([v1, scene.v2[:n] - v1, scene.v3[:n] - v1],
                     dim=-1).contiguous()


def _triangle_params_plucker(scene: Scene, cam_pos) -> np.ndarray:
    """(T, 27) float32 Plücker coefficient rows for ``intersect_plucker``,
    precomputed in float64 on the host from the REAL triangles and the
    camera position (3,).  Columns, as the JAX package's packing:

      0:3   Na  = -(e1 x e2)          a   = Na . d
      3:6   N   =  e1 x e2            t*a = N . o + nv
      6     nv  = -N . v1
      7:10  kp  = -(e2 x v1)          u*a = e2 . (o x d) + kp . d
      10:13 e2
      13:16 kq  = -(v1 x e1)          v*a = me1 . (o x d) + kq . d
      16:19 me1 = -e1
      19:22 pc  = e2 x cam_pos + kp   u*a at bounce 0 = pc . d
      22:25 qc  = me1 x cam_pos + kq  v*a at bounce 0 = qc . d
      25    r0  = N . cam_pos + nv    t*a at bounce 0
      26    pad
    """
    hv1, hv2, hv3 = scene.host_verts()
    v1 = hv1.astype(np.float64)
    e1 = hv2.astype(np.float64) - v1
    e2 = hv3.astype(np.float64) - v1
    o = np.asarray(cam_pos, np.float64).reshape(1, 3)
    nrm = np.cross(e1, e2)
    kp = -np.cross(e2, v1)
    kq = -np.cross(v1, e1)
    me1 = -e1
    nv = -np.sum(nrm * v1, -1, keepdims=True)
    # bounce-0 (shared origin) coefficients: x . (o x d) = (x x o) . d
    pc = np.cross(e2, np.broadcast_to(o, e2.shape)) + kp
    qc = np.cross(me1, np.broadcast_to(o, me1.shape)) + kq
    r0 = np.sum(nrm * o, -1, keepdims=True) + nv
    pad = np.zeros_like(r0)
    return np.concatenate([-nrm, nrm, nv, kp, e2, kq, me1, pc, qc, r0, pad],
                          axis=-1).astype(np.float32)


def _plucker_rows(scene: Scene, camera: Camera) -> torch.Tensor:
    """``_triangle_params_plucker`` on the scene's device, from a small
    cache keyed by the vertex bytes, the camera position and the device:
    the host packing reaches the device by a copy, which waits for the
    stream, so a repeated call must not pay it.  The key's hashing is the
    span ``pt.scene.hash``."""
    verts = scene.host_verts()
    with trace_annotation("pt.scene.hash"):
        h = hashlib.sha1()
        for arr in verts:
            h.update(np.ascontiguousarray(arr).tobytes())
    pos = camera.host_pos()
    key = (scene.num_tris, h.hexdigest(), pos.tobytes(), str(scene.device))
    for i, (k, rows) in enumerate(_ROWS_CACHE):
        if k == key:
            _ROWS_CACHE.append(_ROWS_CACHE.pop(i))
            return rows
    rows = torch.from_numpy(_triangle_params_plucker(scene, pos)).to(
        scene.device)
    _ROWS_CACHE.append((key, rows))
    del _ROWS_CACHE[:-8]
    return rows


def _kernel_rows(scene: Scene, camera: Camera, loop: str,
                 multiple: int) -> torch.Tensor:
    """The kernel's rows: (P, 12) for "mt", (P, 28) for "plucker", with
    P = T rounded up to ``multiple`` (the kernel's, from
    ``pt_trace_row_multiple``) and the extra rows all zero (a zero
    determinant fails every test)."""
    packed = (_triangle_params(scene) if loop == "mt"
              else _plucker_rows(scene, camera))
    order = _MT_ORDER if loop == "mt" else _PLUCKER_ORDER
    n = scene.num_tris
    padded = -(-n // multiple) * multiple
    full = packed.new_zeros((padded, packed.shape[1] + 1))
    full[:n, :packed.shape[1]] = packed
    # Column slices, not an index tensor: building one on the device would
    # be a host-to-device copy, which waits for the stream.
    return torch.cat([full[:, j:j + 1] for j in order], dim=1).contiguous()


def _check_det_bound(scene: Scene) -> None:
    """The kernel's reciprocal is exact for determinants below 2^126
    (csrc/common.cuh::rcp_in_range).  Both loops' |a| is at most
    |e1| |e2| |d| with |d| = 1, so refuse a scene where that could reach
    MAX_DET."""
    hv1, hv2, hv3 = (a.astype(np.float64) for a in scene.host_verts())
    e1 = np.linalg.norm(hv2 - hv1, axis=-1)
    e2 = np.linalg.norm(hv3 - hv1, axis=-1)
    if float(np.max(e1 * e2)) * 1.001 >= MAX_DET:
        raise ValueError(
            f"a triangle's edge product reaches {MAX_DET:.3g}: the trace "
            f"kernel's reciprocal is exact only below it (scale the scene)")


def _packed_table(scene: Scene) -> torch.Tensor:
    """(T, 8) packed shade rows: [color, roughness, normal, flags], with
    color = emission for EMIT rows, else albedo, and flags = 2 (EMIT),
    1 (SPECULAR) or 0.  Only EMIT rows may carry emission."""
    n = scene.num_tris
    mtype, _, emit, _ = scene.host_materials()
    if ((mtype != mat.EMIT) & (abs(emit).sum(-1) > 0)).any():
        raise ValueError(
            "scene has a non-EMIT material with nonzero emission; the "
            "packed CUDA kernel cannot represent it — use backend='brute'")
    full = shade_table(scene)[:n]
    is_emit = (scene.mat_type[:n] == mat.EMIT)[:, None]
    color = torch.where(is_emit, scene.emit[:n], scene.albedo[:n])
    flags = torch.where(
        scene.mat_type[:n] == mat.EMIT, 2.0,
        torch.where(scene.mat_type[:n] == mat.SPECULAR, 1.0, 0.0))
    return torch.cat([color, full[:, 6:7], full[:, 7:10], flags[:, None]],
                     dim=-1).contiguous()


def _window(camera: Camera, scene: Scene, sample0: int, samples: int,
            depth: int, h0: int, band_h: Optional[int]) -> int:
    """Validate the sample window and film band; return band_h."""
    height = camera.height
    band_h = height - h0 if band_h is None else band_h
    if not 0 <= h0 < height or not 0 < band_h <= height - h0:
        raise ValueError(f"band [{h0}, {h0 + band_h}) is not inside the "
                         f"film's {height} rows")
    if sample0 < 0 or samples < 0 or depth < 0:
        raise ValueError(f"need sample0, samples, depth >= 0 (got "
                         f"{sample0}, {samples}, {depth})")
    if scene.num_tris == 0:
        raise ValueError("No triangles in scene.")
    if camera.device != scene.device:
        raise ValueError(f"camera on {camera.device} but scene on "
                         f"{scene.device}")
    return band_h


def _default_spp_per_call(camera: Camera, samples: int) -> int:
    # From the FULL film size, so a band launch splits its samples exactly
    # as the full launch does and its rows come out bit-identical.
    return max(1, min(samples, RAYS_PER_CALL // (camera.width
                                                 * camera.height)))


def _plain_intersectors(camera: Camera, scene: Scene, loop: str):
    """(intersect, primary_intersect) of the plain version of ``loop``:
    ``intersect_brute`` for "mt" (both None), the Plücker rows with the
    bounce-0 collapse for "plucker"."""
    if loop == "mt":
        return None, None
    rows = _plucker_rows(scene, camera)
    return (lambda o, d: intersect_plucker(o, d, rows),
            lambda o, d: intersect_plucker(o, d, rows, primary=True))


def _plain_samples(camera: Camera, scene: Scene, sample0: int, samples: int,
                   depth: int, seed: int, h0: int, band_h: int, loop: str,
                   live=None):
    """Yield (sample offset, radiance (S, band_h, W, 3)) of the plain path
    over the samples [sample0, sample0 + samples), in chunks of samples
    that bound its memory; ``live`` as in ``trace_rays``."""
    width = camera.width
    dev = scene.device
    w = torch.arange(width, device=dev).expand(band_h, width)
    h = torch.arange(h0, h0 + band_h, device=dev)[:, None].expand(band_h,
                                                                  width)
    table = shade_table(scene)
    intersect, primary = _plain_intersectors(camera, scene, loop)
    chunk = max(1, REFERENCE_RAYS_PER_CHUNK // (width * band_h))
    for c0 in range(0, samples, chunk):
        sidx = torch.arange(sample0 + c0, sample0 + min(samples, c0 + chunk),
                            device=dev)
        yield c0, sample_radiance(camera, scene, table, w, h, sidx, depth,
                                  seed, intersect=intersect,
                                  primary_intersect=primary, live=live)


def render_sum_reference(camera: Camera, scene: Scene, sample0: int,
                         samples: int, depth: int = 5, *, seed: int = SEED,
                         spp_per_call: Optional[int] = None, h0: int = 0,
                         band_h: Optional[int] = None,
                         loop: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the scene's device: the
    (band_h, W, 3) radiance sum of rows [h0, h0 + band_h) over the samples
    [sample0, sample0 + samples), composed from ``sample_seed``,
    ``get_rays`` and ``trace_rays`` over ``intersect_brute`` ("mt", as the
    brute backend composes them) or ``intersect_plucker`` ("plucker").  It
    sums the samples of each call one by one and adds each call's sum to
    the film, in the kernel's order."""
    band_h = _window(camera, scene, sample0, samples, depth, h0, band_h)
    loop = _resolve_loop(loop)
    if spp_per_call is None:
        spp_per_call = _default_spp_per_call(camera, samples)
    film = torch.zeros((band_h, camera.width, 3), dtype=torch.float32,
                       device=scene.device)
    s = 0
    while s < samples:
        spp = min(spp_per_call, samples - s)
        acc = torch.zeros_like(film)
        for _, rad in _plain_samples(camera, scene, sample0 + s, spp, depth,
                                     seed, h0, band_h, loop):
            for r in rad:
                acc = acc + r
        film = film + acc
        s += spp
    return film


def path_lengths(camera: Camera, scene: Scene, sample0: int, samples: int,
                 depth: int = 5, *, seed: int = SEED, h0: int = 0,
                 band_h: Optional[int] = None,
                 loop: Optional[str] = None) -> torch.Tensor:
    """(samples, band_h, W) int32: the ray segments each (sample, pixel)
    path traces while it is alive (1 to ``depth``: a path ends at a miss,
    at a light or after ``depth`` segments), from the plain version's
    ``alive`` masks."""
    band_h = _window(camera, scene, sample0, samples, depth, h0, band_h)
    loop = _resolve_loop(loop)
    out = torch.zeros((samples, band_h, camera.width), dtype=torch.int32,
                      device=scene.device)
    live = []
    for c0, rad in _plain_samples(camera, scene, sample0, samples, depth,
                                  seed, h0, band_h, loop, live):
        out[c0:c0 + rad.shape[0]] = sum(m.to(torch.int32) for m in live)
        live.clear()
    return out


def count_live_segments(camera: Camera, scene: Scene, sample0: int,
                        samples: int, depth: int = 5, *, seed: int = SEED,
                        loop: Optional[str] = None) -> int:
    """The ray segments a render of the whole film over the samples
    [sample0, sample0 + samples) traces while its paths are alive: the
    work the kernel's bound counts (``path_lengths`` summed)."""
    return int(path_lengths(camera, scene, sample0, samples, depth,
                            seed=seed, loop=loop).sum(dtype=torch.int64))


def count_ops(scene: Scene, live_segments: int, paths: int) -> int:
    """Operations a render needs whatever implements it, counted with the
    cheaper test, Plücker's: every live segment tests every triangle, a
    path's first segment (one per path) with the bounce-0 collapse
    (PLUCKER_PRIMARY_OPS), every later one with the full test (PLUCKER_OPS)
    after its moment o x d (MOMENT_OPS); every segment but a path's last
    bounces on (SHADE_OPS), every path starts with a camera ray."""
    later = live_segments - paths
    return (paths * scene.num_tris * PLUCKER_PRIMARY_OPS
            + later * (scene.num_tris * PLUCKER_OPS + MOMENT_OPS)
            + later * SHADE_OPS + paths * CAMERA_OPS)


def render_sum_cuda(camera: Camera, scene: Scene, sample0: int,
                    samples: int, depth: int = 5, *, seed: int = SEED,
                    spp_per_call: Optional[int] = None, h0: int = 0,
                    band_h: Optional[int] = None,
                    loop: Optional[str] = None) -> torch.Tensor:
    """Radiance SUM (band_h, W, 3) of rows [h0, h0 + band_h) over the
    samples [sample0, sample0 + samples), by the CUDA kernel with the
    intersection ``loop`` ("mt", "plucker", None for DEFAULT_LOOP).

    Each (pixel, sample) pair owns its RNG stream, so adjacent sample
    windows sum to the combined window, and a band's rows equal the same
    rows of the full film bit for bit.  Launches go on the current stream
    and are not synchronised (the Plücker rows are cached after the first
    call for a scene and camera position).  A CPU scene takes the plain
    version."""
    global LAUNCHES
    band_h = _window(camera, scene, sample0, samples, depth, h0, band_h)
    loop = _resolve_loop(loop)
    dev = scene.device
    if dev.type == "cpu":
        return render_sum_reference(
            camera, scene, sample0, samples, depth, seed=seed,
            spp_per_call=spp_per_call, h0=h0, band_h=band_h, loop=loop)
    if dev.type != "cuda":
        raise ValueError(f"the trace kernel runs on CUDA, not {dev}")
    if scene.num_tris > MAX_CUDA_TRIS:
        raise ValueError(
            f"the CUDA megakernel supports <= {MAX_CUDA_TRIS} triangles "
            f"(got {scene.num_tris})")
    _check_det_bound(scene)
    if spp_per_call is None:
        spp_per_call = _default_spp_per_call(camera, samples)

    lib = build.load_library()
    lib.pt_trace_row_multiple.restype = ctypes.c_int
    multiple = lib.pt_trace_row_multiple()
    cam = _camera_params(camera)
    rows = _kernel_rows(scene, camera, loop, multiple)
    tab = _packed_table(scene)
    n_rows = -(-scene.num_tris // multiple) * multiple
    width = len(_MT_ORDER if loop == "mt" else _PLUCKER_ORDER)
    for name, x, shape in (("cam", cam, (16,)),
                           ("rows", rows, (n_rows, width)),
                           ("tab", tab, (scene.num_tris, 8))):
        if (x.dtype != torch.float32 or tuple(x.shape) != shape
                or not x.is_contiguous() or x.device != dev):
            raise ValueError(f"{name}: need contiguous float32 {shape} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    film = torch.zeros((band_h, camera.width, 3), dtype=torch.float32,
                       device=dev)

    fn = lib.pt_trace_render
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    seed_mix = (int(seed) * SEED_MIX) & MASK

    s = 0
    with trace_annotation("pt.trace.launches"):
        while s < samples:
            spp = min(spp_per_call, samples - s)
            err = fn(rows.data_ptr(), tab.data_ptr(), cam.data_ptr(),
                     film.data_ptr(), n_rows, scene.num_tris, camera.width,
                     band_h, camera.height, h0, (sample0 + s) & MASK, spp,
                     depth, seed_mix, int(scene.has_specular),
                     LOOPS.index(loop), index, stream)
            if err != 0:
                raise RuntimeError(f"trace kernel launch failed: "
                                   f"{build.error_string(lib, err)} "
                                   f"(cudaError {err})")
            LAUNCHES += 1
            LOOP_LAUNCHES[loop] += 1
            s += spp
    return film


def render_film_cuda(camera: Camera, scene: Scene, samples: int,
                     depth: int = 5, *, seed: int = SEED,
                     loop: Optional[str] = None) -> Film:
    """The sample-averaged linear film by the CUDA kernel."""
    film = render_sum_cuda(camera, scene, 0, samples, depth, seed=seed,
                           loop=loop)
    return Film(camera.res, data=film / samples)
