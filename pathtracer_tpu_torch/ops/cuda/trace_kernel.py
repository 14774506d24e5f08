"""Path-tracing megakernel: host wrapper, plain version and scene packing.

The kernel, ``csrc/trace_kernel.cu``, replaces
``pathtracer_tpu/ops/pallas/trace_kernel.py::_kernel`` (its ``"mt"`` loop):
per pixel of a film band starting at row ``h0``, the radiance SUM over the
samples ``[sample0, sample0 + samples)``, with the whole path (hash RNG,
jittered camera ray, sample loop, bounce loop, dense Möller–Trumbore
against every triangle, diffuse and specular sampling, forward
accumulation) inside one launch.

What bounds it on this card: compute.  Each ray–triangle test is about 50
fp32 operations (one of them an IEEE division) and every bounce tests every
triangle; the only device-memory traffic is one read-modify-write of the
film per pixel per launch.  Design: one thread per pixel, with the scene
((T, 9) triangle rows and (T, 8) shade rows, at most 34,816 bytes for
T = 512) copied to shared memory once per block; the threads of a warp read
the same triangle together, so each read is a broadcast.

On a CUDA scene ``render_sum_cuda`` launches the kernel or raises.  It
takes the plain version, ``render_sum_reference``, only when the scene's
tensors lie on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import materials as mat
from ...camera import Camera
from ...image import Film
from ...rng import MASK, SEED, SEED_MIX
from ...scene import Scene
from ...utils import build
from ..trace import sample_radiance, shade_table

MAX_CUDA_TRIS = 512            # the shared-memory scene stays under 48 KB
RAYS_PER_CALL = 1 << 24        # ray segments per launch, as the TPU kernel
REFERENCE_RAYS_PER_CHUNK = 1 << 20  # bounds the plain version's memory

LAUNCHES = 0                   # kernel launches since the last reset

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def render_sum_reference(camera: Camera, scene: Scene, sample0: int,
                         samples: int, depth: int = 5, *, seed: int = SEED,
                         spp_per_call: Optional[int] = None, h0: int = 0,
                         band_h: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the scene's device: the
    (band_h, W, 3) radiance sum of rows [h0, h0 + band_h) over the samples
    [sample0, sample0 + samples), composed from ``sample_seed``,
    ``get_rays``, ``trace_rays`` and ``intersect_brute`` as the brute
    backend composes them.  It sums the samples of each call one by one and
    adds each call's sum to the film, in the kernel's order."""
    band_h = _window(camera, scene, sample0, samples, depth, h0, band_h)
    width = camera.width
    if spp_per_call is None:
        spp_per_call = _default_spp_per_call(camera, samples)
    dev = scene.device
    w = torch.arange(width, device=dev).expand(band_h, width)
    h = torch.arange(h0, h0 + band_h, device=dev)[:, None].expand(band_h,
                                                                  width)
    table = shade_table(scene)
    chunk = max(1, REFERENCE_RAYS_PER_CHUNK // (width * band_h))
    film = torch.zeros((band_h, width, 3), dtype=torch.float32, device=dev)
    s = 0
    while s < samples:
        spp = min(spp_per_call, samples - s)
        acc = torch.zeros_like(film)
        for c0 in range(0, spp, chunk):
            sidx = torch.arange(sample0 + s + c0,
                                sample0 + s + min(spp, c0 + chunk),
                                device=dev)
            rad = sample_radiance(camera, scene, table, w, h, sidx, depth,
                                  seed)
            for r in rad:
                acc = acc + r
        film = film + acc
        s += spp
    return film


def render_sum_cuda(camera: Camera, scene: Scene, sample0: int,
                    samples: int, depth: int = 5, *, seed: int = SEED,
                    spp_per_call: Optional[int] = None, h0: int = 0,
                    band_h: Optional[int] = None) -> torch.Tensor:
    """Radiance SUM (band_h, W, 3) of rows [h0, h0 + band_h) over the
    samples [sample0, sample0 + samples), by the CUDA kernel.

    Each (pixel, sample) pair owns its RNG stream, so adjacent sample
    windows sum to the combined window, and a band's rows equal the same
    rows of the full film bit for bit.  Launches go on the current stream
    and are not synchronised.  A CPU scene takes the plain version."""
    global LAUNCHES
    band_h = _window(camera, scene, sample0, samples, depth, h0, band_h)
    dev = scene.device
    if dev.type == "cpu":
        return render_sum_reference(
            camera, scene, sample0, samples, depth, seed=seed,
            spp_per_call=spp_per_call, h0=h0, band_h=band_h)
    if dev.type != "cuda":
        raise ValueError(f"the trace kernel runs on CUDA, not {dev}")
    if scene.num_tris > MAX_CUDA_TRIS:
        raise ValueError(
            f"the CUDA megakernel supports <= {MAX_CUDA_TRIS} triangles "
            f"(got {scene.num_tris})")
    if spp_per_call is None:
        spp_per_call = _default_spp_per_call(camera, samples)

    cam = _camera_params(camera)
    tri = _triangle_params(scene)
    tab = _packed_table(scene)
    for name, x, shape in (("cam", cam, (16,)),
                           ("tri", tri, (scene.num_tris, 9)),
                           ("tab", tab, (scene.num_tris, 8))):
        if (x.dtype != torch.float32 or tuple(x.shape) != shape
                or not x.is_contiguous() or x.device != dev):
            raise ValueError(f"{name}: need contiguous float32 {shape} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    film = torch.zeros((band_h, camera.width, 3), dtype=torch.float32,
                       device=dev)

    lib = build.load_library()
    fn = lib.pt_trace_render
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.pt_error_string.argtypes = [ctypes.c_int]
    lib.pt_error_string.restype = ctypes.c_char_p
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    seed_mix = (int(seed) * SEED_MIX) & MASK

    s = 0
    while s < samples:
        spp = min(spp_per_call, samples - s)
        err = fn(tri.data_ptr(), tab.data_ptr(), cam.data_ptr(),
                 film.data_ptr(), scene.num_tris, camera.width, band_h,
                 camera.height, h0, (sample0 + s) & MASK, spp, depth,
                 seed_mix, int(scene.has_specular), index, stream)
        if err != 0:
            raise RuntimeError(
                f"trace kernel launch failed: "
                f"{lib.pt_error_string(err).decode()} (cudaError {err})")
        LAUNCHES += 1
        s += spp
    return film


def render_film_cuda(camera: Camera, scene: Scene, samples: int,
                     depth: int = 5, *, seed: int = SEED) -> Film:
    """The sample-averaged linear film by the CUDA kernel."""
    film = render_sum_cuda(camera, scene, 0, samples, depth, seed=seed)
    return Film(camera.res, data=film / samples)
