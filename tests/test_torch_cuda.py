"""The CUDA kernels and the port's main paths on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without one.
This file imports neither JAX nor pathtracer_tpu, so on a machine with a
card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Kernel and plain version round every operation alike (the library builds
with --fmad=false), and the cluster and beam kernels resolve an exact tie
to the lower packed row as the plain argmin does: each kernel is held to
bit identity with its plain version; the checks across backends to the
film bar of the CPU parity tests, atol 2e-4 on all but 1% of the pixels
(see tests/_torch_parity.py).  The main paths are held at their own sizes:
the 1024^2 Cornell render, the 512^2 large-scene renders against the
committed renders in docs/, the recoveries, two ranks on one card, the
realtime session and the CLI; the randomized sweep runs every case of
``tests/_torch_card.py`` on the normal library here and on the
bounds-checked one in a child process.
"""

import ctypes
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.ops.cuda import beam_kernel as tbk
from pathtracer_tpu_torch.ops.cuda import brute_kernel as tbr
from pathtracer_tpu_torch.ops.cuda import cluster_kernel as tck
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
from pathtracer_tpu_torch.ops.intersect import intersect_brute
from pathtracer_tpu_torch.utils import profiling

import _torch_card as card
from _torch_card import FILM_ATOL, MAX_FLIP_SHARE

SCENES = {
    "corner": lambda res, dev: tpt.corner_scene(res=res, device=dev),
    "cornell": lambda res, dev: tpt.cornell_box(res=res, device=dev),
    "specular": lambda res, dev: tpt.modified_cornell(0.3, res=res,
                                                      device=dev),
}


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: these tests run on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run `pytest -m cuda` "
                    "on the card)")
    return torch.device("cuda")


def _on(device, name, res):
    return SCENES[name](res, device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_matches_reference(cuda_device, name):
    cam, scene = _on(cuda_device, name, (64, 64))
    before = ttk.LAUNCHES
    got = ttk.render_sum_cuda(cam, scene, 0, 4, 5) / 4
    assert ttk.LAUNCHES == before + 1
    want = ttk.render_sum_reference(cam, scene, 0, 4, 5) / 4
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and float(got.sum()) > 0.0
    bad = ((got - want).abs().amax(dim=-1) > FILM_ATOL).float().mean()
    assert float(bad) <= MAX_FLIP_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ttk.LOOPS)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_loop_bit_identical_to_plain(cuda_device, name, loop):
    """Each loop's film equals its plain version's bit for bit: the same
    operations in the same order, --fmad=false."""
    cam, scene = _on(cuda_device, name, (64, 64))
    before = ttk.LOOP_LAUNCHES[loop]
    got = ttk.render_sum_cuda(cam, scene, 0, 4, 5, loop=loop)
    assert ttk.LOOP_LAUNCHES[loop] == before + 1
    want = ttk.render_sum_reference(cam, scene, 0, 4, 5, loop=loop)
    torch.cuda.synchronize()
    assert float(got.sum()) > 0.0 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ttk.LOOPS)
def test_largest_scene_takes_the_shared_memory_opt_in(cuda_device, loop):
    """511 triangles and a light: above 48 KB of shared memory a block
    (rows, shade table, pool slots), so the launch needs the opt-in."""
    gen = torch.Generator().manual_seed(3)
    sb = tpt.SceneBuilder()
    sb.add_triangle((-50, 60, -50), (50, 60, -50), (0, 60, 50), tpt.Emit(4))
    for _ in range(ttk.MAX_CUDA_TRIS - 1):
        base = torch.rand(3, generator=gen) * 80 - 40
        sb.add_triangle(tuple(base.tolist()),
                        tuple((base + torch.randn(3, generator=gen) * 6)
                              .tolist()),
                        tuple((base + torch.randn(3, generator=gen) * 6)
                              .tolist()),
                        tpt.Diffuse(0.7))
    scene = sb.build(device=cuda_device)
    cam = tpt.make_camera((0, 0, -120), (0, 0, 1), (0, 1, 0), (32, 32),
                          1.0, device=cuda_device)
    assert scene.num_tris == ttk.MAX_CUDA_TRIS
    got = ttk.render_sum_cuda(cam, scene, 0, 2, 3, loop=loop)
    want = ttk.render_sum_reference(cam, scene, 0, 2, 3, loop=loop)
    torch.cuda.synchronize()
    assert float(got.sum()) > 0.0 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ttk.LOOPS)
def test_band_and_window_identities(cuda_device, loop):
    cam, scene = _on(cuda_device, "specular", (64, 48))
    full = ttk.render_sum_cuda(cam, scene, 0, 4, 5, loop=loop)
    band = ttk.render_sum_cuda(cam, scene, 0, 4, 5, h0=17, band_h=13,
                               loop=loop)
    assert torch.equal(band, full[17:30])
    split = (ttk.render_sum_cuda(cam, scene, 0, 1, 5, loop=loop)
             + ttk.render_sum_cuda(cam, scene, 1, 3, 5, loop=loop))
    torch.testing.assert_close(split, full, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_auto_backend_launches_kernel(cuda_device):
    cam, scene = _on(cuda_device, "cornell", (32, 32))
    before = ttk.LAUNCHES
    film = tpt.render_film(cam, scene, 4, 5)
    assert ttk.LAUNCHES > before
    brute = tpt.render_film(cam, scene, 4, 5, backend="brute")
    torch.cuda.synchronize()
    bad = ((film.data - brute.data).abs().amax(dim=-1) > FILM_ATOL)
    assert float(bad.float().mean()) <= MAX_FLIP_SHARE


@pytest.mark.cuda
def test_wrapper_does_not_synchronise(cuda_device):
    """The call returns while earlier work on the stream still runs."""
    import time

    cam, scene = _on(cuda_device, "cornell", (64, 64))
    ttk.render_sum_cuda(cam, scene, 0, 1, 1)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of device time at ~2 GHz
    t0 = time.perf_counter()
    ttk.render_sum_cuda(cam, scene, 0, 4, 5)
    seconds = time.perf_counter() - t0
    pending = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert pending and seconds < 0.25


@pytest.mark.cuda
def test_rejects_emissive_non_emit(cuda_device):
    sb = tpt.SceneBuilder()
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                    tpt.HostMaterial(tpt.DIFFUSE, color=(1, 1, 1),
                                     emit=(1, 0, 0)))
    scene = sb.build(device=cuda_device)
    cam = tpt.make_camera((0.2, 0.2, 2), (0, 0, -1), (0, 1, 0), (8, 8),
                          1.0, device=cuda_device)
    with pytest.raises(ValueError, match="non-EMIT"):
        ttk.render_sum_cuda(cam, scene, 0, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 1])
def test_kernel_row_multiple_is_the_wrappers(cuda_device, extra):
    """The wrapper pads to the row multiple the library reports, and the
    kernel refuses a row count off it (cudaErrorInvalidValue)."""
    from pathtracer_tpu_torch.utils import build
    cam, scene = _on(cuda_device, "cornell", (8, 8))
    lib = build.load_library()
    lib.pt_trace_row_multiple.restype = ctypes.c_int
    multiple = lib.pt_trace_row_multiple()
    rows = ttk._kernel_rows(scene, cam, "mt", multiple)
    n_rows = rows.shape[0] + extra
    rows = torch.cat([rows, rows.new_zeros((extra, rows.shape[1]))])
    tab = ttk._packed_table(scene)
    cp = ttk._camera_params(cam)
    film = torch.zeros((8, 8, 3), device=cuda_device)
    fn = lib.pt_trace_render
    fn.argtypes = ttk._ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(rows.data_ptr(), tab.data_ptr(), cp.data_ptr(),
             film.data_ptr(), n_rows, scene.num_tris, 8, 8, 8, 0, 0, 1, 5, 0, 0, 0,
             cuda_device.index or 0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert multiple > 1 and err == (0 if extra == 0 else 1)


def _lit_sphere(device, res, n_lat=10, n_lon=20):
    """sphere_in_box with the ceiling light in view (tests/test_beam.py)."""
    _, sb = tpt.meshes.sphere_in_box(n_lat, n_lon, device=device)
    cam = tpt.make_camera((250, 250, -420), (0, 0.35, 1), (0, 1, 0), res,
                          60 * tpt.DEG2RAD, 1.0, device=device)
    return cam, sb.build(device=device)


def _inline70(device, res, specular=False):
    """70 quads of distinct materials under one light: the beam accel
    inlines them.  All diffuse, or with ``specular`` every third one
    specular, so the inline decode also takes the specular branch."""
    sb = tpt.SceneBuilder()
    sb.add_quad(((100, 99, 30), (100, 99, 70), (0, 99, 70), (0, 99, 30)),
                tpt.Emit(1))
    for i in range(70):
        x, z = (i % 10) * 10.0, (i // 10) * 12.0 + 5.0
        m = (tpt.Specular(0.05 * (i % 4), 0.1 + 0.012 * i, 0.5, 0.9)
             if specular and i % 3 == 0
             else tpt.Diffuse(0.1 + 0.012 * i, 0.5, 0.9))
        sb.add_quad(((x, 0, z), (x + 9, 0, z), (x + 9, 0, z + 10),
                     (x, 0, z + 10)), m)
    cam = tpt.make_camera((50, 60, -60), (0, 0, 1), (0, 1, 0), res,
                          70 * tpt.DEG2RAD, 1.0, device=device)
    return cam, sb.build(device=device)


def _tie_scene(device, res=(64, 64)):
    """One triangle twice, red (scene triangle 0) and green (2), under a
    light, in the two leaves of a hand-made BVH: leaf 0 holds the red copy
    and the light, leaf 1 the green copy and a small triangle in front of
    it, so a walk enters leaf 1 first.  Every ray that hits the triangle
    ties exactly; the plain versions' argmin takes the lower packed row, the
    red copy's.  Returns (camera, scene, bvh); cut with max_tris=1 or
    sc_tris=1, each leaf is a cluster or a supercluster of its own."""
    import numpy as np
    tri = ((-5, -5, 10), (5, -5, 10), (0, 5, 10))
    sb = tpt.SceneBuilder()
    sb.add_triangle(*tri, tpt.Diffuse(0.8, 0.1, 0.1))
    sb.add_triangle((-10, 8, 8), (10, 8, 8), (0, 8, 12), tpt.Emit(4))
    sb.add_triangle(*tri, tpt.Diffuse(0.1, 0.8, 0.1))
    sb.add_triangle((6, -2, 3), (8, -2, 3), (7, 0, 3),
                    tpt.Diffuse(0.5, 0.5, 0.5))
    scene = sb.build(device=device)
    v = np.stack([a[:4] for a in scene.host_verts()], 1)
    lo, hi = v.min(1), v.max(1)
    nodes = ([0, 1, 2, 3], [0, 1], [2, 3])    # the root, then its leaves

    def ints(a):
        return torch.tensor(a, dtype=torch.int32)

    bvh = tpt.FlatBVH(
        lb=torch.from_numpy(np.stack([lo[n].min(0) for n in nodes])),
        rt=torch.from_numpy(np.stack([hi[n].max(0) for n in nodes])),
        left=ints([1, -1, -1]), right=ints([2, -1, -1]),
        tri_start=ints([0, 0, 2]), tri_end=ints([3, 1, 3]),
        tri_idx=ints([0, 1, 2, 3]), max_leaf=2, depth=2)
    cam = tpt.make_camera((0, 0, -10), (0, 0, 1), (0, 1, 0), res, 0.9,
                          device=device)
    return cam, scene, bvh


@pytest.mark.cuda
@pytest.mark.parametrize("max_tris", [16, 4])
def test_cluster_kernel_matches_reference(cuda_device, max_tris):
    """t and tid bit for bit (same operation order, --fmad=false; ties go
    to the lower row).  At 16 triangles a cluster the tree sits in shared
    memory; at 4, on the larger sphere, it does not leave room for two
    blocks an SM and the kernel reads it from global memory."""
    _, scene = (_lit_sphere("cpu", (8, 8)) if max_tris == 16
                else _lit_sphere("cpu", (8, 8), 50, 100))
    cs = tpt.build_clusters(scene, max_tris=max_tris).to(cuda_device)
    assert (cs.num_clusters - 1) * 64 > (114 << 10) or max_tris == 16
    gen = torch.Generator().manual_seed(0)
    o = (torch.rand((4000, 3), generator=gen) * 400 + 50).to(cuda_device)
    d = torch.randn((4000, 3), generator=gen)
    d = (d / d.norm(dim=-1, keepdim=True)).to(cuda_device)
    before = tck.LAUNCHES
    t, tid = tck.intersect_clusters(o, d, cs)
    assert tck.LAUNCHES == before + 1
    t_ref, tid_ref = tck.intersect_clusters_reference(o, d, cs)
    torch.cuda.synchronize()
    assert int((tid_ref >= 0).sum()) > 2000
    assert torch.equal(t, t_ref) and torch.equal(tid, tid_ref)


@pytest.mark.cuda
def test_tie_takes_the_lower_row(cuda_device):
    """The duplicated triangle: both kernels take the red copy, the lower
    packed row, as the plain versions' argmin does, though their walks
    enter the green copy's box first."""
    from pathtracer_tpu_torch.camera import get_rays
    cam, scene, bvh = _tie_scene(cuda_device)
    cs = tpt.build_clusters(scene, bvh=bvh, max_tris=1).to(cuda_device)
    accel = tpt.build_beam_accel(scene, bvh=bvh, sc_tris=1)
    assert cs.num_clusters == accel.num_superclusters == 2
    idx = torch.arange(64 * 64, device=cuda_device)
    half = torch.full((64 * 64,), 0.5, device=cuda_device)
    o, d = get_rays(cam, idx % 64, idx // 64, half, half)
    t, tid = tck.intersect_clusters(o, d, cs)
    t_ref, tid_ref = tck.intersect_clusters_reference(o, d, cs)
    got = tbk.render_sum_beam(cam, scene, 0, 4, 5, accel=accel)
    want = tbk.render_sum_beam_reference(cam, scene, 0, 4, 5, accel=accel)
    torch.cuda.synchronize()
    assert int((tid == 0).sum()) > 0 and int((tid == 2).sum()) == 0
    assert torch.equal(t, t_ref) and torch.equal(tid, tid_ref)
    rgb = got.mean(dim=(0, 1))
    assert torch.equal(got, want) and float(rgb[0]) > float(rgb[1])


@pytest.mark.cuda
def test_wrappers_refuse_a_tree_deeper_than_the_stack(cuda_device):
    """Both wrappers read the stack size from the library and raise
    ValueError on a deeper tree; there is no fallback."""
    from pathtracer_tpu_torch.utils import build
    lib = build.load_library()
    lib.pt_tree_stack_size.restype = ctypes.c_int
    deep = lib.pt_tree_stack_size() + 1
    cam, scene = _lit_sphere(cuda_device, (64, 64))
    accel = dataclasses.replace(tbk._accel_for(scene), sc_tree_depth=deep)
    with pytest.raises(ValueError, match="deeper"):
        tbk.render_sum_beam(cam, scene, 0, 1, 1, accel=accel)
    cs = dataclasses.replace(tpt.build_clusters(scene).to(cuda_device),
                             tree_depth=deep)
    o = torch.zeros((256, 3), device=cuda_device)
    with pytest.raises(ValueError, match="deeper"):
        tck.intersect_clusters(o, o + 1.0, cs)


def _garden256(device):
    """mesh_garden(grid=1) (2,028 triangles) under the garden's camera at
    the realtime frame's 256 x 256."""
    scene = tpt.meshes.mesh_garden(grid=1, device=device)[1].build(
        device=device)
    cam = tpt.make_camera((250, 330, -420), (0, -0.12, 1), (0, 1, 0),
                          (256, 256), 62 * tpt.DEG2RAD, 1.0, device=device)
    return cam, scene


# (scene, depth, spp, sample runs): at 64 x 64 the launch has 16 pixel
# blocks, fewer than the card's SMs.  Runs None: the card's own launch plan
# (one sample a block at this film); 3: three runs of unequal length where
# 3 does not divide spp.
BEAM_CASES = ([(name, depth, spp, runs)
               for name in ("sphere", "cornell", "specular", "inline70",
                            "inline70_specular")
               for depth in (1, 5) for spp in (1, 4, 15, 16)
               for runs in (None, 3)]
              + [("garden256", 5, 15, None)])


@pytest.mark.cuda
@pytest.mark.parametrize("name,depth,spp,runs", BEAM_CASES)
def test_beam_kernel_matches_reference(cuda_device, monkeypatch, name, depth,
                                       spp, runs):
    """All four kernel instances: table or inline materials, each with and
    without the specular branch; sample counts that the launch plan's runs
    divide and do not; and the realtime frame's shape on a garden.  The
    film is the plain version's bit for bit however the plan cuts the
    samples."""
    make = {"sphere": lambda: _lit_sphere(cuda_device, (64, 64)),
            "cornell": lambda: tpt.cornell_box(res=(64, 64),
                                               device=cuda_device),
            "specular": lambda: tpt.modified_cornell(0.05, res=(64, 64),
                                                     device=cuda_device),
            "inline70": lambda: _inline70(cuda_device, (64, 64)),
            "inline70_specular": lambda: _inline70(cuda_device, (64, 64),
                                                   True),
            "garden256": lambda: _garden256(cuda_device)}
    cam, scene = make[name]()
    accel = tbk._accel_for(scene)
    assert scene.has_specular == name.startswith(("specular", "inline70_s"))
    assert accel.mats_inline == name.startswith("inline70")
    if runs is not None:
        monkeypatch.setattr(tbk, "launch_plan", lambda n_pix, k, _: (
            tbk.LaunchPlan(n_pix, k, min(runs, k))))
    before = tbk.LAUNCHES
    got = tbk.render_sum_beam(cam, scene, 0, spp, depth)
    assert tbk.LAUNCHES == before + 1
    want = tbk.render_sum_beam_reference(cam, scene, 0, spp, depth)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and float(got.sum()) > 0.0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_beam_counts_sum_over_samples_and_blocks_follow_the_plan(
        cuda_device):
    """A pixel's tested rows are summed over the blocks of its sample runs:
    one 4-spp launch counts what four 1-spp launches count; BLOCKS grows by
    the launch plan's blocks."""
    from pathtracer_tpu_torch.utils import build
    cam, scene = _lit_sphere(cuda_device, (64, 64))
    n_pix = 2 * tbk.TILE_PX
    index = cuda_device.index or 0
    resident = tbk._resident_blocks(build.load_library(),
                                    tbk._accel_for(scene),
                                    scene.has_specular, index)
    plan = tbk.launch_plan(n_pix, 4, resident)
    assert plan.groups == 4 and resident >= torch.cuda.get_device_properties(
        index).multi_processor_count
    once = torch.zeros(n_pix, dtype=torch.int32, device=cuda_device)
    launches, blocks = tbk.LAUNCHES, tbk.BLOCKS
    tbk.render_tiles_beam(cam, scene, 0, 4, 5, counts=once)
    assert tbk.LAUNCHES == launches + 1
    assert tbk.BLOCKS == blocks + plan.blocks
    split = torch.zeros_like(once)
    for s in range(4):
        tbk.render_tiles_beam(cam, scene, s, 1, 5, counts=split)
    torch.cuda.synchronize()
    assert int(once.sum()) > 0 and torch.equal(once, split)


@pytest.mark.cuda
def test_beam_band_and_window_identities(cuda_device):
    cam, scene = _lit_sphere(cuda_device, (200, 72))
    full = tbk.render_tiles_beam(cam, scene, 0, 4, 5)
    band = tbk.render_tiles_beam(cam, scene, 0, 4, 5, tile0=5, n_tiles=3)
    assert torch.equal(band, full[:, 5 * tbk.TILE_PX:8 * tbk.TILE_PX])
    split = (tbk.render_tiles_beam(cam, scene, 0, 1, 5)
             + tbk.render_tiles_beam(cam, scene, 1, 3, 5))
    torch.testing.assert_close(split, full, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_large_scene_backends_launch_their_kernels(cuda_device):
    cam, _ = _lit_sphere(cuda_device, (32, 32))
    scene = tpt.meshes.mesh_garden(grid=1)[1].build(device=cuda_device)
    assert scene.padded_size > 512
    before = tbk.LAUNCHES
    beam = tpt.render_film(cam, scene, 4, 3)
    assert tbk.LAUNCHES > before
    before = tck.LAUNCHES
    cluster = tpt.render_film(cam, scene, 4, 3, backend="cluster")
    assert tck.LAUNCHES > before
    bvh = tpt.render_film(cam, scene, 4, 3, backend="bvh")
    torch.cuda.synchronize()
    bad = ((cluster.data - bvh.data).abs().amax(dim=-1) > FILM_ATOL)
    assert float(bad.float().mean()) <= MAX_FLIP_SHARE
    assert bool(torch.isfinite(beam.data).all())
    assert tbk.count_tri_tests(cam, scene, samples=2, depth=3) > 0.0


@pytest.mark.cuda
def test_auto_falls_back_to_cluster_with_a_warning(cuda_device):
    sb = tpt.meshes.mesh_garden(grid=1)[1]
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                    tpt.HostMaterial(tpt.DIFFUSE, color=(1, 1, 1),
                                     emit=(1, 0, 0)))
    scene = sb.build(device=cuda_device)
    cam, _ = _lit_sphere(cuda_device, (16, 16))
    before = tck.LAUNCHES
    with pytest.warns(UserWarning, match="cluster"):
        tpt.render_film(cam, scene, 1, 2)
    assert tck.LAUNCHES > before


@pytest.mark.cuda
def test_large_scene_wrappers_do_not_synchronise(cuda_device):
    """The beam and cluster wrappers return while earlier work on the
    stream still runs (after a first call has built and cached the accel
    and the raster index)."""
    import time

    cam, scene = _lit_sphere(cuda_device, (64, 64))
    cs = tpt.build_clusters(scene).to(cuda_device)
    gen = torch.Generator().manual_seed(1)
    o = (torch.rand((4096, 3), generator=gen) * 400 + 50).to(cuda_device)
    d = torch.randn((4096, 3), generator=gen).to(cuda_device)
    tbk.render_sum_beam(cam, scene, 0, 1, 1)
    tck.intersect_clusters(o, d, cs)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of device time at ~2 GHz
    t0 = time.perf_counter()
    tbk.render_sum_beam(cam, scene, 0, 4, 5)
    tck.intersect_clusters(o, d, cs)
    seconds = time.perf_counter() - t0
    pending = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert pending and seconds < 0.25


def _chrome_events(tmp_path, fn):
    """The Chrome trace events of ``fn()`` under ``profiling.profile_to``,
    the device work ended inside the capture."""
    with profiling.profile_to(str(tmp_path)):
        fn()
        torch.cuda.synchronize()
    with open(tmp_path / "trace.json") as f:
        return json.load(f)["traceEvents"]


def _launches_inside(events, span_name, kernel_part):
    """Whether the host launch of every kernel whose name holds
    ``kernel_part`` (found by its correlation id) lies inside the one
    ``span_name`` span."""
    (span,) = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == span_name]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and kernel_part in e.get("name", "")]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    inside = [span["ts"] <= launch["ts"]
              and launch["ts"] + launch["dur"] <= span["ts"] + span["dur"]
              for launch in (launches[k["args"]["correlation"]]
                             for k in kernels)]
    return bool(inside) and all(inside)


def _spans_named(events, name):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == name]


@pytest.mark.cuda
def test_auto_beam_render_spans(cuda_device, tmp_path):
    """``"auto"`` on a large mesh keys the beam accel twice (the backend's
    choice and the launch wrapper), from the scene's memoised key, so a
    repeated render hashes nothing, and launches every beam kernel inside
    ``pt.beam.launches``."""
    cam, _ = _lit_sphere(cuda_device, (32, 32))
    scene = tpt.meshes.mesh_garden(grid=1)[1].build(device=cuda_device)
    assert scene.padded_size > 512
    tpt.render_film(cam, scene, 4, 3)
    events = _chrome_events(tmp_path, lambda: tpt.render_film(cam, scene,
                                                              4, 3))
    assert len(_spans_named(events, "pt.accel.lookup")) == 2
    assert _spans_named(events, "pt.scene.hash") == []
    assert _launches_inside(events, "pt.beam.launches", "beam_kernel")


@pytest.mark.cuda
def test_auto_beam_second_render_hashes_nothing(cuda_device, tmp_path):
    """Two ``"auto"`` renders of one unedited mesh on the beam route: the
    first hashes the scene once for both lookups, the second not at all,
    and the films are equal bit for bit."""
    cam, _ = _lit_sphere(cuda_device, (32, 32))
    scene = tpt.meshes.mesh_garden(grid=1)[1].build(device=cuda_device)
    assert scene.padded_size > 512
    films = []

    def render():
        films.append(tpt.render_film(cam, scene, 4, 3, seed=7,
                                     backend="auto").data)
    first = _chrome_events(tmp_path / "first", render)
    second = _chrome_events(tmp_path / "second", render)
    assert len(_spans_named(first, "pt.scene.hash")) == 1
    assert _spans_named(second, "pt.scene.hash") == []
    assert _spans_named(second, "pt.beam.launches")
    assert torch.equal(films[0], films[1])


@pytest.mark.cuda
def test_garden_realtime_session_matches_the_plain_viewer(cuda_device):
    """The benchmark's realtime garden: 62 frames of the session, the
    cell's first key before frame 60.  The displayed values of frames 59,
    60 and 61 at the cell's drawn pixels against the plain viewer
    (``benchmark/reference/realtime.py``), within the cell's limit."""
    from benchmark.drivers.render import draw_pixels
    from benchmark.harness import core
    from benchmark.reference import compare, scenes
    from benchmark.reference.realtime import Viewer
    from pathtracer_tpu_torch.realtime import RealtimeSession
    from pathtracer_tpu_torch.scene import Scene

    ctx = core.context("garden_realtime", 2**31 + 17, 0.0, False, 0.0)
    t, chk = ctx.traffic, ctx.workload["check"]
    res = (t["width"], t["height"])
    arrays = scenes.make_scene(ctx.config)
    session = RealtimeSession(
        tpt.make_camera(**scenes.camera_args(ctx.config, res),
                        device=cuda_device),
        Scene.from_arrays(*arrays.as_args(), device=cuda_device),
        t["depth"], t["frame_samples"], seed=ctx.seed, backend=t["backend"])
    assert session.backend == "beam"
    w, h = draw_pixels(ctx.seed, chk["pixels"], *res, "cpu")
    key = t["keys"][0]
    shown = {}
    for g in range(62):
        if g == 60:
            session.key(key)
        frame = session.step()
        if g >= 59:
            shown[g] = torch.from_numpy(frame[h.numpy(), w.numpy()])
    viewer = Viewer(arrays, scenes.make_camera(ctx.config, res), cuda_device,
                    w.to(cuda_device), h.to(cuda_device), t["depth"],
                    t["frame_samples"], ctx.seed, chk["launch_spp"])
    gaps = [compare.film_gap(shown[59], viewer.display((), 59)),
            compare.film_gap(shown[60], viewer.display((key,), 0)),
            compare.film_gap(shown[61], viewer.display((key,), 1))]
    assert max(gaps) <= ctx.workload["limits"]["film_gap"], gaps


@pytest.mark.cuda
def test_cornell_launches_inside_their_span(cuda_device, tmp_path):
    cam, scene = _on(cuda_device, "cornell", (64, 64))
    events = _chrome_events(tmp_path, lambda: tpt.render_film(
        cam, scene, 64, 5))
    assert _launches_inside(events, "pt.trace.launches", "trace_kernel")


TRACE_INSTANCES = {   # (scene, loop): all four trace kernel instances
    "trace": ("specular", None),
    "trace_mt": ("specular", "mt"),
    "trace_plucker_diffuse": ("cornell", "plucker"),
    "trace_mt_diffuse": ("cornell", "mt"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [*TRACE_INSTANCES, "cluster",
                                    "cluster_global", "beam"])
def test_kernels_write_only_their_outputs(cuda_device, monkeypatch, kernel):
    """Every buffer a wrapper allocates, the kernel's outputs among them,
    sits between guard margins that must come back untouched; a second
    launch must give the same bits (a shared-memory race would not).  The
    CUDA sanitizer tools do not run on every machine with a card; this
    test does."""
    guard = card.GuardedTorch()
    if kernel in TRACE_INSTANCES:
        name, loop = TRACE_INSTANCES[kernel]
        cam, scene = _on(cuda_device, name, (64, 48))
        module = ttk

        def run():
            return ttk.render_sum_cuda(cam, scene, 0, 4, 5, h0=17, band_h=13,
                                       loop=loop)
    elif kernel.startswith("cluster"):
        # "cluster_global": a tree too large for shared memory.
        _, host = (_lit_sphere(cuda_device, (8, 8), 50, 100)
                   if kernel == "cluster_global"
                   else _lit_sphere(cuda_device, (8, 8)))
        cs = tpt.build_clusters(
            host, max_tris=4 if kernel == "cluster_global" else 16
        ).to(cuda_device)
        gen = torch.Generator().manual_seed(2)
        o = (torch.rand((1000, 3), generator=gen) * 400 + 50).to(cuda_device)
        d = torch.randn((1000, 3), generator=gen)
        d = (d / d.norm(dim=-1, keepdim=True)).to(cuda_device)
        module = tck

        def run():
            return torch.cat([x.float() for x in
                              tck.intersect_clusters(o, d, cs)])
    else:
        cam, scene = _inline70(cuda_device, (200, 72), specular=True)
        counts = guard.zeros(3 * tbk.TILE_PX, dtype=torch.int32,
                             device=cuda_device)
        module = tbk

        def run():
            return tbk.render_tiles_beam(cam, scene, 0, 4, 5, tile0=8,
                                         n_tiles=3, counts=counts)
    monkeypatch.setattr(module, "torch", guard)
    first = run()
    second = run()
    torch.cuda.synchronize()
    assert len(guard.buffers) >= 2 and guard.hits() == 0
    assert bool(torch.isfinite(first).all()) and torch.equal(first, second)
    assert float(first.sum()) > 0.0


# Gradients of the differentiable path through the kernel against the plain
# intersection: the hits are bit-identical, so the per-ray terms are too;
# the table's gradient sums them in a fixed order with the one-hot gather (a
# matmul) and with the gather kernel pair (an order-fixed segment sum), so
# the gradients are equal bit for bit.


def _loss_and_grad(loss, params):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    value = loss(leaves)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


# Lit spheres: (n_lat, n_lon, film side, spp, depth).  sphere9812 is the
# large scene at the size the gradient path was first held at on the card.
SPHERES = {"sphere200": (10, 20, 32, 4, 3),
           "sphere9812": (50, 100, 64, 8, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("sphere,gather", [("sphere200", "onehot"),
                                           ("sphere200", "gather_kernel"),
                                           ("sphere9812", "gather_kernel")])
def test_diff_cluster_kernel_matches_plain(cuda_device, monkeypatch, sphere,
                                           gather):
    """make_loss through backend="cluster": the kernel's film and
    gradients equal the plain intersection's bit for bit, whichever gather
    both sides take; one render launches the kernel once a bounce, and
    the gather kernel pair once a bounce each way where it gathers.
    sphere9812's table is above ONEHOT_GATHER_MAX_ROWS, so the kernel pair
    is its only gather."""
    from pathtracer_tpu_torch import diff
    from pathtracer_tpu_torch.ops import trace as ttrace
    from pathtracer_tpu_torch.ops.cuda import gather_kernel as tgk

    n_lat, n_lon, side, spp, depth = SPHERES[sphere]
    cam, scene = _lit_sphere(cuda_device, (side, side), n_lat, n_lon)
    params = diff.material_params(scene)
    rows = params["albedo"].shape[0]
    assert (rows <= ttrace.ONEHOT_GATHER_MAX_ROWS) == (sphere == "sphere200")
    if gather == "gather_kernel":
        monkeypatch.setattr(ttrace, "ONEHOT_GATHER_MAX_ROWS", 0)
    target = torch.full((side, side, 3), 0.2, device=cuda_device)
    loss = diff.make_loss(cam, scene, target, spp, depth, backend="cluster")
    before = tck.LAUNCHES
    pair = dict(tgk.LAUNCHES)
    film = diff.render_film_diff(cam, scene, params, spp, depth,
                                 backend="cluster")
    value, grads = _loss_and_grad(loss, params)
    assert tck.LAUNCHES == before + 2 * depth
    # The film carries no gradient, so it takes the kernel pair either way.
    grad_pair = depth if gather == "gather_kernel" else 0
    assert tgk.LAUNCHES == {"forward": pair["forward"] + depth + grad_pair,
                            "backward": pair["backward"] + grad_pair}
    with monkeypatch.context() as m:
        m.setattr(tck, "intersect_clusters",
                  lambda o, d, cs: tck.intersect_clusters_reference(o, d, cs))
        plain_film = diff.render_film_diff(cam, scene, params, spp, depth,
                                           backend="cluster")
        plain_value, plain_grads = _loss_and_grad(loss, params)
    torch.cuda.synchronize()
    assert tck.LAUNCHES == before + 2 * depth
    assert float(film.mean()) > 0.0 and torch.equal(film, plain_film)
    assert torch.equal(value, plain_value)
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
        assert torch.equal(g, plain_grads[k]), k


def _recorded_brute_calls(monkeypatch):
    """Each call of the brute kernel's wrapper from now on, in order: its
    rays (copied) and hits."""
    calls = []
    launch = tbr.intersect_brute_cuda

    def record(o, d, v1, v2, v3):
        t, tid = launch(o, d, v1, v2, v3)
        calls.append((o.clone(), d.clone(), t, tid))
        return t, tid

    monkeypatch.setattr(tbr, "intersect_brute_cuda", record)
    return calls


@pytest.mark.cuda
def test_brute_kernel_holds_the_recovery_rays(cuda_device, monkeypatch):
    """One half-film of the Cornell recovery at its own width (128^2, 192
    spp, depth 5) through diff.render_film_diff: one launch a bounce of
    3,145,728 rays, and each bounce's (t, tid) equal intersect_brute's over
    the CPU path's chunks bit for bit: the camera rays, the bounce rays
    from surface points, and the rays of dead paths at their stale
    poses."""
    from pathtracer_tpu_torch import diff

    cam, scene = tpt.cornell_box(res=(128, 128), device=cuda_device)
    calls = _recorded_brute_calls(monkeypatch)
    before = tbr.LAUNCHES
    film = diff.render_film_diff(cam, scene, diff.material_params(scene),
                                 192, 5)
    assert tbr.LAUNCHES == before + 5 and len(calls) == 5
    assert float(film.mean()) > 0.0
    chunk = diff.BRUTE_PAIRS // scene.padded_size
    prev = None
    for b, (o, d, t, tid) in enumerate(calls):
        assert o.shape == (192, 128, 128, 3) and tid.shape == o.shape[:-1]
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        want = [intersect_brute(o[r:r + chunk], d[r:r + chunk], scene.v1,
                                scene.v2, scene.v3)
                for r in range(0, o.shape[0], chunk)]
        assert torch.equal(t.reshape(-1), torch.cat([w[0] for w in want]))
        assert torch.equal(tid.reshape(-1),
                           torch.cat([w[1] for w in want])), b
        hit = float((tid >= 0).float().mean())
        assert 0.0 < hit < 1.0, (b, hit)
        if prev is not None:
            stale = (o == prev[0]).all(-1) & (d == prev[1]).all(-1)
            assert bool(stale.any()) and not bool(stale.all()), b
        prev = (o, d)


@pytest.mark.cuda
def test_brute_kernel_train_step_matches_plain(cuda_device, monkeypatch):
    """One inverse._train_step of a Cornell recovery at 32^2, 16 spp
    paired, depth 5 (albedo and emission): one launch a bounce of each
    half-film, and the loss, the parameters and Adam's moments equal bit
    for bit those of the same step with intersect_brute in the kernel's
    place."""
    from pathtracer_tpu_torch import inverse

    cam, scene = tpt.cornell_box(res=(32, 32), device=cuda_device)
    target = tpt.render_film(cam, scene, 256, 5, backend="cuda").data
    optimize = ("albedo", "emit")

    def step():
        start = inverse.init_params(scene)
        params = {n: start[n].detach().clone().requires_grad_(True)
                  for n in inverse.PARAM_NAMES}
        opt = torch.optim.Adam([params[n] for n in inverse.PARAM_NAMES],
                               lr=0.08, betas=inverse.ADAM_BETAS,
                               eps=inverse.ADAM_EPS)
        pb = inverse._Problem(
            camera=cam, scene=scene, target=target, samples=16, depth=5,
            seed=7, backend="brute", accel=None, loss="paired",
            rel_eps=2e-2, masks=inverse._row_masks(scene, optimize),
            rough_spsa=False)
        loss = inverse._train_step(pb, params, opt, 0, 0.08)
        state = [opt.state[params[n]] for n in inverse.PARAM_NAMES]
        return loss, [params[n].detach() for n in inverse.PARAM_NAMES] + [
            s[k] for s in state for k in ("exp_avg", "exp_avg_sq")]

    before = tbr.LAUNCHES
    loss, leaves = step()
    assert tbr.LAUNCHES == before + 2 * 5
    with monkeypatch.context() as m:
        m.setattr(tbr, "intersect_brute_cuda", intersect_brute)
        plain_loss, plain_leaves = step()
    torch.cuda.synchronize()
    assert tbr.LAUNCHES == before + 2 * 5
    assert math.isfinite(loss) and loss == plain_loss
    assert any(bool(x.any()) for x in leaves[3:])
    for k, (x, y) in enumerate(zip(leaves, plain_leaves)):
        assert torch.equal(x, y), k


@pytest.mark.cuda
def test_recover_materials_raises_without_the_kernel(cuda_device,
                                                     monkeypatch):
    """On a CUDA scene the cluster backend launches the kernel or raises:
    with the library unloadable, recover_materials raises and nothing
    falls back to the plain version or the CPU."""
    from pathtracer_tpu_torch import inverse
    from pathtracer_tpu_torch.utils import build

    def refuse(*args, **kwargs):
        raise RuntimeError("nvcc failed (test)")

    cam, scene = _lit_sphere(cuda_device, (16, 16))
    target = torch.zeros((16, 16, 3), device=cuda_device)
    monkeypatch.setattr(build, "load_library", refuse)
    before = tck.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed"):
        inverse.recover_materials(cam, scene, target, steps=1, samples=2,
                                  depth=2, backend="cluster",
                                  optimize=("albedo",))
    assert tck.LAUNCHES == before


@pytest.mark.cuda
def test_recover_materials_runs_on_the_card(cuda_device):
    """A few steps of the paired recovery on the card: finite losses, the
    parameters and the result on the scene's device."""
    from pathtracer_tpu_torch import diff, inverse

    cam, scene = tpt.corner_scene(res=(16, 16), device=cuda_device)
    target = diff.render_film_diff(cam, scene, diff.material_params(scene),
                                   32, 2, sample_offset=900_000)
    mats, losses = inverse.recover_materials(
        cam, scene, target, steps=4, samples=4, depth=2,
        optimize=("albedo",))
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert all(v.device.type == "cuda" for v in mats.values())


@pytest.mark.cuda
@pytest.mark.parametrize("sphere,side,backend", [("sphere200", 32, "cluster"),
                                                ("sphere9812", 128, "auto")])
def test_wavefront_cluster_matches_plain_intersector(cuda_device,
                                                     monkeypatch, sphere,
                                                     side, backend):
    """The wavefront's film through the cluster kernel (``"auto"`` picks it
    on the large sphere) equals the same render with the plain cluster
    intersector, bit for bit, and render_film's cluster film within the
    film bar; one kernel launch a live bounce and no other kernel."""
    from pathtracer_tpu_torch.ops import wavefront as twf

    n_lat, n_lon = SPHERES[sphere][:2]
    cam, scene = _lit_sphere(cuda_device, (side, side), n_lat, n_lon)
    before, live = _launches(), twf.LIVE_BOUNCES
    film = twf.render_wavefront(cam, scene, 4, 5, backend=backend)
    torch.cuda.synchronize()
    assert _since(before) == (0, twf.LIVE_BOUNCES - live, 0)
    assert twf.LIVE_BOUNCES > live
    with monkeypatch.context() as m:
        m.setattr(tck, "intersect_clusters",
                  lambda o, d, cs: tck.intersect_clusters_reference(o, d, cs))
        plain = twf.render_wavefront(cam, scene, 4, 5, backend="cluster")
    tile = tpt.render_film(cam, scene, 4, 5, backend="cluster").data
    torch.cuda.synchronize()
    assert float(film.mean()) > 0.0 and torch.equal(film, plain)
    assert card.film_diff(film, tile)[1] <= MAX_FLIP_SHARE


# The wavefront's dense film against render_film's: the same operations
# in another grouping of the path sum.
WAVEFRONT_BRUTE_ATOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "specular05"])
def test_wavefront_brute_matches_render_film(cuda_device, name):
    """render_film(backend="wavefront") on the Cornell box and
    modified_cornell(0.05) at 64^2, 4 spp, depth 5: within
    WAVEFRONT_BRUTE_ATOL of render_film's brute film, within the film bar
    of the trace kernel's, and equal to a second run bit for bit."""
    from pathtracer_tpu_torch.ops import wavefront as twf

    if name == "cornell":
        cam, scene = tpt.cornell_box(res=(64, 64), device=cuda_device)
    else:
        cam, scene = tpt.modified_cornell(0.05, res=(64, 64),
                                          device=cuda_device)
    film = tpt.render_film(cam, scene, 4, 5, backend="wavefront").data
    again = twf.render_wavefront(cam, scene, 4, 5, backend="brute")
    brute = tpt.render_film(cam, scene, 4, 5, backend="brute").data
    kern = tpt.render_film(cam, scene, 4, 5, backend="cuda").data
    torch.cuda.synchronize()
    assert float(film.mean()) > 0.0 and torch.equal(film, again)
    assert float((film - brute).abs().max()) <= WAVEFRONT_BRUTE_ATOL
    assert card.film_diff(film, kern)[1] <= MAX_FLIP_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["brute", "cluster"])
def test_wavefront_compaction_is_bit_identical(cuda_device, backend):
    """Contributions go back to their block slots before the film sum, so
    compact_every=1 gives the film of compact_every=0 bit for bit on the
    card too."""
    from pathtracer_tpu_torch.ops import wavefront as twf

    if backend == "brute":
        cam, scene = _on(cuda_device, "cornell", (64, 64))
    else:
        cam, scene = _lit_sphere(cuda_device, (32, 32))
    base = twf.render_wavefront(cam, scene, 4, 5, backend=backend)
    film = twf.render_wavefront(cam, scene, 4, 5, backend=backend,
                                compact_every=1)
    torch.cuda.synchronize()
    assert float(base.mean()) > 0.0 and torch.equal(film, base)


# -- the main paths at their own sizes -------------------------------------


def _launches():
    return ttk.LAUNCHES, tck.LAUNCHES, tbk.LAUNCHES


def _since(before):
    """(trace, cluster, beam) launches since ``before`` (``_launches()``)."""
    return tuple(n - b for n, b in zip(_launches(), before))


@pytest.mark.cuda
def test_cornell_1024_main_path(cuda_device, tmp_path):
    """render() of the 1024^2 Cornell box at 256 spp through "auto": the
    kernel's default loop and no other launch; a finite, lit film whose
    brightest pixel sees the light; equal to the brute backend's film at
    4 spp within the film bar."""
    cam, scene = tpt.cornell_box(res=(1024, 1024), device=cuda_device)
    default = ttk.LOOP_LAUNCHES[ttk.DEFAULT_LOOP]
    before = _launches()
    film = tpt.render(cam, scene, samples=256, depth=5,
                      filename=str(tmp_path / "cornell.png"), verbose=False)
    torch.cuda.synchronize()
    trace, cluster, beam = _since(before)
    assert trace > 0 and cluster == beam == 0
    assert ttk.LOOP_LAUNCHES[ttk.DEFAULT_LOOP] - default == trace
    img = film.data
    assert tuple(img.shape) == (1024, 1024, 3)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01
    # A pixel whose every sample hits the light (emission 1) averages
    # exactly 1.0; lit walls stay far below it.
    assert float(img.mean(dim=-1).max()) >= 0.99
    card.brightest_sees_light(cam, scene, tpt.read_png(
        str(tmp_path / "cornell.png")))
    kern = tpt.render_film(cam, scene, 4, 5, backend="cuda").data
    brute = tpt.render_film(cam, scene, 4, 5, backend="brute").data
    torch.cuda.synchronize()
    assert card.film_diff(kern, brute)[1] <= MAX_FLIP_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ttk.LOOPS)
@pytest.mark.parametrize("name", ["cornell", "specular05"])
def test_trace_kernel_bit_identical_at_the_main_shape(cuda_device, name,
                                                      loop):
    """Each loop at the main path's launch shape (1024^2, 16 spp, depth 5)
    on the Cornell box and modified_cornell(0.05): the kernel's sum equals
    its plain version's bit for bit."""
    if name == "cornell":
        cam, scene = tpt.cornell_box(res=(1024, 1024), device=cuda_device)
    else:
        cam, scene = tpt.modified_cornell(0.05, res=(1024, 1024),
                                          device=cuda_device)
    before = ttk.LOOP_LAUNCHES[loop]
    got = ttk.render_sum_cuda(cam, scene, 0, 16, 5, loop=loop)
    want = ttk.render_sum_reference(cam, scene, 0, 16, 5, loop=loop)
    torch.cuda.synchronize()
    assert ttk.LOOP_LAUNCHES[loop] > before
    assert float(want.mean()) > 0.0 and torch.equal(got, want)


LARGE_SCENES = {   # name: (builder, main-path spp at 512^2)
    "sphere9812": (lambda dev: tpt.meshes.sphere_in_box(50, 100, device=dev),
                   64),
    "garden105708": (lambda dev: tpt.meshes.mesh_garden(device=dev), 2048),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LARGE_SCENES))
def test_large_scene_main_path(cuda_device, tmp_path, name):
    """render() at 512^2 through "auto" launches the beam kernel and no
    other; the film is finite and lit; the committed render's view (the
    garden's 512^2 film, the sphere's 256^2 crop at 2048 spp) holds the
    committed render's bars; the kernel at the main path's launch shape
    equals its plain version on two bands of tiles."""
    make, spp = LARGE_SCENES[name]
    cam, sb = make(cuda_device)
    scene = sb.build(device=cuda_device)
    png = str(tmp_path / f"{name}.png")
    before = _launches()
    film = tpt.render(cam, scene, samples=spp, depth=5, filename=png,
                      verbose=False)
    torch.cuda.synchronize()
    trace, cluster, beam = _since(before)
    assert beam > 0 and trace == cluster == 0
    img = film.data
    assert tuple(img.shape) == (512, 512, 3)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01
    if name == "sphere9812":
        # The committed render is the 256^2 corner of this view.
        tpt.render(card.with_res(cam, (256, 256)), scene, samples=2048,
                   depth=5, filename=png, verbose=False)
    card.hold_golden(png, card.GOLDENS[name], card.GOLDEN_MIN_PSNR[name])
    card.hold_main_path_bands(cam, scene, spp)


@pytest.mark.cuda
def test_large_sphere_cluster_render(cuda_device):
    """render() of sphere_in_box(50, 100) at 512^2, 4 spp, depth 5 through
    backend="cluster": the cluster kernel and no other; a finite, lit
    film."""
    cam, sb = LARGE_SCENES["sphere9812"][0](cuda_device)
    scene = sb.build(device=cuda_device)
    before = _launches()
    film = tpt.render(cam, scene, samples=4, depth=5, backend="cluster",
                      verbose=False)
    torch.cuda.synchronize()
    trace, cluster, beam = _since(before)
    assert cluster > 0 and trace == beam == 0
    img = film.data
    assert tuple(img.shape) == (512, 512, 3)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind", [("sphere9812", "camera"),
                                       ("sphere9812", "random"),
                                       ("garden105708", "camera")])
def test_cluster_kernel_holds_large_scene_rays(cuda_device, name, kind):
    """65,536 rays through the render's own cluster set of a large scene:
    camera rays of the 512^2 film, or random rays inside the room; t and
    tid bit for bit against the plain version."""
    cam, sb = LARGE_SCENES[name][0](cuda_device)
    scene = sb.build(device=cuda_device)
    cs = tck.clusters_for(scene)
    gen = np.random.default_rng(6)
    n = 1 << 16
    if kind == "camera":
        o, d = card.camera_rays(cam, n, gen)
    else:
        o = torch.from_numpy(gen.uniform(1, 499, (n, 3)).astype(np.float32))
        d = gen.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o, d = o.to(cuda_device), torch.from_numpy(d).to(cuda_device)
    before = tck.LAUNCHES
    assert card.hold_clusters(o, d, cs, n) > n // 4
    assert tck.LAUNCHES == before + 1


@pytest.mark.cuda
def test_garden_recovery_through_the_cluster_kernel(cuda_device):
    """Three paired recovery steps on the garden at 64^2, 8 spp, depth 4:
    one cluster launch a bounce of each render and no other kernel; then a
    one-sided gradcheck of the two largest albedo gradients at 2 spp,
    depth 3, under 0.05 (the JAX package's own run read 1.03e-2)."""
    from pathtracer_tpu_torch import diff, inverse

    cam, sb = tpt.meshes.mesh_garden(device=cuda_device)
    scene = sb.build(device=cuda_device)
    cam = card.with_res(cam, (64, 64))
    target = tpt.render_film(cam, scene, 1024, 4, backend="beam").data
    before = _launches()
    _, losses = inverse.recover_materials(
        cam, scene, target, steps=3, samples=8, depth=4, lr=0.08,
        lr_end=8e-3, backend="cluster", optimize=("albedo",))
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert _since(before) == (0, 3 * 2 * 4, 0)
    loss = diff.make_loss(cam, scene, target, 2, 3, backend="cluster")
    params = diff.material_params(scene)
    _, grads = _loss_and_grad(loss, params)
    top = torch.argsort(grads["albedo"].abs().flatten())[-2:].tolist()
    _, rel = diff.gradcheck(loss, params, eps=2e-2,
                            indices=[("albedo", i) for i in top],
                            mode="one_sided")
    assert rel < 0.05, rel


@pytest.mark.cuda
def test_garden_recovery_steps_follow_the_plain_reference(cuda_device):
    """The benchmark's garden recovery at 64^2, 8 spp, depth 4: two steps
    of ``inverse._train_step`` through the cluster kernel against the
    plain mesh recovery (``benchmark/reference/recover_mesh.py``); each
    loss, the first gradient and the update within the ``garden_recover``
    cell's limits."""
    from benchmark.drivers.recover import TARGET_SEED_MIX
    from benchmark.harness import core
    from benchmark.reference import compare, scenes
    from benchmark.reference.recover import start_params
    from benchmark.reference.recover_mesh import MeshRecovery, tracer
    from pathtracer_tpu_torch import diff, inverse
    from pathtracer_tpu_torch.scene import Scene

    ctx = core.context("garden_recover", 2**31 + 29, 0.0, False, 0.0)
    t, limits = ctx.traffic, ctx.workload["limits"]
    res, spp, depth, steps = (64, 64), 8, t["depth"], 2
    arrays = scenes.make_scene(ctx.config)
    cam_ref = scenes.make_camera(ctx.config, res)
    pix = torch.arange(res[0] * res[1], device=cuda_device)
    target = tracer(arrays, cam_ref, cuda_device).film(
        pix % res[0], pix // res[0], 64, depth, ctx.seed ^ TARGET_SEED_MIX,
        64).reshape(res[1], res[0], 3)
    scene = Scene.from_arrays(*arrays.as_args(), device=cuda_device)
    p0 = start_params(arrays, cuda_device)
    params = {n: p0[n].clone().requires_grad_(True)
              for n in inverse.PARAM_NAMES}
    opt = torch.optim.Adam([params[n] for n in inverse.PARAM_NAMES],
                           lr=t["lr"], betas=inverse.ADAM_BETAS,
                           eps=inverse.ADAM_EPS)
    pb = inverse._Problem(
        camera=tpt.make_camera(**scenes.camera_args(ctx.config, res),
                               device=cuda_device),
        scene=scene, target=target, samples=spp, depth=depth,
        seed=ctx.seed, backend="cluster",
        accel=diff.make_accel(scene, "cluster"), loss="paired",
        rel_eps=2e-2, masks=inverse._row_masks(scene, tuple(t["optimize"])),
        rough_spsa=False)
    before = _launches()
    losses, first = [], None
    for k in range(steps):
        losses.append(inverse._train_step(pb, params, opt, k, t["lr"]))
        if k == 0:
            first = {n: opt.state[params[n]]["exp_avg"] / (1 - 0.9)
                     for n in inverse.PARAM_NAMES}
    assert _since(before) == (0, steps * 2 * depth, 0)
    ref = MeshRecovery(arrays, cam_ref, target, samples=spp, depth=depth,
                       seed=ctx.seed, lr=t["lr"], optimize=t["optimize"],
                       device=cuda_device)
    ref_losses, ref_first, ref_last, _ = ref.run(p0, steps)
    counted = compare.counted_leaves(ref_first)
    change = {n: params[n].detach() - p0[n] for n in inverse.PARAM_NAMES}
    ref_change = {n: ref_last[n] - p0[n] for n in inverse.PARAM_NAMES}
    gaps = {"loss_gap": max(compare.rel_gap(a, b)
                            for a, b in zip(losses, ref_losses)),
            "grad_gap": compare.leaf_gaps(first, ref_first, counted),
            "update_gap": compare.leaf_gaps(change, ref_change, counted)}
    assert "albedo" in counted
    assert all(gaps[n] <= limits[n] for n in gaps), gaps


@pytest.mark.cuda
def test_cornell_recovery_under_its_bars(cuda_device):
    """tests/test_inverse.py's recovery on the card: 32^2, 250 steps, 64
    spp, depth 4, the target rendered by the trace kernel; visible diffuse
    albedo and emission errors under 0.15."""
    from pathtracer_tpu_torch import inverse

    cam, scene = tpt.cornell_box(res=(32, 32), device=cuda_device)
    target = tpt.render_film(cam, scene, 2048, 4, backend="cuda").data
    mats, losses = inverse.recover_materials(
        cam, scene, target, steps=250, samples=64, depth=4, lr=0.08,
        lr_end=4e-3, optimize=("albedo", "emit"))
    assert np.isfinite(losses).all() and len(losses) == 250
    mtype, alb_true, emit_true, _ = scene.host_materials()
    vis = (inverse.visible_pixel_counts(cam, scene) >= 8) & (
        mtype == tpt.DIFFUSE)
    assert vis.sum() >= 10
    alb = mats["albedo"].cpu().numpy()[:scene.num_tris]
    emit = mats["emit"].cpu().numpy()[:scene.num_tris]
    light = mtype == tpt.EMIT
    alb_err = float(np.abs(alb - alb_true)[vis].mean())
    emit_err = float(np.abs(emit[light] - emit_true[light]).mean())
    assert alb_err < 0.15 and emit_err < 0.15, (alb_err, emit_err)


@pytest.mark.cuda
def test_two_ranks_on_one_card_match_one_process(cuda_device, tmp_path):
    """Two gloo ranks sharing the card (NCCL refuses two ranks on one GPU):
    the tile split (2, 1) of the trace and beam kernels' sharded renders is
    one process's render_film bit for bit, the sample split (1, 2) one
    process's sum of the same two sample windows; every rank launches the
    kernel; the train step's parameters are equal on both ranks after each
    step."""
    work = str(tmp_path)
    (res, spp), half = card.SHARD_CORNELL, card.SHARD_CORNELL[1] // 2
    cam, scene = tpt.cornell_box(res=res, device=cuda_device)
    ref = {"cornell_2x1": tpt.render_film(cam, scene, spp, 5,
                                          backend="cuda").data,
           "cornell_1x2": (ttk.render_sum_cuda(cam, scene, 0, half, 5)
                           + ttk.render_sum_cuda(cam, scene, half, half, 5))
           / spp}
    res, spps = card.SHARD_GARDEN
    cam_g, sb = tpt.meshes.mesh_garden(device=cuda_device)
    cam_g, garden = card.with_res(cam_g, res), sb.build(device=cuda_device)
    ref["garden_2x1"] = tpt.render_film(cam_g, garden, spps[1], 5,
                                        backend="beam").data
    half = spps[2] // 2
    ref["garden_1x2"] = tbk._to_raster(
        tbk.render_tiles_beam(cam_g, garden, 0, half, 5)
        + tbk.render_tiles_beam(cam_g, garden, half, half, 5), *res) / spps[2]
    res, spp, steps = card.SHARD_TRAIN
    cam_t, scene_t = tpt.cornell_box(res=res, device=cuda_device)
    torch.save(tpt.render_film(cam_t, scene_t, 4096, 5,
                               backend="cuda").data.cpu(),
               tmp_path / "target.pt")
    ref = {k: v.cpu() for k, v in ref.items()}
    del scene, garden, sb
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    done = card.run_shard_workers(work)
    assert all(rc == 0 for rc, _ in done), "\n".join(t for _, t in done)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(card.SHARD_RANKS)]
    assert all(r["backend"] == "gloo" for r in ranks)
    for name, want in ref.items():
        films = [torch.load(tmp_path / f"{name}_{r}.pt")
                 for r in range(card.SHARD_RANKS)]
        assert float(want.mean()) > 0.0
        for r, film in enumerate(films):
            assert torch.equal(film, want), (name, r)
            assert ranks[r][name] > 0, (name, r)
    assert all(np.isfinite(r["losses"]).all() for r in ranks)
    for k in range(steps):
        params = [torch.load(tmp_path / f"train{k}_{r}.pt")
                  for r in range(card.SHARD_RANKS)]
        for p in params[1:]:
            assert p.keys() == params[0].keys()
            assert all(torch.equal(p[n], params[0][n]) for n in p), k


@pytest.mark.cuda
@pytest.mark.parametrize("name,backend,module", [
    ("cornell", "cuda", ttk), ("garden105708", "beam", tbk)])
def test_realtime_session_is_the_running_mean(cuda_device, name, backend,
                                              module):
    """Four 15-spp frames of the session at 256^2 launch the backend's
    kernel; the accumulated film is the running mean of the same frames
    rendered by render_film, bit for bit; 'w' resets it to frame 0."""
    from pathtracer_tpu_torch.realtime import RealtimeSession

    if name == "cornell":
        cam, scene = tpt.cornell_box(res=(256, 256), device=cuda_device)
    else:
        cam, sb = tpt.meshes.mesh_garden(device=cuda_device)
        cam, scene = (card.with_res(cam, (256, 256)),
                      sb.build(device=cuda_device))
    sess = RealtimeSession(cam, scene, depth=5, frame_samples=15)
    assert sess.backend == backend
    before = module.LAUNCHES
    for _ in range(4):
        img = sess.step()
    assert module.LAUNCHES > before
    assert img.shape == (256, 256, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    want = torch.zeros_like(sess._accum)
    for k in range(4):
        cur = tpt.render_film(cam, scene, 15, 5, seed=sess.seed + k,
                              backend=backend).data
        t = 1.0 / (k + 1)
        want = want * (1.0 - t) + cur * t
    assert torch.equal(sess._accum, want)
    sess.key("w")
    assert sess.frame == 0 and not bool(sess._accum.any())


@pytest.mark.cuda
def test_cli_render_sees_the_light(cuda_device, tmp_path):
    """``render cornell`` at 256^2, 64 spp, backend cuda: the trace kernel
    runs, and the PNG's brightest pixel sees the light."""
    from pathtracer_tpu_torch import cli

    png = str(tmp_path / "cornell.png")
    before = ttk.LAUNCHES
    cli.main(["render", "cornell", png, "--res", "256", "--spp", "64",
              "--backend", "cuda"])
    assert ttk.LAUNCHES > before
    img = tpt.read_png(png)
    assert img.shape == (256, 256, 3)
    cam, scene = tpt.cornell_box(res=(256, 256), device=cuda_device)
    card.brightest_sees_light(cam, scene, img)


# -- the randomized sweep ---------------------------------------------------

FUZZ_IDS = [(kind, i) for kind, cases in card.FUZZ_CASES.items()
            for i in range(len(cases))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,index", FUZZ_IDS)
def test_fuzz_cases_match_plain(cuda_device, kind, index):
    """Each kernel twice on a random scene at an odd launch shape, on the
    normal library: bit for bit against its plain version and against its
    first launch, every guarded buffer's NaN margins untouched."""
    got = card.run_fuzz_case(cuda_device, kind, card.FUZZ_CASES[kind][index])
    assert card.case_holds(got, cuda_device), got


@pytest.mark.cuda
def test_fuzz_sweep_on_the_checked_library(cuda_device):
    """Every case of the sweep, then the corner scene's launches 256 times,
    on the bounds-checked library in a child process with
    CUDA_LAUNCH_BLOCKING=1: no trap, no mismatch, no guard hit."""
    done = card.run_checked_sweep()
    assert done.returncode == 0, done.stdout[-20000:] + done.stderr[-20000:]


@pytest.mark.cuda
def test_replay_with_asynchronous_launches(cuda_device):
    """The corner scene's launches 256 times on the normal library, each
    launch followed by its plain version without waiting for the card."""
    assert card.replay_mismatches(cuda_device) == 0
