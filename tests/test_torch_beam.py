"""The beam kernel's plain version (pathtracer_tpu_torch.ops.cuda.beam_kernel)
against pathtracer_tpu's beam kernel in interpret mode, and the driver
around it: bands of tiles, sample windows, checkpoints, the accel cache and
the Morton film layout.  On the CPU the wrappers take the plain version."""

import numpy as np
import pytest
import torch

import pathtracer_tpu as jpt
from pathtracer_tpu import meshes as jmeshes
from pathtracer_tpu.ops.pallas import beam_kernel as jbk

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch import meshes as tmeshes
from pathtracer_tpu_torch.ops.cuda import beam_kernel as tbk
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
from pathtracer_tpu_torch.utils import checkpoint as tckpt

from _torch_parity import as_np, assert_films_close, carry


def lit_sphere(m, res, n_lat=10, n_lon=20):
    """sphere_in_box with the camera tilted up so the ceiling light is in
    view (tests/test_beam.py): small films of the stock view are black.
    ``m`` is either package."""
    kw = {"device": "cpu"} if m is tpt else {}
    _, sb = {jpt: jmeshes, tpt: tmeshes}[m].sphere_in_box(n_lat, n_lon,
                                                           **kw)
    cam = m.make_camera((250, 250, -420), (0, 0.35, 1), (0, 1, 0), res,
                        60 * m.DEG2RAD, 1.0, **kw)
    return cam, sb.build(**kw)


# (JAX camera and scene, spp, depth, seed).  At most three JAX renders: the
# interpreted beam kernel takes 3-9 s each on the CPU.  The (33, 65) film
# crops its padded squares on both axes; its specular walls take the
# kernel's specular branch (the shared cube draws and the candidate order).
CASES = {
    "cornell32_depth1": (lambda: jpt.cornell_box(res=(32, 32)), 2, 1, 3),
    "sphere32_depth3": (lambda: lit_sphere(jpt, (32, 32)), 2, 3, 3),
    "specular33x65_depth3": (
        lambda: jpt.modified_cornell(0.05, res=(33, 65)), 1, 3, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_interpret(case):
    """Film bar of tests/_torch_parity.py.  The near-tie flips found: none
    (0 pixels beyond 2e-4 in each case; the JAX kernel's reciprocal with a
    Newton step and the port's IEEE division give the same hits here)."""
    make, spp, depth, seed = CASES[case]
    jcam, jscene = make()
    want = np.asarray(jbk.render_film_beam(jcam, jscene, samples=spp,
                                           depth=depth, seed=seed,
                                           interpret=True).data)
    assert want.max() > 0  # the light is in view: not black against black
    tcam, tscene = carry(jcam, jscene)
    got = tbk.render_sum_beam_reference(tcam, tscene, 0, spp, depth,
                                        seed=seed) / spp
    assert tuple(got.shape) == want.shape
    assert_films_close(got, want, max_flip_share=0.0)
    film = tbk.render_film_beam(tcam, tscene, spp, depth, seed=seed)
    assert torch.equal(film.data, got)     # the CPU wrapper: the plain path


def test_band_of_tiles_equals_full_launch():
    cam, scene = lit_sphere(tpt, (128, 64), 6, 8)   # 4 tiles of 2048 px
    full = tbk.render_tiles_beam(cam, scene, 0, 2, 2)
    band = tbk.render_tiles_beam(cam, scene, 0, 2, 2, tile0=1, n_tiles=2)
    assert float(full.max()) > 0
    assert torch.equal(band, full[:, tbk.TILE_PX:3 * tbk.TILE_PX])
    with pytest.raises(ValueError, match="tiles"):
        tbk.render_tiles_beam(cam, scene, 0, 1, 1, tile0=3, n_tiles=2)


def test_sample_windows_sum_to_one_window():
    cam, scene = lit_sphere(tpt, (32, 32), 6, 8)
    one = tbk.render_sum_beam(cam, scene, 0, 3, 3)
    two = (tbk.render_sum_beam(cam, scene, 0, 1, 3)
           + tbk.render_sum_beam(cam, scene, 1, 2, 3))
    assert float(one.max()) > 0
    torch.testing.assert_close(two, one, rtol=0, atol=1e-6)
    # spp_per_call only regroups the launches' sums.
    per_sample = tbk.render_sum_beam(cam, scene, 0, 3, 3, spp_per_call=1)
    torch.testing.assert_close(per_sample, one, rtol=0, atol=1e-6)


def test_checkpoint_resume_bit_identical(tmp_path, monkeypatch):
    # One sample per checkpoint window, so the abort falls mid-render.
    monkeypatch.setattr(ttk, "RAYS_PER_CALL", 32 * 32)
    cam, scene = lit_sphere(tpt, (32, 32), 6, 8)
    ck = str(tmp_path / "beam_ck")
    full = tpt.render_film(cam, scene, 4, 2, seed=3, backend="beam")
    assert float(full.data.max()) > 0
    with pytest.raises(KeyboardInterrupt):
        tpt.render_film(cam, scene, 4, 2, seed=3, backend="beam",
                        checkpoint=ck, _abort_after=1)
    _, done, meta = tckpt.load_render_checkpoint(ck)
    assert done == 1 and meta["backend"] == "beam" and meta["block_spp"] == 1
    resumed = tpt.render_film(cam, scene, 4, 2, seed=3, backend="beam",
                              checkpoint=ck)
    assert torch.equal(resumed.data, full.data)


def test_accel_cache_not_fooled_by_sum_preserving_edit():
    """Swapping the red and green walls keeps every array sum; the byte
    hash still tells the scenes apart (tests/test_beam.py)."""
    cam, scene = tpt.cornell_box(res=(32, 32), device="cpu")
    alb = as_np(scene.albedo).copy()
    red = np.nonzero(alb[:, 0] > alb[:, 1] + 0.2)[0]
    green = np.nonzero(alb[:, 1] > alb[:, 0] + 0.2)[0]
    assert red.size and green.size
    swapped = alb.copy()
    swapped[red] = alb[green[:red.size]]
    swapped[green[:red.size]] = alb[red]
    assert np.isclose(swapped.sum(), alb.sum())
    scene2 = tpt.scene_from_arrays(
        *(as_np(getattr(scene, f)) for f in ("v1", "v2", "v3", "mat_type")),
        swapped, as_np(scene.emit), as_np(scene.roughness), scene.num_tris,
        device="cpu")
    a1, a2 = tbk._accel_for(scene), tbk._accel_for(scene2)
    assert a1 is not a2 and tbk._accel_for(scene) is a1
    assert not torch.equal(a1.mats, a2.mats)
    f1 = tbk.render_sum_beam(cam, scene, 0, 8, 3)
    f2 = tbk.render_sum_beam(cam, scene2, 0, 8, 3)
    assert not torch.equal(f1, f2)


def test_accel_cache_evicts_the_least_recently_used(monkeypatch):
    """A hit refreshes its entry: after four other scenes and one more hit
    on the first, a fifth scene evicts the second, not the first."""
    monkeypatch.setattr(tbk, "_ACCEL_CACHE", [])
    scenes = [tpt.meshes.sphere_in_box(4, 6 + k, device="cpu")[1].build(
        device="cpu")
              for k in range(5)]
    first = tbk._accel_for(scenes[0])
    for s in scenes[1:4]:
        tbk._accel_for(s)
    assert tbk._accel_for(scenes[0]) is first
    second = tbk._ACCEL_CACHE[0][1]
    tbk._accel_for(scenes[4])
    assert tbk._accel_for(scenes[0]) is first
    assert all(a is not second for _, a in tbk._ACCEL_CACHE)


@pytest.mark.parametrize("wp, hp", [(64, 64), (128, 64), (192, 320)])
def test_sq_to_raster_is_a_permutation(wp, hp):
    m = tbk._sq_to_raster(wp, hp)
    assert sorted(m.tolist()) == list(range(wp * hp))
    np.testing.assert_array_equal(m, jbk._sq_to_raster(wp, hp))
    assert tbk._padded_res(wp - 1, hp - 63) == jbk._padded_res(wp - 1, hp - 63)


def test_pixels_follow_the_device_order():
    """The plain version's (w, h) of each device-order pixel are the
    raster index's."""
    cam, _ = lit_sphere(tpt, (200, 72))
    wp, hp = tbk._padded_res(200, 72)
    w, h, tile = tbk._pixels(cam, 0, wp * hp // tbk.TILE_PX, "cpu")
    np.testing.assert_array_equal(as_np(h * wp + w), tbk._sq_to_raster(wp, hp))
    assert int(tile[-1]) == wp * hp // tbk.TILE_PX - 1


def _launches(res, samples, depth=5, tile0=0, n_tiles=None):
    """[(n_pix, spp)] of the kernel launches of a render of ``samples`` at
    ``res`` (a band of tiles when ``n_tiles`` is given)."""
    cam = tpt.make_camera((0, 0, -10), (0, 0, 1), (0, 1, 0), res, 1.0,
                          device="cpu")
    _, n_tiles = tbk._band(cam, tile0, n_tiles)
    per_call = tbk._default_spp_per_call(cam, samples, depth)
    return [(n_tiles * tbk.TILE_PX, min(per_call, samples - s))
            for s in range(0, samples, per_call)]


# The launches of the benchmark's large-mesh cells: a realtime frame (256²,
# 15 spp), the offline job (512², 64 spp: launches of 25, 25 and 14), a
# row band of the offline film, and a film of fewer blocks than SMs.
PLAN_LAUNCHES = {
    "realtime_256_15": _launches((256, 256), 15),
    "offline_512_64": _launches((512, 512), 64),
    "band_512_64": _launches((512, 512), 64, tile0=40, n_tiles=48),
    "small_64_16": _launches((64, 64), 16),
}


@pytest.mark.parametrize("resident", [132, 264, 396])
@pytest.mark.parametrize("shape", sorted(PLAN_LAUNCHES))
def test_launch_plan_covers_each_pixel_sample_once(shape, resident):
    """Every (pixel block, sample) of a launch lies in exactly one block;
    the runs differ by at most one sample; the launch has LAUNCH_WAVES
    waves of ``resident`` blocks, or one sample a block."""
    assert {spp for _, spp in PLAN_LAUNCHES["offline_512_64"]} == {25, 14}
    for n_pix, spp in PLAN_LAUNCHES[shape]:
        plan = tbk.launch_plan(n_pix, spp, resident)
        assert n_pix % tbk.BLOCK_PX == 0 and 1 <= plan.groups <= spp
        runs = [plan.samples(g) for g in range(plan.groups)]
        seen = np.zeros((spp, plan.pixel_blocks), np.int64)
        for b in range(plan.blocks):
            lo, hi = runs[b // plan.pixel_blocks]
            seen[lo:hi, b % plan.pixel_blocks] += 1
        assert (seen == 1).all()
        lengths = [hi - lo for lo, hi in runs]
        assert max(lengths) - min(lengths) <= 1
        assert plan.blocks >= min(tbk.LAUNCH_WAVES * resident,
                                  spp * plan.pixel_blocks)


def test_launch_plan_fills_the_card_for_a_realtime_frame():
    """A 256² frame of 15 samples is 256 pixel blocks, fewer than an H100
    holds at once (3 blocks an SM at most: the garden's 68,288 B of shared
    memory a block, of the SM's 228 KB; 132 SMs).  The plan gives it at
    least 4 waves of them."""
    (n_pix, spp), = PLAN_LAUNCHES["realtime_256_15"]
    resident = 3 * 132
    assert n_pix // tbk.BLOCK_PX < resident
    plan = tbk.launch_plan(n_pix, spp, resident)
    assert plan.blocks >= 4 * resident and plan.groups == spp


def test_rejects_what_the_kernel_cannot_take():
    cam, scene = lit_sphere(tpt, (16, 16), 6, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tbk.count_tri_tests(cam, scene)
    with pytest.raises(ValueError, match="counts"):
        tbk.render_tiles_beam(cam, scene, 0, 1, 1,
                              counts=torch.zeros(2048, dtype=torch.int32))
    sb = tpt.SceneBuilder()
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                    tpt.HostMaterial(tpt.DIFFUSE, color=(1, 1, 1),
                                     emit=(1, 0, 0)))
    with pytest.raises(ValueError, match="non-EMIT"):
        tbk.render_sum_beam(cam, sb.build(device="cpu"), 0, 1, 1)


def test_inline_materials_match_brute_at_depth_1():
    """A scene of more than 64 materials inlines them in the rows.  At
    depth 1 a beam film is first-hit emission with the pixel stream's
    jitter, so it equals the brute backend's film bit for bit."""
    sb = tpt.SceneBuilder()
    s = 100.0
    sb.add_quad(((s, s - 1, 30), (s, s - 1, 70), (0, s - 1, 70),
                 (0, s - 1, 30)), tpt.Emit(1))
    for i in range(70):
        x = (i % 10) * 10.0
        z = (i // 10) * 12.0 + 5.0
        sb.add_quad(((x, 0, z), (x + 9, 0, z), (x + 9, 0, z + 10),
                     (x, 0, z + 10)), tpt.Diffuse(0.1 + 0.012 * i, 0.5, 0.9))
    scene = sb.build(device="cpu")
    assert tbk._accel_for(scene).mats_inline
    cam = tpt.make_camera((50, 60, -60), (0, 0, 1), (0, 1, 0), (16, 16),
                          70 * tpt.DEG2RAD, 1.0, device="cpu")
    beam = tbk.render_sum_beam(cam, scene, 0, 2, 1, seed=3)
    brute = tpt.render_film(cam, scene, 2, 1, seed=3, backend="brute").data
    assert float(beam.max()) > 0
    assert torch.equal(beam / 2, brute)
