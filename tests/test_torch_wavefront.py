"""pathtracer_tpu_torch.ops.wavefront against pathtracer_tpu.ops.wavefront.

The stages (raygen, bounce_stage, compact) and whole renders take the same
inputs, made from a numpy seed, in both packages.  Bars: RNG states and the
compaction permutation bit-exact; rays atol 1e-6 after raygen; a bounce's
outputs within the film bar of tests/_torch_parity.py (atol 2e-4) on all
but 1% of the rays, its alive mask equal but for near-tie hits (1%); films
with ``assert_films_close``.  Against the port's own ``render_film`` a
wavefront film is held to the JAX test's bar, atol 1e-5
(tests/test_wavefront.py), and its films with and without compaction to bit
identity.
"""

import numpy as np
import pytest
import torch

import pathtracer_tpu as jpt
from pathtracer_tpu import rng as jrng
from pathtracer_tpu.ops import intersect as jisect
from pathtracer_tpu.ops import trace as jtrace
from pathtracer_tpu.ops import wavefront as jwf

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch import rng as trng
from pathtracer_tpu_torch.ops import trace as ttrace
from pathtracer_tpu_torch.ops import wavefront as twf
from pathtracer_tpu_torch.ops.intersect import intersect_brute
from pathtracer_tpu_torch.render import _auto_backend
from pathtracer_tpu_torch.scene import Scene

from _torch_parity import as_np, assert_films_close, carry, scene_pair
from test_torch_beam import lit_sphere

ATOL = 2e-4              # tests/_torch_parity.py FILM_ATOL
MAX_BAD_SHARE = 0.01     # near-tie hits, as MAX_FLIP_SHARE
SELF_ATOL = 1e-5         # tests/test_wavefront.py's bar

STAGE_SCENES = {
    "corner": lambda res: jpt.corner_scene(res=res),
    "cornell": lambda res: jpt.cornell_box(res=res),
    "specular": lambda res: jpt.modified_cornell(0.05, res=res),
}


def _pixels(res, spp):
    width, height = res
    pix = np.tile(np.arange(width * height, dtype=np.int32), spp)
    return pix, pix % width, pix // width


def _queues(rng, jcam, res, spp, seed=3):
    """The same first queue in both packages: camera rays of ``spp``
    samples a pixel, random throughputs, states and alive mask."""
    pix, w, h = _pixels(res, spp)
    sidx = np.repeat(np.arange(spp, dtype=np.int32), res[0] * res[1])
    state = np.asarray(jrng.sample_seed(w, h, res[1], sidx, seed))
    ray_o, ray_d, state = jwf.raygen(jcam, w, h, state)
    R = pix.shape[0]
    return {
        "ray_o": np.asarray(ray_o), "ray_d": np.asarray(ray_d),
        "thr": rng.uniform(0.2, 1.0, (R, 3)).astype(np.float32),
        "pix": pix, "state": np.asarray(state),
        "alive": rng.uniform(size=R) < 0.9,
    }


def _to_jax(q):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in q.items()}


def _to_torch(q):
    return {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if k == "state" else np.asarray(v).dtype)) for k, v in
        q.items()}


def _share_off(got, want, atol=ATOL):
    got, want = as_np(got), as_np(want)
    assert np.all(np.isfinite(got))
    bad = np.abs(got - want) > atol
    if bad.ndim > 1:
        bad = bad.any(axis=-1)
    return float(bad.mean())


def test_raygen_matches_jax():
    res, spp = (16, 16), 2
    (jcam, _), (tcam, _) = scene_pair("cornell", res)
    pix, w, h = _pixels(res, spp)
    sidx = np.repeat(np.arange(spp, dtype=np.int32), res[0] * res[1])
    jstate = jrng.sample_seed(w, h, res[1], sidx, 7)
    tstate = trng.sample_seed(torch.from_numpy(w), torch.from_numpy(h),
                              res[1], torch.from_numpy(sidx), 7)
    jo, jd, jstate = jwf.raygen(jcam, w, h, jstate)
    to, td, tstate = twf.raygen(tcam, torch.from_numpy(w),
                                torch.from_numpy(h), tstate)
    np.testing.assert_array_equal(as_np(tstate),
                                  np.asarray(jstate).astype(np.int64))
    np.testing.assert_allclose(as_np(to), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(as_np(td), np.asarray(jd), atol=1e-6)


@pytest.mark.parametrize("park", [False, True])
@pytest.mark.parametrize("name", sorted(STAGE_SCENES))
def test_bounce_stage_matches_jax(name, park):
    """Two bounces from the same queue: the first from camera rays, the
    second from the JAX package's first output (rays inside the scene), so
    no difference carries from one to the next."""
    res = (16, 16)
    rng = np.random.default_rng(11)
    jcam, jscene = STAGE_SCENES[name](res)
    _, tscene = carry(jcam, jscene)
    assert tscene.has_specular == jscene.has_specular
    jtable, ttable = jtrace.shade_table(jscene), ttrace.shade_table(tscene)
    pose = ttrace.park_pose(tscene) if park else None
    assert pose is None or pose == jtrace.park_pose(jscene)

    def jfn(o, d):
        return jisect.intersect_brute(o, d, jscene.v1, jscene.v2, jscene.v3)

    def tfn(o, d):
        return intersect_brute(o, d, tscene.v1, tscene.v2, tscene.v3)

    queue = _queues(rng, jcam, res, 2)
    for _ in range(2):
        jc, jq = jwf.bounce_stage(jtable, jfn, _to_jax(queue),
                                  jscene.has_specular, park=pose)
        tc, tq = twf.bounce_stage(ttable, tfn, _to_torch(queue),
                                  tscene.has_specular, park=pose)
        np.testing.assert_array_equal(as_np(tq["state"]),
                                      np.asarray(jq["state"]).astype(
                                          np.int64))
        np.testing.assert_array_equal(as_np(tq["pix"]), queue["pix"])
        alive_off = float((as_np(tq["alive"]) != np.asarray(jq["alive"]))
                          .mean())
        assert alive_off <= MAX_BAD_SHARE, alive_off
        assert np.asarray(jq["alive"]).any() and np.asarray(jc).max() >= 0
        for key, got, want in (("contrib", tc, jc),
                               ("thr", tq["thr"], jq["thr"]),
                               ("ray_o", tq["ray_o"], jq["ray_o"]),
                               ("ray_d", tq["ray_d"], jq["ray_d"])):
            share = _share_off(got, want)
            assert share <= MAX_BAD_SHARE, (key, share)
        queue = {k: np.asarray(v) for k, v in jq.items()}


def test_compact_matches_jax():
    rng = np.random.default_rng(5)
    R = 4096
    queue = {
        "ray_o": rng.normal(size=(R, 3)).astype(np.float32),
        "ray_d": rng.normal(size=(R, 3)).astype(np.float32),
        "thr": rng.uniform(size=(R, 3)).astype(np.float32),
        "pix": np.arange(R, dtype=np.int32),
        "state": rng.integers(0, 1 << 32, R, dtype=np.uint64).astype(
            np.uint32),
        "alive": rng.uniform(size=R) < 0.37,
    }
    want = jwf.compact(_to_jax(queue))
    got = twf.compact(_to_torch(queue))
    assert set(got) == set(want)
    np.testing.assert_array_equal(as_np(got["pix"]),
                                  np.asarray(want["pix"]))
    for k in got:
        np.testing.assert_array_equal(
            as_np(got[k]), np.asarray(want[k]).astype(as_np(got[k]).dtype))
    n = int(queue["alive"].sum())
    assert as_np(got["alive"])[:n].all() and not as_np(got["alive"])[n:].any()


def _random_scene():
    """tests/test_wavefront.py's 60 random triangles under one light."""
    from pathtracer_tpu.scene import Diffuse, Emit, SceneBuilder
    rng = np.random.default_rng(0)
    sb = SceneBuilder()
    for _ in range(60):
        base = rng.uniform(-4, 4, 3)
        sb.add_triangle(base, base + rng.normal(0, 1, 3),
                        base + rng.normal(0, 1, 3), Diffuse(0.8))
    sb.add_triangle((-20, 10, -20), (20, 10, -20), (0, 10, 30), Emit(1))
    cam = jpt.make_camera((0, 0, -12), (0, 0, 1), (0, 1, 0), (16, 16),
                          60 * jpt.DEG2RAD, 1.0)
    return cam, sb.build()


# (JAX camera and scene, spp, depth, backend, whether a prebuilt accel is
# given).  The JAX "bvh" is its packet traversal, the port's the per-ray
# intersect_bvh; the JAX "cluster" runs its Pallas kernel interpreted, the
# port's its plain version on the CPU.
RENDER_CASES = {
    "corner16_brute": (lambda: jpt.corner_scene(res=(16, 16)), 4, 3,
                       "brute", False),
    "random60_bvh": (_random_scene, 2, 3, "bvh", True),
    "sphere8_cluster": (lambda: lit_sphere(jpt, (8, 8), 8, 16), 2, 2,
                        "cluster", False),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_wavefront_matches_jax(case):
    make, spp, depth, backend, prebuilt = RENDER_CASES[case]
    jcam, jscene = make()
    tcam, tscene = carry(jcam, jscene)
    jkw = {"bvh": jpt.build_bvh(jscene)} if prebuilt else {}
    tkw = {"bvh": tpt.build_bvh(tscene)} if prebuilt else {}
    want = np.asarray(jwf.render_wavefront(jcam, jscene, spp, depth, seed=4,
                                           backend=backend, **jkw))
    assert want.max() > 0
    got = twf.render_wavefront(tcam, tscene, spp, depth, seed=4,
                               backend=backend, **tkw)
    assert got.shape == (tcam.height, tcam.width, 3)
    assert_films_close(got, want)


@pytest.mark.parametrize("name,depth", [("corner", 3), ("cornell", 5),
                                        ("specular", 5)])
def test_render_wavefront_matches_render_film(name, depth):
    _, (cam, scene) = scene_pair(name, (16, 16))
    got = twf.render_wavefront(cam, scene, 4, depth, seed=2)
    want = tpt.render_film(cam, scene, 4, depth, seed=2,
                           backend="brute").data
    assert float(want.max()) > 0
    np.testing.assert_allclose(as_np(got), as_np(want), atol=SELF_ATOL)


def _lit_sphere_cpu():
    return lit_sphere(tpt, (16, 16), 8, 12)


@pytest.mark.parametrize("backend", ["brute", "bvh", "cluster"])
def test_compaction_is_bit_identical(backend):
    """Rays carry their block slot through ``compact``, and the film sum
    sees the contributions in slot order: bit for bit the film without
    compaction (which parks dead rays on "bvh" and "cluster")."""
    cam, scene = _lit_sphere_cpu()
    base = twf.render_wavefront(cam, scene, 2, 4, backend=backend)
    assert float(base.max()) > 0
    for every in (1, 2):
        film = twf.render_wavefront(cam, scene, 2, 4, backend=backend,
                                    compact_every=every)
        assert torch.equal(film, base), every


def test_block_size_that_does_not_divide(monkeypatch):
    """samples=6 with spp_per_block=4 runs two blocks of 3 samples; the
    counters see every bounce either run or skipped."""
    _, (cam, scene) = scene_pair("corner", (8, 8))
    blocks = []
    real = twf.sample_seed
    monkeypatch.setattr(twf, "sample_seed", lambda w, *a: (
        blocks.append(w.shape[0]), real(w, *a))[1])
    for name in ("SYNCS", "LIVE_BOUNCES", "SKIPPED"):
        monkeypatch.setattr(twf, name, 0)
    film = twf.render_wavefront(cam, scene, 6, 3, spp_per_block=4)
    assert blocks == [3 * 64, 3 * 64]
    assert twf.LIVE_BOUNCES + twf.SKIPPED == 2 * 3
    assert twf.LIVE_BOUNCES - 2 <= twf.SYNCS <= twf.LIVE_BOUNCES
    assert torch.equal(film, twf.render_wavefront(cam, scene, 6, 3,
                                                  spp_per_block=3))
    want = tpt.render_film(cam, scene, 6, 3, backend="brute").data
    np.testing.assert_allclose(as_np(film), as_np(want), atol=SELF_ATOL)


def test_counters_count_live_bounces():
    """On the cluster backend each live bounce is one intersect call, so
    the kernel's launches on the card equal LIVE_BOUNCES."""
    cam, scene = _lit_sphere_cpu()
    assert twf._make_intersect(scene, "cluster", None)[1] is not None
    before = (twf.SYNCS, twf.LIVE_BOUNCES, twf.SKIPPED)
    twf.render_wavefront(cam, scene, 2, 4, backend="cluster")
    syncs, live, skipped = (a - b for a, b in zip(
        (twf.SYNCS, twf.LIVE_BOUNCES, twf.SKIPPED), before))
    assert live + skipped == 4 and live >= 1
    assert syncs == (live - 1) + (skipped > 0)


def test_render_film_routes_to_the_wavefront(tmp_path):
    _, (cam, scene) = scene_pair("corner", (8, 8))
    film = tpt.render_film(cam, scene, 2, 3, seed=9, backend="wavefront")
    assert torch.equal(film.data, twf.render_wavefront(cam, scene, 2, 3,
                                                       seed=9))
    with pytest.raises(ValueError, match="does not support checkpointing"):
        tpt.render_film(cam, scene, 2, 3, backend="wavefront",
                        checkpoint=str(tmp_path / "ckpt"))


def test_auto_rules(monkeypatch):
    """The wavefront's own "auto": brute up to 512 padded triangles, above
    that "cluster" on a CUDA scene and "bvh" on a CPU scene; render_film's
    "auto" never picks the wavefront."""
    small_cam, small = tpt.corner_scene(res=(8, 8), device="cpu")
    big = tpt.meshes.mesh_garden(grid=1, device="cpu")[1].build(
        device="cpu")
    assert small.padded_size <= 512 < big.padded_size
    picked = []

    class Picked(Exception):
        pass

    def record(scene, backend, accel):
        picked.append(backend)
        raise Picked

    monkeypatch.setattr(twf, "_make_intersect", record)
    for scene in (small, big):
        assert _auto_backend(small_cam, scene) != "wavefront"
        with pytest.raises(Picked):
            twf.render_wavefront(small_cam, scene, 1, 1)
    monkeypatch.setattr(Scene, "device", property(
        lambda self: torch.device("cuda", 0)))
    with pytest.raises(Picked):
        twf.render_wavefront(small_cam, big, 1, 1)
    assert picked == ["brute", "bvh", "cluster"]
    with pytest.raises(ValueError, match="not in"):
        twf.render_wavefront(small_cam, small, 1, 1, backend="pallas")
