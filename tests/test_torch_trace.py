"""pathtracer_tpu_torch ops (shade table, gather, brute intersection, bounce
loop) against pathtracer_tpu on the same scene, rays and RNG states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jisect
from pathtracer_tpu.ops import trace as jtrace
from pathtracer_tpu_torch.ops import intersect as tisect
from pathtracer_tpu_torch.ops import trace as ttrace

from _torch_parity import as_np, assert_films_close, scene_pair


def _rays_into_box(rng, n):
    """Rays from inside the Cornell box in random directions."""
    o = rng.uniform([20, 20, 20], [530, 530, 540], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("name", ["corner", "cornell", "specular"])
def test_shade_table_equal(name):
    (_, jscene), (_, tscene) = scene_pair(name, (8, 8))
    want = np.asarray(jtrace.shade_table(jscene))
    got = as_np(ttrace.shade_table(tscene))
    assert got.shape == (tscene.padded_size, ttrace.TABLE_COLS)
    np.testing.assert_array_equal(got[:, :7], want[:, :7])
    np.testing.assert_array_equal(got[:, 10:], want[:, 10:])
    # Unit normals: XLA's fused cross/normalise rounds some components one
    # ulp away from PyTorch's unfused ops (measured: 10 of 96 components of
    # the Cornell box, all by 1.19e-7).
    np.testing.assert_allclose(got[:, 7:10], want[:, 7:10], rtol=0,
                               atol=1.2e-7)


def test_gather_features_matches_one_hot():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(40, 12)).astype(np.float32)
    tid = rng.integers(-1, 40, (7, 9)).astype(np.int32)
    want = np.asarray(jtrace.gather_features(jnp.asarray(table),
                                             jnp.asarray(tid)))
    got = as_np(ttrace.gather_features(torch.from_numpy(table),
                                       torch.from_numpy(tid)))
    np.testing.assert_array_equal(got, want)
    assert np.all(got[tid < 0] == 0)


@pytest.mark.parametrize("name", ["cornell", "specular"])
def test_intersect_brute_matches(name):
    (_, jscene), (_, tscene) = scene_pair(name, (8, 8))
    rng = np.random.default_rng(1)
    o, d = _rays_into_box(rng, 4096)
    jt, jtid = jisect.intersect_brute(jnp.asarray(o), jnp.asarray(d),
                                      jscene.v1, jscene.v2, jscene.v3)
    tt, ttid = tisect.intersect_brute(torch.from_numpy(o),
                                      torch.from_numpy(d), tscene.v1,
                                      tscene.v2, tscene.v3)
    jt, jtid, tt, ttid = map(as_np, (jt, jtid, tt, ttid))
    assert ttid.dtype == np.int32
    assert np.mean(ttid >= 0) > 0.5  # rays from inside the box mostly hit

    # Near-ties: rays whose best and second-best candidate t are within a
    # relative 1e-5 may pick either triangle in either package.
    tris = [np.asarray(getattr(jscene, f)) for f in ("v1", "v2", "v3")]
    all_t = _all_candidate_t(o, d, *tris)
    srt = np.sort(all_t, axis=-1)
    with np.errstate(invalid="ignore"):  # inf - inf for misses: not a tie
        tie = (srt[:, 1] - srt[:, 0]) <= 1e-5 * np.abs(srt[:, 0])
    np.testing.assert_array_equal(ttid[~tie], jtid[~tie])
    np.testing.assert_allclose(tt, jt, rtol=1e-6)


def _all_candidate_t(o, d, v1, v2, v3):
    """Float64 Möller–Trumbore t of every ray against every triangle."""
    o, d = o[:, None].astype(np.float64), d[:, None].astype(np.float64)
    e1, e2 = (v2 - v1).astype(np.float64), (v3 - v1).astype(np.float64)
    h = np.cross(d, e2)
    a = np.sum(e1 * h, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = 1.0 / a
        s = o - v1
        u = f * np.sum(s * h, -1)
        q = np.cross(s, e1)
        v = f * np.sum(d * q, -1)
        t = f * np.sum(e2 * q, -1)
    ok = ((np.abs(a) >= 1e-6) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t > 0))
    return np.where(ok, t, np.inf)


def test_intersect_brute_misses_and_padding():
    (_, jscene), (_, tscene) = scene_pair("corner", (8, 8))
    o = np.array([[5, 5, 5], [0.2, 0.2, 2.0]], np.float32)
    d = np.array([[1, 0, 0], [0, 0, -1]], np.float32)
    t, tid = tisect.intersect_brute(torch.from_numpy(o), torch.from_numpy(d),
                                    tscene.v1, tscene.v2, tscene.v3)
    assert int(tid[0]) == -1 and float(t[0]) == pytest.approx(1e30)
    assert int(tid[1]) == 0 and float(t[1]) == pytest.approx(2.0)


@pytest.mark.parametrize("name,has_specular", [("cornell", False),
                                               ("specular", True)])
def test_trace_rays_matches(name, has_specular):
    (_, jscene), (_, tscene) = scene_pair(name, (8, 8))
    rng = np.random.default_rng(2)
    o, d = _rays_into_box(rng, 1024)
    states = rng.integers(0, 2**32, 1024, dtype=np.uint64)
    jtable = jtrace.shade_table(jscene)
    ttable = ttrace.shade_table(tscene)

    def jint(ro, rd):
        return jisect.intersect_brute(ro, rd, jscene.v1, jscene.v2, jscene.v3)

    def tint(ro, rd):
        return tisect.intersect_brute(ro, rd, tscene.v1, tscene.v2,
                                      tscene.v3)

    want = jtrace.trace_rays(jtable, jint, jnp.asarray(o), jnp.asarray(d), 4,
                             jnp.asarray(states.astype(np.uint32)),
                             has_specular=has_specular)
    got = ttrace.trace_rays(ttable, tint, torch.from_numpy(o),
                            torch.from_numpy(d), 4,
                            torch.from_numpy(states.astype(np.int64)),
                            has_specular=has_specular)
    assert tuple(got.shape) == (1024, 3)
    assert float(got.sum()) > 0.0
    assert_films_close(got[:, None], np.asarray(want)[:, None])
