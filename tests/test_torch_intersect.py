"""pathtracer_tpu_torch's intersection primitives against pathtracer_tpu and
a scalar Möller–Trumbore on the CPU: the counterpart of
tests/test_intersect.py for the leaf test, the slab test, the padding rows
and the Cornell box's rays (tests/test_torch_bvh.py holds the BVH and
cluster traversals)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pathtracer_tpu as jpt
from pathtracer_tpu.ops import intersect as jisect

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.linalg import EPS, FLOAT_INF
from pathtracer_tpu_torch.ops import intersect as tisect

from _torch_parity import as_np


def scalar_moller_trumbore(o, d, v1, v2, v3):
    """The reference's triangle test (triangle.h:25-44) in float64:
    (t, the smallest distance of a, u, v, 1 - u - v and t to the test's
    edges), t None on a miss."""
    e1, e2 = v2 - v1, v3 - v1
    h = np.cross(d, e2)
    a = np.dot(e1, h)
    if abs(a) < EPS:
        return None, abs(abs(a) - EPS)
    f = 1.0 / a
    s = o - v1
    u = f * np.dot(s, h)
    q = np.cross(s, e1)
    v = f * np.dot(d, q)
    t = f * np.dot(e2, q)
    margin = min(abs(abs(a) - EPS), abs(u), abs(1 - u), abs(v),
                 abs(1 - u - v), abs(t))
    if u < 0 or u > 1 or v < 0 or u + v > 1 or t <= 0:
        return None, margin
    return t, margin


def _random_rays(rng, n, lo=-8, hi=8):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_intersect_one_triangle_matches_jax_and_scalar(seed):
    """Rays aimed near their own triangle's centroid: both packages return
    the same hits as the scalar test (away from its edges) and the same t
    within float32 rounding; misses at FLOAT_INF."""
    rng = np.random.default_rng(seed)
    n = 512
    v = rng.normal(size=(3, n, 3)).astype(np.float32) * 2.0
    o, _ = _random_rays(rng, n)
    aim = v.mean(axis=0) + rng.normal(size=(n, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    t, valid = tisect.intersect_one_triangle(*(torch.from_numpy(x)
                                               for x in (o, d, *v)))
    jt, jvalid = jisect.intersect_one_triangle(*(jnp.asarray(x)
                                                 for x in (o, d, *v)))
    t, valid = as_np(t), as_np(valid)
    jt, jvalid = np.asarray(jt), np.asarray(jvalid)
    assert 0.1 < valid.mean() < 0.9
    hit = np.zeros(n, bool)
    for r in range(n):
        st, margin = scalar_moller_trumbore(*(x[r].astype(np.float64)
                                              for x in (o, d, *v)))
        hit[r] = st is not None
        if margin > 1e-4:
            assert valid[r] == jvalid[r] == hit[r], r
            if hit[r]:
                np.testing.assert_allclose(t[r], st, rtol=1e-4)
    both = valid & jvalid
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-5)
    assert np.all(t[~valid] == FLOAT_INF)


def _random_scene(rng, n_tris):
    """Random triangles (centres in [-5, 5]^3), built by both packages."""
    tris = []
    for _ in range(n_tris):
        base = rng.uniform(-5, 5, 3)
        tris.append((base, base + rng.normal(0, 1, 3),
                     base + rng.normal(0, 1, 3)))
    scenes = []
    for pkg, kw in ((jpt, {}), (tpt, {"device": "cpu"})):
        sb = pkg.SceneBuilder()
        for tri in tris:
            sb.add_triangle(*(tuple(map(float, x)) for x in tri),
                            pkg.Diffuse(1))
        scenes.append(sb.build(**kw))
    return scenes


def test_brute_matches_scalar_oracle():
    """The nearest hit of each ray over 33 triangles: the scalar test's
    triangle and its t within 1e-4."""
    rng = np.random.default_rng(3)
    _, scene = _random_scene(rng, 33)
    o, _ = _random_rays(rng, 64)
    # Aimed near the triangles' first vertices, so that most rays hit.
    aim = (as_np(scene.v1)[rng.integers(0, 33, 64)]
           + rng.normal(0, 0.5, (64, 3)).astype(np.float32))
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    t, tid = tisect.intersect_brute(torch.from_numpy(o), torch.from_numpy(d),
                                    scene.v1, scene.v2, scene.v3)
    t, tid = as_np(t), as_np(tid)
    verts = [as_np(x)[:33].astype(np.float64)
             for x in (scene.v1, scene.v2, scene.v3)]
    assert (tid >= 0).sum() > 16
    for r in range(64):
        best_t, best = FLOAT_INF, -1
        for i in range(33):
            st, _ = scalar_moller_trumbore(o[r].astype(np.float64),
                                           d[r].astype(np.float64),
                                           *(x[i] for x in verts))
            if st is not None and st < best_t:
                best_t, best = st, i
        assert tid[r] == best, r
        if best >= 0:
            np.testing.assert_allclose(t[r], best_t, rtol=1e-4)


@pytest.mark.parametrize("n_tris", [1, 5, 7, 9])
def test_padding_triangles_never_hit(n_tris):
    """Both packages pad the rows alike, and no ray hits a padding row."""
    rng = np.random.default_rng(n_tris)
    jscene, scene = _random_scene(rng, n_tris)
    assert scene.padded_size == jscene.padded_size > n_tris
    assert scene.v1.shape[0] == scene.padded_size
    o, d = _random_rays(rng, 256)
    _, tid = tisect.intersect_brute(torch.from_numpy(o), torch.from_numpy(d),
                                    scene.v1, scene.v2, scene.v3)
    _, jtid = jisect.intersect_brute(jnp.asarray(o), jnp.asarray(d),
                                     jscene.v1, jscene.v2, jscene.v3)
    assert np.all(as_np(tid) < n_tris)
    np.testing.assert_array_equal(as_np(tid), np.asarray(jtid))


@pytest.mark.parametrize("slope,tris,t", [
    # Through the tall box's front face (its fifth quad) before the back
    # wall.
    (0.0, (30, 31), 791.968),
    # Above the tall box (it clears y = 330) and under the ceiling at the
    # back: the back wall.
    (0.2, (6, 7), None),
])
def test_cornell_rays_match_jax(slope, tris, t):
    cam, scene = tpt.cornell_box(res=(4, 4), device="cpu")
    jcam, jscene = jpt.cornell_box(res=(4, 4))
    assert scene.num_tris == jscene.num_tris == 32
    o = np.array([[278.0, 278.0, -500.0]], np.float32)
    d = np.array([[0.0, slope, 1.0]], np.float32) / np.sqrt(1 + slope ** 2)
    got_t, got = tisect.intersect_brute(
        torch.from_numpy(o), torch.from_numpy(d), scene.v1, scene.v2,
        scene.v3)
    want_t, want = jisect.intersect_brute(
        jnp.asarray(o), jnp.asarray(d), jscene.v1, jscene.v2, jscene.v3)
    assert int(got[0]) == int(want[0]) and int(got[0]) in tris
    np.testing.assert_allclose(float(got_t[0]), float(want_t[0]), rtol=1e-6)
    if t is not None:
        np.testing.assert_allclose(float(got_t[0]), t, rtol=1e-4)


@pytest.mark.parametrize("origin,direction,hit", [
    ((-1.0, 0.5, 0.5), (1.0, 1e-9, 1e-9), True),     # in front
    ((2.0, 0.5, 0.5), (1.0, 1e-9, 1e-9), False),     # behind the origin
    ((0.5, 0.5, 0.5), (0.3, -0.2, 0.9), True),       # from inside
    ((-1.0, 1.5, 0.5), (1.0, 1e-9, 1e-9), False),    # beside a slab
    ((-1.0, -1.0, 0.5), (1.0, 1.0, 1e-9), True),     # through an edge
])
def test_aabb_hit_matches_jax(origin, direction, hit):
    """The reference's slab test (aabb.h:20-29): a hit iff tmin <= tmax
    and tmax >= 0."""
    o = np.array([origin], np.float32)
    inv = 1.0 / np.array([direction], np.float32)
    lb = np.zeros((1, 3), np.float32)
    rt = np.ones((1, 3), np.float32)
    got = tisect.aabb_hit(*(torch.from_numpy(x) for x in (o, inv, lb, rt)))
    want = jisect.aabb_hit(*(jnp.asarray(x) for x in (o, inv, lb, rt)))
    assert bool(got[0]) == bool(want[0]) == hit
