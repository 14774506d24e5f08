"""pathtracer_tpu_torch L1/L2 math against pathtracer_tpu: RNG states bit
for bit, vector math and BRDF samplers at atol 1e-6, on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import linalg as jlinalg
from pathtracer_tpu import materials as jmat
from pathtracer_tpu import rng as jrng
from pathtracer_tpu_torch import linalg as tlinalg
from pathtracer_tpu_torch import materials as tmat
from pathtracer_tpu_torch import rng as trng

from _torch_parity import as_np


def _states(seed, n=65536):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)


def test_hash_u32_bit_exact():
    s = _states(0)
    want = np.asarray(jrng.hash_u32(jnp.asarray(s.astype(np.uint32))))
    got = trng.hash_u32(torch.from_numpy(s.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(as_np(got), want.astype(np.int64))


def test_hash_u32_edge_states():
    s = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64)
    want = np.asarray(jrng.hash_u32(jnp.asarray(s.astype(np.uint32))))
    got = trng.hash_u32(torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(as_np(got), want.astype(np.int64))


def test_rand01_bit_exact():
    s = _states(1)
    js, ju = jrng.rand01(jnp.asarray(s.astype(np.uint32)))
    ts, tu = trng.rand01(torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(as_np(ts), np.asarray(js).astype(np.int64))
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(as_np(tu), np.asarray(ju))
    assert float(tu.min()) >= 0.0 and float(tu.max()) < 1.0


def test_randn01_bit_exact():
    s = _states(2, 1024)
    js, ju = jrng.randn01(jnp.asarray(s.astype(np.uint32)), 5)
    ts, tu = trng.randn01(torch.from_numpy(s.astype(np.int64)), 5)
    assert tuple(tu.shape) == (5, 1024)
    np.testing.assert_array_equal(as_np(ts), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(as_np(tu), np.asarray(ju))


@pytest.mark.parametrize("res_y,base_seed", [(16, 1), (1024, 7),
                                              (4097, 123456789)])
def test_sample_seed_bit_exact(res_y, base_seed):
    rng = np.random.default_rng(res_y)
    w = rng.integers(0, 4096, (64, 1)).astype(np.int32)
    h = rng.integers(0, res_y, (1, 32)).astype(np.int32)
    sidx = rng.integers(0, 2**31 - 1, (8, 1, 1)).astype(np.int32)
    want = np.asarray(jrng.sample_seed(jnp.asarray(w), jnp.asarray(h), res_y,
                                       jnp.asarray(sidx), base_seed))
    got = trng.sample_seed(torch.from_numpy(w), torch.from_numpy(h), res_y,
                           torch.from_numpy(sidx), base_seed)
    np.testing.assert_array_equal(as_np(got), want.astype(np.int64))


@pytest.mark.parametrize("frame", [None, 3, 1000])
def test_pixel_seed_bit_exact(frame):
    w = np.arange(0, 1024, 7, dtype=np.int32)[:, None]
    h = np.arange(0, 768, 5, dtype=np.int32)[None, :]
    want = np.asarray(jrng.pixel_seed(jnp.asarray(w), jnp.asarray(h), 768,
                                      frame))
    got = trng.pixel_seed(torch.from_numpy(w), torch.from_numpy(h), 768,
                          frame)
    np.testing.assert_array_equal(as_np(got), want.astype(np.int64))


def test_lcg_sequence_matches():
    a, b = jrng.Lcg(5), trng.Lcg(5)
    assert [a.next_u32() for _ in range(100)] == [b.next_u32()
                                                  for _ in range(100)]
    assert [a.rand01() for _ in range(100)] == [b.rand01()
                                                for _ in range(100)]
    a.seed(9)
    b.seed(9)
    assert a.next_u32() == b.next_u32()


def test_linalg_matches():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(257, 3)).astype(np.float32)
    b = rng.normal(size=(257, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for jf, tf in ((jlinalg.dot, tlinalg.dot), (jlinalg.cross, tlinalg.cross)):
        np.testing.assert_allclose(as_np(tf(ta, tb)),
                                   np.asarray(jf(jnp.asarray(a),
                                                 jnp.asarray(b))),
                                   atol=1e-6)
    np.testing.assert_allclose(as_np(tlinalg.normalize(ta)),
                               np.asarray(jlinalg.normalize(jnp.asarray(a))),
                               atol=1e-6)
    assert (tlinalg.EPS, tlinalg.FLOAT_INF, tlinalg.SHIFT_BIAS,
            tlinalg.DEG2RAD) == (jlinalg.EPS, jlinalg.FLOAT_INF,
                                 jlinalg.SHIFT_BIAS, jlinalg.DEG2RAD)


def _normals(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_hemisphere_sample_matches():
    rng = np.random.default_rng(4)
    u = rng.random(4096, dtype=np.float32)
    v = rng.random(4096, dtype=np.float32)
    n = _normals(rng, 4096)
    want = np.asarray(jmat.hemisphere_sample(jnp.asarray(u), jnp.asarray(v),
                                             jnp.asarray(n)))
    got = tmat.hemisphere_sample(torch.from_numpy(u), torch.from_numpy(v),
                                 torch.from_numpy(n))
    np.testing.assert_allclose(as_np(got), want, atol=1e-6)
    assert np.all(np.sum(as_np(got) * n, -1) >= -1e-6)


@pytest.mark.parametrize("rough_shape", ["flat", "keepdims"])
def test_specular_sample_matches(rough_shape):
    rng = np.random.default_rng(5)
    d = _normals(rng, 2048)
    n = _normals(rng, 2048)
    n = np.where(np.sum(n * d, -1, keepdims=True) < 0, n, -n)
    rough = rng.random(2048, dtype=np.float32)
    if rough_shape == "keepdims":
        rough = rough[:, None]
    cube = rng.random((tmat.SPECULAR_TRIES, 2048, 3), dtype=np.float32)
    want = np.asarray(jmat.specular_sample(jnp.asarray(d), jnp.asarray(n),
                                           jnp.asarray(rough),
                                           jnp.asarray(cube)))
    got = tmat.specular_sample(torch.from_numpy(d), torch.from_numpy(n),
                               torch.from_numpy(rough),
                               torch.from_numpy(cube))
    np.testing.assert_allclose(as_np(got), want, atol=1e-6)


@pytest.mark.parametrize("has_specular", [False, True])
def test_draw_bounce_uniforms_bit_exact(has_specular):
    s = _states(6, 512).reshape(16, 32)
    js, (ju, jv, jc) = jmat.draw_bounce_uniforms(
        jnp.asarray(s.astype(np.uint32)), has_specular)
    ts, (tu, tv, tc) = tmat.draw_bounce_uniforms(
        torch.from_numpy(s.astype(np.int64)), has_specular)
    np.testing.assert_array_equal(as_np(ts), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(as_np(tu), np.asarray(ju))
    np.testing.assert_array_equal(as_np(tv), np.asarray(jv))
    if has_specular:
        assert tuple(tc.shape) == (tmat.SPECULAR_TRIES, 16, 32, 3)
        np.testing.assert_array_equal(as_np(tc), np.asarray(jc))
    else:
        assert tc is None and jc is None


def test_sample_direction_matches():
    rng = np.random.default_rng(7)
    n_rays = 1024
    mtype = rng.choice([tmat.DIFFUSE, tmat.SPECULAR, tmat.EMIT],
                       n_rays).astype(np.int32)
    d = _normals(rng, n_rays)
    n = _normals(rng, n_rays)
    n = np.where(np.sum(n * d, -1, keepdims=True) < 0, n, -n)
    rough = rng.random(n_rays, dtype=np.float32)
    u = rng.random(n_rays, dtype=np.float32)
    v = rng.random(n_rays, dtype=np.float32)
    cube = rng.random((tmat.SPECULAR_TRIES, n_rays, 3), dtype=np.float32)
    args = (mtype, rough, d, n, u, v, cube)
    want = np.asarray(jmat.sample_direction(*map(jnp.asarray, args)))
    got = tmat.sample_direction(*map(torch.from_numpy, args))
    np.testing.assert_allclose(as_np(got), want, atol=1e-6)
