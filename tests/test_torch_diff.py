"""pathtracer_tpu_torch.diff against pathtracer_tpu.diff on the CPU.

Same scene, camera, seed and sample window in both packages
(_torch_parity.scene_pair); the JAX side runs as tests/test_diff.py runs
it, and the port takes the plain version of every kernel (the plain
cluster version is held against the JAX cluster kernel in
test_torch_clusters.py).

Tolerances: films as every parity test here, atol 2e-4 on all but 1% of
the pixels (_torch_parity.assert_films_close: a one-ulp difference
between XLA's and PyTorch's CPU float32 can flip a near-tie hit).
Gradients: relative L2 error <= 1e-3 per array, where both packages sum
the same per-ray terms in another order (a one-hot matmul in each), after
the rows of identical materials are summed: a near-tie hit that flips
between two triangles of one material leaves the film unchanged and moves
one path's share of the gradient from one row to the other (measured on
the specular scene at 8^2, 4 spp: the ceiling's and the front wall's
emission rows, +-3.07e-3 each, where the array's norm is ~0.1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu import diff as jdiff
from pathtracer_tpu_torch import diff as tdiff
from pathtracer_tpu_torch.ops.cuda import cluster_kernel as tck

from _torch_parity import as_np, assert_films_close, carry, scene_pair

GRAD_RTOL = 1e-3
PARAMS = ("albedo", "emit", "roughness")
CASES = {"corner": ("corner", 4), "specular": ("specular", 4)}


def _params(jscene):
    """The scene's materials as numpy, for both packages."""
    return {k: np.asarray(v) for k, v in jdiff.material_params(jscene).items()}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _by_material(grad, scene):
    """``grad`` (T, ...) summed over the rows of identical materials."""
    mats = np.concatenate([np.asarray(a, np.float64).reshape(
        scene.padded_size, -1) for a in (scene.mat_type, scene.albedo,
                                         scene.emit, scene.roughness)], 1)
    _, group = np.unique(mats, axis=0, return_inverse=True)
    out = np.zeros((group.max() + 1,) + grad.shape[1:])
    np.add.at(out, group.ravel(), np.asarray(grad, np.float64))
    return out


def _torch_grad(loss, params):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    value = loss(leaves)
    grads = torch.autograd.grad(value, [leaves[k] for k in PARAMS])
    return float(value.detach()), {k: as_np(g) for k, g in zip(PARAMS, grads)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_film_matches_jax(case):
    name, spp = CASES[case]
    (jcam, jscene), (cam, scene) = scene_pair(name, (8, 8))
    p = _params(jscene)
    want = jdiff.render_film_diff(jcam, jscene, {k: jnp.asarray(v) for k, v in
                                                 p.items()}, spp, 3)
    got = tdiff.render_film_diff(
        cam, scene, tpt.material_params_from_arrays(p, device="cpu"), spp, 3)
    assert_films_close(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_matches_jax(case):
    """d loss / d (albedo, emit, roughness) of make_loss, the JAX one by
    jax.grad, the port's by autograd, from the same parameters carried by
    convert.material_params_from_arrays; every entry finite, padding rows
    included."""
    name, spp = CASES[case]
    (jcam, jscene), (cam, scene) = scene_pair(name, (8, 8))
    target = np.full((8, 8, 3), 0.3, np.float32)
    p = _params(jscene)
    jloss = jdiff.make_loss(jcam, jscene, jnp.asarray(target), spp, 3)
    jval, jg = jax.value_and_grad(jloss)({k: jnp.asarray(v)
                                          for k, v in p.items()})
    tval, tg = _torch_grad(tdiff.make_loss(cam, scene, target, spp, 3),
                           tpt.material_params_from_arrays(p, device="cpu"))
    np.testing.assert_allclose(tval, float(jval), rtol=1e-5)
    for k in PARAMS:
        assert tg[k].shape == p[k].shape and np.all(np.isfinite(tg[k])), k
        got, want = _by_material(tg[k], jscene), _by_material(jg[k], jscene)
        if np.any(want):
            assert _rel_l2(got, want) <= GRAD_RTOL, (k, _rel_l2(got, want))
        else:
            assert not np.any(got), k


def test_gradcheck_albedo_emit():
    """Central differences on the corner scene (tests/test_diff.py)."""
    cam, scene = tpt.corner_scene(res=(8, 8), device="cpu")
    loss = tdiff.make_loss(cam, scene, torch.zeros(8, 8, 3), samples=4,
                           depth=3)
    idx = [("albedo", 0), ("albedo", 1), ("albedo", 4),
           ("emit", 6), ("emit", 7), ("emit", 8)]
    _, max_rel = tdiff.gradcheck(loss, tdiff.material_params(scene),
                                 eps=1e-3, indices=idx)
    assert max_rel < 5e-2


def test_gradcheck_roughness_one_sided():
    """A specular floor under an emitter 'sky' (tests/test_diff.py): the
    loss is smooth in roughness away from the sampler's accept/reject
    flips, so the clean side of the stencil measures the estimator's
    slope."""
    sb = tpt.SceneBuilder()
    sb.add_triangle((-1e5, 0, -1e5), (1e5, 0, -1e5), (0, 0, 2e5),
                    tpt.Specular(0.4))
    sb.add_triangle((-1e5, 30, -1e5), (1e5, 30, -1e5), (0, 30, 2e5),
                    tpt.HostMaterial(tpt.EMIT, emit=(2, 2, 2)))
    scene = sb.build(device="cpu")
    cam = tpt.make_camera((0, 10, -40), (0, -0.3, 1), (0, 1, 0), (8, 8),
                          60 * tpt.DEG2RAD, 1.0, device="cpu")
    params = tdiff.material_params(scene)
    loss = tdiff.make_loss(cam, scene, torch.zeros(8, 8, 3), samples=8,
                           depth=3)
    _, g = _torch_grad(loss, params)
    assert np.all(np.isfinite(g["roughness"]))
    assert np.abs(g["albedo"][0]).sum() > 0
    _, max_rel = tdiff.gradcheck(loss, params, eps=2e-3,
                                 indices=[("roughness", 0)],
                                 mode="one_sided")
    assert max_rel < 0.1


def test_emit_gradient_points_to_a_brighter_target():
    cam, scene = tpt.corner_scene(res=(8, 8), device="cpu")
    loss = tdiff.make_loss(cam, scene, torch.ones(8, 8, 3), 4, 3)
    _, g = _torch_grad(loss, tdiff.material_params(scene))
    assert g["emit"][2].sum() < 0


def test_sample_windows_average_to_their_union():
    """Two disjoint 4-sample windows average to the 8-sample film of their
    union (the per-(pixel, sample) streams do not depend on the window)."""
    cam, scene = tpt.corner_scene(res=(8, 8), device="cpu")
    p = tdiff.material_params(scene)
    a = tdiff.render_film_diff(cam, scene, p, 4, 3, sample_offset=0)
    b = tdiff.render_film_diff(cam, scene, p, 4, 3, sample_offset=4)
    both = tdiff.render_film_diff(cam, scene, p, 8, 3)
    assert not torch.equal(a, b)
    torch.testing.assert_close(0.5 * (a + b), both, rtol=0, atol=1e-6)


def _mesh_scene_pair():
    """The >1k-triangle scene of tests/test_diff.py: a uv sphere under an
    emissive ceiling, 8^2."""
    from pathtracer_tpu import meshes

    sb = jpt.SceneBuilder()
    meshes.uv_sphere((0, 0, 0), 1.0, 24, 48, jpt.Diffuse(0.8, 0.4, 0.2),
                     builder=sb)
    sb.add_quad(((-5, 4, -5), (5, 4, -5), (5, 4, 5), (-5, 4, 5)),
                jpt.Emit(2))
    jscene = sb.build()
    jcam = jpt.make_camera((0, 1.2, -4), (0, -0.2, 1), (0, 1, 0), (8, 8),
                           60 * jpt.DEG2RAD, 1.0)
    return (jcam, jscene), carry(jcam, jscene)


def test_backends_agree_with_brute():
    """"bvh" (and its alias "bvh-gather") and "cluster" (the plain version
    here) give the brute backend's film and gradients: the same hits, so
    the same radiance, up to the order of the gradients' sums."""
    _, (cam, scene) = _mesh_scene_pair()
    target = torch.zeros(8, 8, 3)
    films, grads = {}, {}
    for backend in ("brute", "bvh", "bvh-gather", "cluster"):
        params = tdiff.material_params(scene)
        films[backend] = tdiff.render_film_diff(cam, scene, params, 2, 3,
                                                backend=backend)
        _, grads[backend] = _torch_grad(
            tdiff.make_loss(cam, scene, target, 2, 3, backend=backend),
            params)
    assert float(films["brute"].mean()) > 0.01
    for backend in ("bvh", "bvh-gather", "cluster"):
        torch.testing.assert_close(films[backend], films["brute"],
                                   rtol=1e-4, atol=1e-5)
        for k in PARAMS:
            assert np.all(np.isfinite(grads[backend][k]))
            assert _rel_l2(grads[backend][k], grads["brute"][k]) <= GRAD_RTOL
    assert np.abs(grads["cluster"]["albedo"]).sum() > 0


def test_unknown_backend_raises():
    cam, scene = tpt.corner_scene(res=(4, 4), device="cpu")
    with pytest.raises(ValueError, match="unknown diff backend"):
        tdiff.render_film_diff(cam, scene, tdiff.material_params(scene), 1,
                               1, backend="beam")


def test_intersectors_get_detached_rays(monkeypatch):
    """No backend's intersector sees a ray that autograd records (the
    rays depend on roughness through the specular sample)."""
    _, (cam, scene) = scene_pair("specular", (4, 4))
    seen = []

    def spy(o, d, *args, **kw):
        seen.append(o.requires_grad or d.requires_grad)
        return real(o, d, *args, **kw)

    params = {k: v.clone().requires_grad_(True)
              for k, v in tdiff.material_params(scene).items()}
    for module, name in ((tdiff, "intersect_brute"),
                         (tck, "intersect_clusters")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, spy)
        backend = "brute" if module is tdiff else "cluster"
        film = tdiff.render_film_diff(cam, scene, params, 2, 3,
                                      backend=backend)
        assert film.requires_grad
        monkeypatch.setattr(module, name, real)
    assert seen and not any(seen)


def test_replace_materials_drops_the_host_material_cache():
    """A scene with swapped materials keeps the host vertex cache and
    reads its materials from its own tensors, so the packers and the byte
    fingerprint see the new materials."""
    _, scene = tpt.cornell_box(res=(8, 8), device="cpu")
    alb = scene.albedo * 0.5
    new = scene.replace_materials(albedo=alb)
    assert new._host_v is scene._host_v and not hasattr(new, "_host_m")
    np.testing.assert_array_equal(new.host_materials()[1],
                                  as_np(alb)[:scene.num_tris])
    assert new.fingerprint() != scene.fingerprint()
    assert scene.replace_materials().fingerprint() == scene.fingerprint()


def test_cluster_set_is_cached_across_renders(monkeypatch):
    """A second render_film(backend="cluster") of the same scene builds no
    cluster set, nor does diff.make_accel; an edited scene misses the
    cache; a new scene object with the same bytes hits it."""
    builds = []
    real = tck.build_clusters
    monkeypatch.setattr(tck, "build_clusters",
                        lambda s: builds.append(s) or real(s))
    monkeypatch.setattr(tck, "_CLUSTER_CACHE", [])
    (jcam, jscene), (cam, scene) = scene_pair("cornell", (8, 8))
    first = tpt.render_film(cam, scene, 2, 2, backend="cluster")
    again = tpt.render_film(cam, scene, 2, 2, backend="cluster")
    assert len(builds) == 1 and torch.equal(first.data, again.data)
    assert tdiff.make_accel(scene, "cluster") is tck.clusters_for(scene)
    _, copy = carry(jcam, jscene)
    tpt.render_film(cam, copy, 2, 2, backend="cluster")
    assert len(builds) == 1
    v1 = as_np(scene.v1).copy()
    v1[0, 0] += 1.0
    edited = tpt.scene_from_arrays(
        v1, *(as_np(getattr(scene, f)) for f in
              ("v2", "v3", "mat_type", "albedo", "emit", "roughness")),
        scene.num_tris, device="cpu")
    tpt.render_film(cam, edited, 2, 2, backend="cluster")
    assert len(builds) == 2
