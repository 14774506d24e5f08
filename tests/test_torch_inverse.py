"""pathtracer_tpu_torch.inverse against pathtracer_tpu.inverse on the CPU,
and the port's own recovery bars and train checkpoints.

Trajectory parity: the same scene, target, start and sample windows in
both packages; Adam's update is optax's formula, rounded in another order,
so 5 steps agree to rtol 1e-4 in the loss and atol 1e-5 in the
parameters (measured: 1.6e-6 and 7.7e-7).  SPSA draws its signs from
another generator than JAX's, so the roughness cases are held to recovery
bars, scaled down from tests/test_inverse.py, and not to JAX's steps.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu import diff as jdiff
from pathtracer_tpu import inverse as jinv
from pathtracer_tpu_torch import diff as tdiff
from pathtracer_tpu_torch import inverse as tinv
from pathtracer_tpu_torch.utils import checkpoint as tckpt

from _torch_parity import as_np, scene_pair

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5


def _target(cam, scene, spp, depth, offset):
    """A film of the scene's own materials, from far-away samples."""
    return tdiff.render_film_diff(cam, scene, tdiff.material_params(scene),
                                  spp, depth, sample_offset=offset)


@pytest.mark.parametrize("name", ["corner", "specular"])
def test_transforms_and_start_match_jax(name):
    (_, jscene), (_, scene) = scene_pair(name, (4, 4))
    mats = jdiff.material_params(jscene)
    want = jinv.to_unconstrained(mats)
    got = tinv.to_unconstrained(tdiff.material_params(scene))
    for k in want:
        np.testing.assert_allclose(as_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
    back = tinv.to_materials(got)
    np.testing.assert_allclose(as_np(back["emit"]), np.asarray(mats["emit"]),
                               atol=1e-4)
    np.testing.assert_allclose(
        as_np(back["albedo"]),
        np.clip(np.asarray(mats["albedo"]), 1e-5, 1 - 1e-5), atol=1e-4)
    jstart, start = jinv.init_params(jscene), tinv.init_params(scene)
    for k in jstart:
        np.testing.assert_allclose(as_np(start[k]), np.asarray(jstart[k]),
                                   rtol=1e-6)
    gen = np.random.default_rng(5)
    p = {k: gen.normal(size=np.asarray(v).shape).astype(np.float32) * 3
         for k, v in jstart.items()}
    jm = jinv.to_materials({k: jnp.asarray(v) for k, v in p.items()})
    tm = tinv.to_materials(tpt.material_params_from_arrays(p, device="cpu"))
    for k in jm:
        np.testing.assert_allclose(as_np(tm[k]), np.asarray(jm[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("steps", [1, 7, 50])
def test_cosine_lr_is_optax_schedule(steps):
    sched = optax.cosine_decay_schedule(0.08, steps, alpha=4e-3 / 0.08)
    for k in range(steps + 2):
        assert tinv.cosine_lr(0.08, 4e-3, k, steps) == pytest.approx(
            float(sched(k)), rel=1e-6)
    assert tinv.cosine_lr(0.08, None, 3, steps) == 0.08


@pytest.mark.parametrize("lr_end", [None, 4e-3])
def test_trajectory_matches_jax(lr_end):
    """5 paired-loss steps on the albedos of the corner scene, 16^2:
    the same losses and parameters in both packages."""
    (jcam, jscene), (cam, scene) = scene_pair("corner", (16, 16))
    target = as_np(_target(cam, scene, 16, 2, 900_000))
    kw = dict(steps=5, samples=4, depth=2, lr=8e-2, lr_end=lr_end,
              optimize=("albedo",))
    jm, jl = jinv.recover_materials(jcam, jscene, jnp.asarray(target), **kw)
    tm, tl = tinv.recover_materials(cam, scene, torch.from_numpy(target),
                                    **kw)
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for k in jm:
        np.testing.assert_allclose(as_np(tm[k]), np.asarray(jm[k]),
                                   atol=PARAM_ATOL)
    assert not np.allclose(as_np(tm["albedo"]), 0.5)


def test_recover_albedo_corner():
    """tests/test_inverse.py: known emission, grey albedo start."""
    cam, scene = tpt.corner_scene(res=(16, 16), device="cpu")
    true = tdiff.material_params(scene)
    target = _target(cam, scene, 64, 3, 500_000)
    p0 = tinv.init_params(scene)
    p0["emit"] = tinv.to_unconstrained(true)["emit"]
    mats, losses = tinv.recover_materials(
        cam, scene, target, steps=80, samples=8, depth=3, lr=8e-2,
        params0=p0, optimize=("albedo",))
    assert losses[-1] < losses[0] * 0.8
    got = as_np(mats["albedo"])[:scene.num_tris]
    want = as_np(true["albedo"])[:scene.num_tris]
    assert got[1, 1] > got[1, 0] + 0.2
    assert np.abs(got[:2] - np.clip(want[:2], 0.02, 0.98)).mean() < 0.3


def test_recover_emission():
    """tests/test_inverse.py: known albedo, recover the emitter."""
    cam, scene = tpt.corner_scene(res=(16, 16), device="cpu")
    true = tdiff.material_params(scene)
    target = _target(cam, scene, 64, 3, 500_000)
    p0 = tinv.init_params(scene)
    p0["albedo"] = tinv.to_unconstrained(true)["albedo"]
    mats, _ = tinv.recover_materials(
        cam, scene, target, steps=120, samples=16, depth=3, lr=8e-2,
        lr_end=4e-3, params0=p0, optimize=("emit",))
    np.testing.assert_allclose(as_np(mats["emit"])[2], [1, 1, 1], atol=0.15)


def _glossy_scene(res=16):
    """One large glossy triangle (roughness 0.3) under an emitter, seen
    from above: the emitter's blurred reflection covers a share of the
    pixels that depends on the roughness, so roughness is observable at
    16^2 and depth 2.  (On the specular Cornell box at CPU sizes few paths
    reach the light through a specular bounce, and SPSA sees noise.)"""
    sb = tpt.SceneBuilder()
    sb.add_triangle((-6, 0, -3), (6, 0, -3), (0, 0, 9),
                    tpt.Specular(0.3, 0.8, 0.6, 0.4))
    sb.add_quad(((-0.5, 1.5, 0.5), (0.5, 1.5, 0.5), (0.5, 2.0, 1.5),
                 (-0.5, 2.0, 1.5)), tpt.Emit(4))
    scene = sb.build(device="cpu")
    cam = tpt.make_camera((0, 1.0, -2.5), (0, -0.35, 1), (0, 1, 0),
                          (res, res), 50 * tpt.DEG2RAD, 1.0, device="cpu")
    return cam, scene, _target(cam, scene, 256, 2, 800_000)


def test_recover_joint_reduced_budget():
    """tests/test_inverse.py's joint case at a CPU budget: albedo,
    emission and roughness move together from grey; the paired loss falls
    and the SPSA roughness closes at least half of the 0.2 gap to the
    truth (measured over four seeds: 0.349-0.364 after 40 steps)."""
    cam, scene, target = _glossy_scene()
    mats, losses = tinv.recover_materials(
        cam, scene, target, steps=40, samples=8, depth=2, lr=8e-2,
        optimize=("albedo", "emit", "roughness"))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) * 0.95
    assert abs(float(mats["roughness"][0]) - 0.3) < 0.1


def test_recover_roughness_spsa_moves_toward_the_truth():
    """Roughness alone from the grey 0.5 start, true 0.3 (measured over
    four seeds: 0.334-0.439 after 20 steps); the albedo and the emission
    stay where they started."""
    cam, scene, target = _glossy_scene()
    true = tinv.to_unconstrained(tdiff.material_params(scene))
    p0 = tinv.init_params(scene)
    p0["albedo"], p0["emit"] = true["albedo"], true["emit"]
    mats, _ = tinv.recover_materials(
        cam, scene, target, steps=20, samples=8, depth=2, lr=8e-2,
        params0=p0, optimize=("roughness",))
    assert abs(float(mats["roughness"][0]) - 0.3) < 0.15
    start = tinv.to_materials(p0)
    for k in ("albedo", "emit"):
        assert torch.equal(mats[k], start[k]), k


def test_spsa_signs_depend_on_seed_and_step_only():
    a = tinv.spsa_signs(1, 3, 40)
    assert torch.equal(a, tinv.spsa_signs(1, 3, 40))
    assert set(a.tolist()) == {-1.0, 1.0}
    assert not torch.equal(a, tinv.spsa_signs(1, 4, 40))
    assert not torch.equal(a, tinv.spsa_signs(2, 3, 40))


def test_visible_pixel_counts_match_jax():
    """The primary-hit counts the JAX tests and bench compute (sample 0 of
    seed 1, brute intersection)."""
    import jax
    from pathtracer_tpu import rng as jrng
    from pathtracer_tpu.camera import get_rays
    from pathtracer_tpu.ops import intersect as jisect

    (jcam, jscene), (cam, scene) = scene_pair("cornell", (16, 16))
    w = jax.lax.broadcasted_iota(jnp.int32, (16, 16), 1)
    h = jax.lax.broadcasted_iota(jnp.int32, (16, 16), 0)
    st = jrng.sample_seed(w[None], h[None], 16,
                          jnp.zeros((1, 1, 1), jnp.int32), 1)
    st, u1 = jrng.rand01(st)
    st, u2 = jrng.rand01(st)
    ro, rd = get_rays(jcam, w[None], h[None], u1, u2)
    _, tid = jisect.intersect_brute(ro.reshape(-1, 3), rd.reshape(-1, 3),
                                    jscene.v1, jscene.v2, jscene.v3)
    tid = np.asarray(tid)
    want = np.bincount(tid[tid >= 0], minlength=jscene.num_tris)
    np.testing.assert_array_equal(tinv.visible_pixel_counts(cam, scene), want)


def _joint_run(cam, scene, target, **kw):
    return tinv.recover_materials(
        cam, scene, target, steps=6, samples=4, depth=2, lr=8e-2,
        lr_end=4e-3, optimize=("albedo", "emit", "roughness"), **kw)


def test_train_checkpoint_resume_is_bit_identical(tmp_path, monkeypatch):
    """Abort after 3 of 6 steps, resume: the losses of steps 3-5 and the
    result are bit-identical to the uninterrupted run (parameters, Adam's
    moments and count restored; the learning rate and SPSA signs depend on
    the step only)."""
    cam, scene = tpt.modified_cornell(0.3, res=(8, 8), device="cpu")
    target = _target(cam, scene, 16, 2, 10_000)
    full_mats, full_losses = _joint_run(cam, scene, target)

    path = str(tmp_path / "train.npz")
    real = tckpt.save_train_checkpoint

    def save_then_abort(path, params, opt, step, meta):
        real(path, params, opt, step, meta)
        if step == 3:
            raise KeyboardInterrupt("test abort")

    monkeypatch.setattr(tckpt, "save_train_checkpoint", save_then_abort)
    with pytest.raises(KeyboardInterrupt):
        _joint_run(cam, scene, target, checkpoint=path, checkpoint_every=3)
    monkeypatch.setattr(tckpt, "save_train_checkpoint", real)
    with np.load(path) as z:
        assert int(z["step"]) == 3
        assert sorted(k for k in z if k.startswith("opt:")) == [
            f"opt:{i}" for i in range(8)]
        assert int(z["opt:0"]) == 3
    mats, losses = _joint_run(cam, scene, target, checkpoint=path,
                              checkpoint_every=3)
    np.testing.assert_array_equal(losses, full_losses[3:])
    for k in full_mats:
        assert torch.equal(mats[k], full_mats[k]), k


def test_train_checkpoint_refuses_another_run(tmp_path):
    """Another backend, loss or scene raises; the scene is keyed by its
    bytes, so swapping two walls' albedos (every float sum kept) is
    caught."""
    cam, scene = tpt.cornell_box(res=(8, 8), device="cpu")
    target = _target(cam, scene, 8, 2, 10_000)
    path = str(tmp_path / "t.npz")
    kw = dict(steps=1, samples=2, depth=2, optimize=("albedo",),
              checkpoint=path)
    tinv.recover_materials(cam, scene, target, **kw)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
    assert meta["scene_fingerprint"] == list(scene.fingerprint())
    for change in ({"backend": "bvh"}, {"loss": "mse"}):
        with pytest.raises(ValueError, match="different training config"):
            tinv.recover_materials(cam, scene, target, **{**kw, **change})
    alb = as_np(scene.albedo).copy()
    red = np.nonzero(alb[:, 0] > alb[:, 1] + 0.2)[0]
    green = np.nonzero(alb[:, 1] > alb[:, 0] + 0.2)[0]
    alb[red], alb[green] = alb[green], alb[red]
    assert np.isclose(alb.sum(), as_np(scene.albedo).sum())
    swapped = tpt.scene_from_arrays(
        *(as_np(getattr(scene, f)) for f in ("v1", "v2", "v3", "mat_type")),
        alb, as_np(scene.emit), as_np(scene.roughness), scene.num_tris,
        device="cpu")
    with pytest.raises(ValueError, match="different training config"):
        tinv.recover_materials(cam, swapped, target, **kw)


def test_jax_train_checkpoint_params_load(tmp_path):
    """A JAX-written train checkpoint's parameters load through the port's
    reader and convert.material_params_from_arrays, and map to the
    materials JAX returned."""
    (jcam, jscene), (cam, scene) = scene_pair("corner", (8, 8))
    target = jdiff.render_film_diff(jcam, jscene,
                                    jdiff.material_params(jscene), 8, 2,
                                    sample_offset=10_000)
    path = os.path.join(tmp_path, "jax_train.npz")
    jmats, _ = jinv.recover_materials(jcam, jscene, target, steps=2,
                                      samples=4, depth=2,
                                      optimize=("albedo",), checkpoint=path)
    arrays, opt, step, _ = tckpt.load_train_checkpoint(path,
                                                       tinv.PARAM_NAMES)
    assert step == 2 and len(opt) == 7 and int(opt[0]) == 2
    params = tpt.material_params_from_arrays(arrays, device="cpu")
    mats = tinv.to_materials(params)
    for k in jmats:
        assert mats[k].shape == tuple(jmats[k].shape)
        np.testing.assert_allclose(as_np(mats[k]), np.asarray(jmats[k]),
                                   rtol=1e-6, atol=1e-7)
    # The port starts a recovery from them.
    _, losses = tinv.recover_materials(
        cam, scene, torch.from_numpy(np.asarray(target)), steps=1,
        samples=4, depth=2, params0=params, optimize=("albedo",))
    assert np.isfinite(losses).all()


def test_rejects_bad_loss_and_samples():
    cam, scene = tpt.corner_scene(res=(4, 4), device="cpu")
    target = torch.zeros(4, 4, 3)
    with pytest.raises(ValueError, match="unknown loss"):
        tinv.recover_materials(cam, scene, target, steps=1, loss="l1")
    with pytest.raises(ValueError, match="samples >= 2"):
        tinv.recover_materials(cam, scene, target, steps=1, samples=1)
