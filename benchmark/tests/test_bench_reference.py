"""The plain reference against the port, at small sizes on the CPU (the
port's kernel wrappers take their plain versions there)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.reference import compare, scenes  # noqa: E402
from benchmark.reference.beam import BeamTracer  # noqa: E402
from benchmark.reference.recover import Recovery, start_params  # noqa: E402
from benchmark.reference.render import PixelTracer  # noqa: E402

import pathtracer_tpu_torch as pt  # noqa: E402
from pathtracer_tpu_torch import diff, inverse, meshes  # noqa: E402
from pathtracer_tpu_torch.camera import make_camera  # noqa: E402
from pathtracer_tpu_torch.ops.cuda import beam_kernel  # noqa: E402
from pathtracer_tpu_torch.ops.cuda import trace_kernel  # noqa: E402
from pathtracer_tpu_torch.scene import Scene  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 11


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def small_garden():
    cfg = config("garden105708")
    cfg["scene"].update(grid=2, n_lat=6, n_lon=8)
    return cfg


def port_scene(cfg, res):
    arrays = scenes.make_scene(cfg)
    return (arrays, scenes.make_camera(cfg, res),
            make_camera(**scenes.camera_args(cfg, res), device="cpu"),
            Scene.from_arrays(*arrays.as_args(), device="cpu"))


def all_pixels(res):
    pix = torch.arange(res[0] * res[1])
    return pix % res[0], pix // res[0]


@pytest.mark.parametrize("name,port", [
    ("cornell_box", lambda: pt.cornell_box(device="cpu")[1]),
    ("garden105708", lambda: meshes.mesh_garden(device="cpu")[1].build(
        device="cpu")),
])
def test_scene_arrays_equal_the_ports(name, port):
    ours, theirs = scenes.make_scene(config(name)), port()
    assert ours.num_tris == theirs.num_tris
    for f in ("v1", "v2", "v3", "mat_type", "albedo", "emit", "roughness"):
        assert np.array_equal(getattr(ours, f), getattr(theirs, f).numpy()), f


@pytest.mark.parametrize("name,port", [
    ("cornell_box", lambda res: pt.cornell_box(res, device="cpu")[0]),
    ("garden105708", lambda res: meshes.mesh_garden(device="cpu")[0]),
])
def test_camera_equals_the_ports(name, port):
    cfg = config(name)
    res = (cfg["width"], cfg["height"])
    ours, theirs = scenes.make_camera(cfg, res), port(res)
    for a, b in ((ours.pos, theirs.pos), (ours.forward, theirs.forward),
                 (ours.up, theirs.up), (ours.right, theirs.right),
                 (ours.v_res, theirs.v_res)):
        assert np.array_equal(a, b.numpy())
    assert ours.cell == theirs.cell_size.item()


@pytest.mark.parametrize("loop", ["plucker", "mt"])
def test_cornell_pixels_equal_the_kernels_plain_version(loop):
    res = (16, 12)
    arrays, cam_ref, cam, scene = port_scene(config("cornell_box"), res)
    film = trace_kernel.render_sum_reference(
        cam, scene, 0, 24, 4, seed=SEED, loop=loop, spp_per_call=8) / 24
    w, h = all_pixels(res)
    ref = PixelTracer(arrays, cam_ref, CPU, loop=loop).film(w, h, 24, 4,
                                                           SEED, 8)
    assert float(ref.sum()) > 0
    assert torch.equal(film[h, w], ref)


def test_cornell_pixels_equal_the_brute_route():
    res = (16, 16)
    arrays, cam_ref, cam, scene = port_scene(config("cornell_box"), res)
    film = pt.render_film(cam, scene, 32, 3, seed=SEED, backend="auto").data
    rng = np.random.default_rng(0)
    pix = torch.from_numpy(rng.choice(256, 40, replace=False))
    w, h = pix % 16, pix // 16
    ref = PixelTracer(arrays, cam_ref, CPU, loop="mt").film(w, h, 32, 3,
                                                           SEED, 32)
    assert compare.film_gap(film[h, w], ref) == 0.0


def test_beam_pixels_equal_the_beam_plain_version():
    res = (64, 96)
    arrays, cam_ref, cam, scene = port_scene(small_garden(), res)
    film = beam_kernel.render_sum_beam(cam, scene, 0, 5, 3, seed=SEED,
                                       spp_per_call=2) / 5
    rng = np.random.default_rng(1)
    pix = torch.from_numpy(rng.choice(res[0] * res[1], 64, replace=False))
    w, h = pix % res[0], pix // res[0]
    ref = BeamTracer(arrays, cam_ref, CPU).film(w, h, 5, 3, SEED, 2)
    assert float(ref.sum()) > 0
    assert torch.equal(film[h, w], ref)


def test_two_recovery_steps_follow_the_ports():
    res = (8, 8)
    cfg = config("cornell_box")
    arrays, cam_ref, cam, scene = port_scene(cfg, res)
    w, h = all_pixels(res)
    target = PixelTracer(arrays, cam_ref, CPU, loop="mt").film(
        w, h, 16, 3, 5, 16).reshape(8, 8, 3)
    p0 = start_params(arrays, CPU)
    params = {n: p0[n].clone().requires_grad_(True)
              for n in inverse.PARAM_NAMES}
    opt = torch.optim.Adam([params[n] for n in inverse.PARAM_NAMES],
                           lr=0.08, betas=inverse.ADAM_BETAS,
                           eps=inverse.ADAM_EPS)
    optimize = ("albedo", "emit")
    pb = inverse._Problem(
        camera=cam, scene=scene, target=target, samples=8, depth=3,
        seed=SEED, backend="brute", accel=diff.make_accel(scene, "brute"),
        loss="paired", rel_eps=2e-2, masks=inverse._row_masks(scene,
                                                              optimize),
        rough_spsa=False)
    losses = [inverse._train_step(pb, params, opt, k, 0.08) for k in (0, 1)]
    ref_losses, first, after, _ = Recovery(
        arrays, cam_ref, target, samples=8, depth=3, seed=SEED, lr=0.08,
        optimize=optimize, device=CPU).run(p0, 2)
    for a, b in zip(losses, ref_losses):
        assert compare.rel_gap(a, b) < 1e-6
    counted = compare.counted_leaves(first)
    assert counted == ["albedo", "emit"]
    got = {n: params[n].detach() - p0[n] for n in after}
    want = {n: after[n] - p0[n] for n in after}
    assert compare.leaf_gaps(got, want, counted) < 1e-5


def test_control_precision_changes_the_film():
    res = (16, 16)
    arrays, cam_ref, _, _ = port_scene(config("cornell_box"), res)
    w, h = all_pixels(res)
    ref = PixelTracer(arrays, cam_ref, CPU).film(w, h, 16, 3, SEED, 16)
    low = PixelTracer(arrays, cam_ref, CPU, dtype=torch.bfloat16).film(
        w, h, 16, 3, SEED, 16)
    assert compare.film_gap(low, ref) > 1e-2


def test_film_gap_and_leaf_gaps():
    r = torch.tensor([[1.0, 2.0, 3.0]])
    assert compare.film_gap(r, r) == 0.0
    assert compare.film_gap(r * 1.5, r) == pytest.approx(0.5)
    assert compare.film_gap(torch.tensor([[float("nan"), 0, 0]]), r) == \
        float("inf")
    ref = {"a": torch.ones(4), "b": torch.ones(4) * 2, "c": torch.zeros(4)}
    assert compare.counted_leaves(ref) == ["a", "b"]
    prog = {"a": torch.ones(4), "b": torch.zeros(4), "c": torch.zeros(4)}
    assert compare.leaf_gaps(prog, ref, ["a", "b"]) == pytest.approx(1.0)
    v = compare.verdict({"x": 0.5, "y": float("nan")}, {"x": 1.0, "y": 1.0})
    assert not v["correct"] and v["checks"]["x"] == {"value": 0.5,
                                                     "limit": 1.0}


def test_seeds_past_32_bits_and_negative():
    arrays, cam_ref, cam, scene = port_scene(config("cornell_box"), (8, 8))
    w, h = all_pixels((8, 8))
    for seed in (2**33 + 5, -7):
        film = pt.render_film(cam, scene, 4, 2, seed=seed).data
        ref = PixelTracer(arrays, cam_ref, CPU, loop="mt").film(w, h, 4, 2,
                                                               seed, 4)
        assert torch.equal(film[h, w], ref)


def test_scene_arrays_are_padded_with_rejected_rows():
    arrays = scenes.make_scene(small_garden())
    n = arrays.num_tris
    assert arrays.v1.shape[0] % scenes.PAD == 0 and arrays.v1.shape[0] > n
    assert not arrays.v1[n:].any() and not arrays.mat_type[n:].any()
