"""The megakernel's "plucker" loop, live-segment count and device defaults.

The plain Plücker version (``render_sum_reference(..., loop="plucker")``
over ``ops/intersect.intersect_plucker``) against pathtracer_tpu's Pallas
megakernel in interpret mode with ``loop="plucker"``, and against the
port's own "mt" loop, on the CPU; the Plücker packing against the JAX
packing; the kernel's padded row layouts; ``count_live_segments`` against a
count made from ``trace_rays``' hits; and the ``device="cuda"`` default of
every constructor.  The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py.
"""

import argparse
import inspect

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu.ops.pallas import trace_kernel as jtk
from pathtracer_tpu_torch import camera as tcamera
from pathtracer_tpu_torch import convert as tconvert
from pathtracer_tpu_torch import meshes as tmeshes
from pathtracer_tpu_torch import obj_loader as tobj
from pathtracer_tpu_torch import scene as tscene_mod
from pathtracer_tpu_torch.examples._device import add_device_arg
from pathtracer_tpu_torch.ops import intersect as tisect
from pathtracer_tpu_torch.ops import trace as ttrace
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

from _torch_parity import as_np, assert_films_close, scene_pair

PALLAS_CASES = [("corner", 4, 3), ("cornell", 2, 3), ("specular", 2, 3)]
SCENE_NAMES = ["corner", "cornell", "specular"]


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_plucker_params_equal_jax_packing(name):
    (jcam, jscene), (tcam, tscene) = scene_pair(name, (32, 16))
    got = ttk._triangle_params_plucker(tscene, tcam.host_pos())
    want = np.asarray(jtk._triangle_params_plucker(jscene, jcam.pos))
    assert got.dtype == np.float32 and got.shape == (tscene.num_tris, 27)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,spp,depth", PALLAS_CASES)
def test_reference_matches_pallas_plucker(name, spp, depth):
    (jcam, jscene), (tcam, tscene) = scene_pair(name, (16, 16))
    want = jtk.render_film_pallas(jcam, jscene, spp, depth, seed=1,
                                  loop="plucker", interpret=True,
                                  tile_rows=8)
    got = ttk.render_sum_reference(tcam, tscene, 0, spp, depth, seed=1,
                                   loop="plucker") / spp
    assert float(got.sum()) > 0.0
    assert_films_close(got, want.data)


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_plucker_matches_mt(name):
    _, (cam, scene) = scene_pair(name, (16, 16))
    mt = ttk.render_sum_reference(cam, scene, 0, 4, 5, loop="mt") / 4
    pl = ttk.render_sum_reference(cam, scene, 0, 4, 5, loop="plucker") / 4
    assert float(pl.sum()) > 0.0
    assert_films_close(pl, mt)


def test_default_loop_is_plucker_on_the_cpu_path():
    """render_sum_reference and the CPU wrapper take DEFAULT_LOOP, and the
    wrapper counts no launch on a CPU scene."""
    _, (cam, scene) = scene_pair("specular", (16, 8))
    before = dict(ttk.LOOP_LAUNCHES), ttk.LAUNCHES
    got = ttk.render_sum_cuda(cam, scene, 3, 3, 3, seed=5)
    want = ttk.render_sum_reference(cam, scene, 3, 3, 3, seed=5,
                                    loop=ttk.DEFAULT_LOOP)
    assert (dict(ttk.LOOP_LAUNCHES), ttk.LAUNCHES) == before
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="loop"):
        ttk.render_sum_cuda(cam, scene, 0, 1, 1, loop="bvh")


def test_primary_collapse_finds_the_general_hits():
    """At bounce 0 the collapsed sums find the hits of the general form:
    the same triangle but at near-ties, t within float reassociation."""
    _, (cam, scene) = scene_pair("cornell", (32, 32))
    rows = torch.from_numpy(ttk._triangle_params_plucker(scene,
                                                         cam.host_pos()))
    gen = np.random.default_rng(3)
    w = torch.from_numpy(gen.integers(0, 32, 4096))
    h = torch.from_numpy(gen.integers(0, 32, 4096))
    u = torch.from_numpy(gen.random((2, 4096), np.float32))
    o, d = tpt.get_rays(cam, w, h, u[0], u[1])
    t0, id0 = tisect.intersect_plucker(o, d, rows, primary=True)
    t1, id1 = tisect.intersect_plucker(o, d, rows)
    tb, idb = tisect.intersect_brute(o, d, scene.v1, scene.v2, scene.v3)
    assert int((id0 >= 0).sum()) > 3000
    for t, tid in ((t1, id1), (tb, idb)):
        assert float((tid != id0).float().mean()) <= 1e-3
        same = tid == id0
        torch.testing.assert_close(t[same], t0[same], rtol=1e-5, atol=0)


@pytest.mark.parametrize("multiple", [4, 8])
@pytest.mark.parametrize("loop", ttk.LOOPS)
def test_kernel_rows_layout(loop, multiple):
    """The kernel's rows: the packed columns in the source's float4 order,
    a zero column, and zero rows up to the kernel's row multiple."""
    _, (cam, scene) = scene_pair("specular", (16, 16))
    rows = as_np(ttk._kernel_rows(scene, cam, loop, multiple))
    n = scene.num_tris
    if loop == "mt":
        packed = as_np(ttk._triangle_params(scene))
        order = ttk._MT_ORDER
    else:
        packed = ttk._triangle_params_plucker(scene, cam.host_pos())
        order = ttk._PLUCKER_ORDER
    assert rows.shape == (-(-n // multiple) * multiple,
                          12 if loop == "mt" else 28)
    assert rows.shape[0] > n
    full = np.concatenate([packed, np.zeros((n, 1), np.float32)], axis=1)
    np.testing.assert_array_equal(rows[:n], full[:, list(order)])
    assert not rows[n:].any()
    assert all(j in order for j in range(packed.shape[1])
               if packed[:, j].any())


def _direct_live_count(cam, scene, samples, depth):
    """Segments traced while alive, from the hits trace_rays sees: a path
    is alive at bounce 0 and stays alive after a hit on a non-EMIT
    triangle."""
    hits = []

    def intersect(o, d):
        t, tid = tisect.intersect_brute(o, d, scene.v1, scene.v2, scene.v3)
        hits.append(tid)
        return t, tid

    table = ttrace.shade_table(scene)
    w = torch.arange(cam.width).expand(cam.height, cam.width)
    h = torch.arange(cam.height)[:, None].expand(cam.height, cam.width)
    ttrace.sample_radiance(cam, scene, table, w, h, torch.arange(samples),
                           depth, tpt.rng.SEED, intersect=intersect)
    alive = torch.ones(hits[0].shape, dtype=torch.bool)
    count = 0
    for tid in hits:
        count += int(alive.sum())
        emit = table[tid.clamp_min(0).long(), 10] > 0.5
        alive = alive & (tid >= 0) & ~emit
    return count


@pytest.mark.parametrize("name", ["cornell", "specular"])
def test_count_live_segments_matches_trace_rays(name):
    _, (cam, scene) = scene_pair(name, (16, 16))
    want = _direct_live_count(cam, scene, 3, 5)
    got = ttk.count_live_segments(cam, scene, 0, 3, 5, loop="mt")
    assert got == want
    assert 16 * 16 * 3 <= got < 16 * 16 * 3 * 5
    lengths = ttk.path_lengths(cam, scene, 0, 3, 5, loop="mt", h0=4,
                               band_h=5)
    full = ttk.path_lengths(cam, scene, 0, 3, 5, loop="mt")
    assert torch.equal(lengths, full[:, 4:9])
    assert int(full.min()) >= 1 and int(full.max()) <= 5


CONSTRUCTORS = {
    "make_camera": tcamera.make_camera,
    "Scene.from_arrays": tscene_mod.Scene.from_arrays,
    "SceneBuilder.build": tscene_mod.SceneBuilder.build,
    "cornell_box": tscene_mod.cornell_box,
    "modified_cornell": tscene_mod.modified_cornell,
    "corner_scene": tscene_mod.corner_scene,
    "scene_from_arrays": tconvert.scene_from_arrays,
    "camera_from_arrays": tconvert.camera_from_arrays,
    "sphere_in_box": tmeshes.sphere_in_box,
    "mesh_garden": tmeshes.mesh_garden,
    "load_obj_scene": tobj.load_obj_scene,
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_default_to_cuda(name):
    """Every constructor builds on the card unless asked for another
    device: without one it raises PyTorch's own error, never falls back."""
    param = inspect.signature(CONSTRUCTORS[name]).parameters["device"]
    assert param.default == "cuda"


def test_examples_device_defaults_to_cuda():
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    assert ap.parse_args([]).device == "cuda"
    assert ap.parse_args(["--device", "cpu"]).device == "cpu"


def test_camera_keeps_its_host_position():
    cam = tpt.make_camera((1, 2, 3), (0, 0, 1), (0, 1, 0), (8, 8), 1.0,
                          device="cpu")
    np.testing.assert_array_equal(cam.host_pos(), [1, 2, 3])
    assert getattr(cam.to("cpu"), "_host_pos", None) is not None
    moved = tpt.move(cam, tpt.UP, 2.0)
    assert getattr(moved, "_host_pos", None) is None
    np.testing.assert_array_equal(moved.host_pos(), as_np(moved.pos))
