"""pathtracer_tpu_torch's host builders and BVH traversal against
pathtracer_tpu: meshes, OBJ import, the SAH BVH (numpy and native), and
intersect_bvh against the JAX package's brute-force intersection."""

import numpy as np
import pytest
import torch

import pathtracer_tpu as jpt
from pathtracer_tpu import meshes as jmeshes
from pathtracer_tpu.ops import intersect as jisect
from pathtracer_tpu.ops import trace as jtrace
from pathtracer_tpu.utils import native as jnative

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch import meshes as tmeshes
from pathtracer_tpu_torch.ops import intersect as tisect
from pathtracer_tpu_torch.ops import trace as ttrace
from pathtracer_tpu_torch.utils import native as tnative

from _torch_parity import SCENE_FIELDS, as_np, carry

BVH_FIELDS = ("lb", "rt", "left", "right", "tri_start", "tri_end", "tri_idx")

MESHES = {
    "sphere8x12": lambda m, **kw: m.sphere_in_box(8, 12, **kw),
    "sphere10x20": lambda m, **kw: m.sphere_in_box(10, 20, **kw),
    "garden2": lambda m, **kw: m.mesh_garden(grid=2, **kw),
}


def _pair(name):
    """(JAX scene, port scene), each built by its own package."""
    return (MESHES[name](jmeshes)[1].build(),
            MESHES[name](tmeshes, device="cpu")[1].build(device="cpu"))


def assert_same_arrays(jobj, tobj, fields):
    for f in fields:
        want, got = np.asarray(getattr(jobj, f)), as_np(getattr(tobj, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_meshes_match_jax(name):
    jscene, tscene = _pair(name)
    assert tscene.num_tris == jscene.num_tris
    assert_same_arrays(jscene, tscene, SCENE_FIELDS)
    jcam, _ = MESHES[name](jmeshes)
    tcam, _ = MESHES[name](tmeshes, device="cpu")
    for f in ("pos", "forward", "up", "right", "v_res", "cell_size"):
        np.testing.assert_array_equal(as_np(getattr(tcam, f)),
                                      np.asarray(getattr(jcam, f)))


@pytest.mark.parametrize("use_native", [False, None])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_bvh_matches_jax(name, use_native):
    if use_native is None and jnative.get_lib() is None:
        assert tnative.get_lib() is None
    jscene, tscene = _pair(name)
    jb = jpt.build_bvh(jscene, use_native=use_native)
    tb = tpt.build_bvh(tscene, use_native=use_native)
    assert_same_arrays(jb, tb, BVH_FIELDS)
    assert (tb.max_leaf, tb.depth, tb.num_nodes) == (jb.max_leaf, jb.depth,
                                                      jb.num_nodes)


def test_print_tree_matches_jax():
    # The JAX package's dump indexes device arrays node by node (about 20 s
    # for garden2), so it is held on the smallest mesh only.
    jscene, tscene = _pair("sphere8x12")
    assert (tpt.print_tree(tpt.build_bvh(tscene))
            == jpt.print_tree(jpt.build_bvh(jscene)))


def test_native_binding(tmp_path):
    """The port's ctypes binding of the shared native library: a random
    triangle soup builds the same tree natively and in numpy (as
    tests/test_native.py holds for the JAX binding), and the PNG writer
    round-trips."""
    if tnative.get_lib() is None:
        pytest.skip("native library not built (make -C native)")
    rng = np.random.default_rng(0)
    sb = tpt.SceneBuilder()
    for _ in range(200):
        base = rng.uniform(-10, 10, 3)
        sb.add_triangle(base, base + rng.normal(0, 0.5, 3),
                        base + rng.normal(0, 0.5, 3), tpt.Diffuse(1))
    scene = sb.build(device="cpu")
    assert_same_arrays(tpt.build_bvh(scene, use_native=True),
                       tpt.build_bvh(scene, use_native=False), BVH_FIELDS)
    img = rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)
    assert tnative.write_png(str(tmp_path / "n.png"), img)
    np.testing.assert_array_equal(tpt.read_png(str(tmp_path / "n.png")), img)


def test_bvh_moves_to_device_with_host_copies():
    _, tscene = _pair("sphere8x12")
    bvh = tpt.build_bvh(tscene)
    moved = bvh.to("cpu")
    assert moved._host is bvh._host and moved.stack_size() == bvh.depth + 2


def test_obj_round_trip_matches_jax(tmp_path):
    _, jsb = jmeshes.sphere_in_box(6, 8)
    _, tsb = tmeshes.sphere_in_box(6, 8, device="cpu")
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jmeshes.save_obj(jsb, str(jdir / "m.obj"))
    tmeshes.save_obj(tsb, str(tdir / "m.obj"))
    for name in ("m.obj", "m.mtl"):
        assert (tdir / name).read_text() == (jdir / name).read_text(), name
    jscene = jpt.load_obj_scene(str(jdir / "m.obj"), mtl_path=str(jdir))
    tscene = tpt.load_obj_scene(str(jdir / "m.obj"), mtl_path=str(jdir),
                                device="cpu")
    assert (tscene.num_tris == jscene.num_tris
            == tsb.build(device="cpu").num_tris)
    assert_same_arrays(jscene, tscene, SCENE_FIELDS)


def test_obj_fan_triangulation_and_illum(tmp_path):
    (tmp_path / "q.mtl").write_text(
        "newmtl lamp\nKa 2 3 4\nillum 2\n\nnewmtl odd\nKd 1 0 0\nillum 7\n")
    (tmp_path / "q.obj").write_text(
        "mtllib q.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "usemtl lamp\nf 1 2 3 4\nusemtl odd\nf -4/1 -3/2/3 -2//1\n")
    path = str(tmp_path / "q.obj")
    jscene = jpt.load_obj_scene(path, mtl_path=str(tmp_path))
    tscene = tpt.load_obj_scene(path, mtl_path=str(tmp_path), device="cpu")
    assert tscene.num_tris == 3
    assert_same_arrays(jscene, tscene, SCENE_FIELDS)
    strict = tpt.load_obj(path, str(tmp_path),
                          strict_reference_triangulation=True).build(
                              device="cpu")
    assert strict.num_tris == 2


def _random_rays(lo, hi, n, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def assert_hits_match(t, tid, t_ref, tid_ref, tie_rtol=1e-5):
    """tid equal wherever the reference's nearest hit is not a near-tie
    (another hit within ``tie_rtol`` relative), t within the JAX package's
    own cluster-kernel bar, rtol 2e-3, and misses at FLOAT_INF."""
    t, tid = as_np(t), as_np(tid)
    t_ref, tid_ref = np.asarray(t_ref), np.asarray(tid_ref)
    hit = tid_ref >= 0
    np.testing.assert_array_equal(tid >= 0, hit)
    differ = tid != tid_ref
    if differ.any():
        rel = np.abs(t[differ] - t_ref[differ]) / np.abs(t_ref[differ])
        assert np.all(rel <= tie_rtol), (np.nonzero(differ), rel)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=2e-3)
    assert np.all(t[~hit] >= 1e29)


def test_intersect_bvh_matches_jax_brute():
    jscene, tscene = _pair("sphere8x12")
    ro, rd = _random_rays(50, 450, 700)  # the rays of tests/test_clusters.py
    t_ref, tid_ref = jisect.intersect_brute(ro, rd, jscene.v1, jscene.v2,
                                            jscene.v3)
    bvh = tpt.build_bvh(tscene)
    t, tid = tisect.intersect_bvh(
        torch.from_numpy(ro), torch.from_numpy(rd), bvh, tscene.v1,
        tscene.v2, tscene.v3, bvh.max_leaf, bvh.stack_size())
    assert tid.dtype == torch.int32
    assert (as_np(tid) >= 0).sum() > 300  # most rays hit something
    assert_hits_match(t, tid, t_ref, tid_ref)


def test_intersect_packed_matches_brute_tie_rule():
    """Dense against [v1, e1, e2] rows: the brute intersector's hits,
    first index on a tie (two coincident triangles)."""
    sb = tpt.SceneBuilder()
    for _ in range(2):
        sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), tpt.Diffuse(1))
    scene = sb.build(device="cpu")
    rows = torch.cat([scene.v1, scene.v2 - scene.v1, scene.v3 - scene.v1],
                     dim=-1)
    o = torch.tensor([[0.2, 0.2, 1.0], [2.0, 2.0, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    t, row = tisect.intersect_packed(o, d, rows, rays_per_chunk=1)
    t_b, tid_b = tisect.intersect_brute(o, d, scene.v1, scene.v2, scene.v3)
    assert row.tolist() == [0, -1] and tid_b.tolist() == [0, -1]
    assert torch.equal(t, t_b)


@pytest.mark.parametrize("name", ["sphere8x12", "garden2"])
def test_park_pose_matches_jax(name):
    jscene, tscene = _pair(name)
    assert ttrace.park_pose(tscene) == jtrace.park_pose(jscene)


def test_park_pose_is_kept_until_a_vertex_edit():
    """The pose is computed once per content version of the vertices: the
    same object while they are unedited, also through a scene with its
    materials swapped; after an in-place edit, the pose of the edited
    vertices."""
    _, tscene = _pair("garden2")
    pose = ttrace.park_pose(tscene)
    assert ttrace.park_pose(tscene) is pose
    swapped = tscene.replace_materials(albedo=tscene.albedo * 0.5)
    assert ttrace.park_pose(swapped) == pose
    with torch.no_grad():
        tscene.v2[0] += 5000.0
    moved = ttrace.park_pose(tscene)
    assert moved != pose and moved[0][0] > pose[0][0] + 4000.0


def test_trace_rays_park_pose_keeps_radiance():
    _, tscene = _pair("sphere8x12")
    cam, _ = tmeshes.sphere_in_box(8, 12, device="cpu")
    cam = carry_res(cam, (8, 8))
    table = ttrace.shade_table(tscene)
    w = torch.arange(8).expand(8, 8)
    h = torch.arange(8)[:, None].expand(8, 8)
    sidx = torch.arange(2)
    plain = ttrace.sample_radiance(cam, tscene, table, w, h, sidx, 3, 1)
    parked = ttrace.sample_radiance(cam, tscene, table, w, h, sidx, 3, 1,
                                    park_pose=ttrace.park_pose(tscene))
    assert torch.equal(plain, parked)


def carry_res(cam, res):
    import dataclasses
    return dataclasses.replace(cam, res=res)
