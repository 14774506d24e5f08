"""pathtracer_tpu_torch's procedural meshes and OBJ/MTL import against
pathtracer_tpu on the CPU: the counterparts of tests/test_meshes.py and
tests/test_obj.py for what tests/test_torch_bvh.py does not already hold
(it holds sphere_in_box, the garden at grid 2, a sphere_in_box OBJ round
trip and one fan-triangulated quad with negative indices).  Each builder
or loader of the two packages must give the same scene arrays bit for
bit."""

import textwrap

import numpy as np
import pytest

import pathtracer_tpu as jpt
from pathtracer_tpu import meshes as jmeshes
from pathtracer_tpu import obj_loader as jobj

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch import meshes as tmeshes
from pathtracer_tpu_torch import obj_loader as tobj

from _torch_parity import SCENE_FIELDS, assert_films_close
from test_torch_bvh import assert_same_arrays


@pytest.mark.parametrize("n_lat,n_lon", [(8, 12), (5, 7), (2, 3)])
def test_uv_sphere_matches_jax(n_lat, n_lon):
    """2 triangles a quad but single fans at the two poles."""
    jsb = jmeshes.uv_sphere((1, -2, 3), 2.5, n_lat, n_lon,
                            jpt.Diffuse(0.3, 0.6, 0.9))
    tsb = tmeshes.uv_sphere((1, -2, 3), 2.5, n_lat, n_lon,
                            tpt.Diffuse(0.3, 0.6, 0.9))
    assert len(tsb) == len(jsb) == 2 * n_lat * n_lon - 2 * n_lon
    assert_same_arrays(jsb.build(), tsb.build(device="cpu"), SCENE_FIELDS)


@pytest.mark.parametrize("n_major,n_minor", [(8, 6), (12, 3), (3, 4)])
def test_torus_matches_jax(n_major, n_minor):
    jsb = jmeshes.torus((0, 1, 0), 3.0, 1.0, n_major, n_minor,
                        jpt.Specular(0.2, 0.9, 0.5, 0.1))
    tsb = tmeshes.torus((0, 1, 0), 3.0, 1.0, n_major, n_minor,
                        tpt.Specular(0.2, 0.9, 0.5, 0.1))
    assert len(tsb) == len(jsb) == 2 * n_major * n_minor
    assert_same_arrays(jsb.build(), tsb.build(device="cpu"), SCENE_FIELDS)


def _garden_tris(grid, n_lat=22, n_lon=48):
    """The garden's triangles by the generators' arithmetic: the room's six
    quads, spheres and tori alternating on the grid."""
    sphere = 2 * n_lat * n_lon - 2 * n_lon
    tor = 2 * n_lon * (n_lat + 2)
    n_s = sum(1 for i in range(grid) for j in range(grid) if (i + j) % 2 == 0)
    return 12 + n_s * sphere + (grid * grid - n_s) * tor


@pytest.mark.parametrize("grid", [1, 3, 7])
def test_mesh_garden_scale(grid):
    """The default grid is the ~100k-triangle stress scene (105,708, the
    benchmark's garden); smaller grids build the same arrays as the JAX
    package."""
    _, tsb = tmeshes.mesh_garden(grid=grid, device="cpu")
    _, jsb = jmeshes.mesh_garden(grid=grid)
    assert len(tsb) == len(jsb) == _garden_tris(grid)
    if grid == 7:
        assert len(tsb) == 105_708
    else:
        assert_same_arrays(jsb.build(), tsb.build(device="cpu"),
                           SCENE_FIELDS)


MTLS = {
    "illums": """\
        newmtl red_wall
        Kd 1.0 0.0 0.0
        Ka 0 0 0
        illum 1

        newmtl lamp
        Ka 2.0 2.0 2.0
        Kd 0 0 0
        illum 2

        newmtl weird
        Kd 0.1 0.2 0.3
        illum 7
    """,
    "comments": """\
        # a comment before any material
        Kd 9 9 9
        newmtl\tglossy   extra
        \tNs 96.0
        Kd 0.25   0.5\t0.75  # trailing comment
        d 1.0
        illum 1
        #newmtl hidden
    """,
    "defaults": """\
        newmtl bare
        newmtl twice
        Kd 0.1 0.1 0.1
        newmtl twice
        Ka 3 2 1
        illum 2
    """,
}


@pytest.mark.parametrize("name", sorted(MTLS))
def test_parse_mtl_matches_jax(tmp_path, name):
    path = tmp_path / "m.mtl"
    path.write_text(textwrap.dedent(MTLS[name]))
    got = tobj.parse_mtl(str(path))
    want = jobj.parse_mtl(str(path))
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert ((got[k].ka, got[k].kd, got[k].illum)
                == (want[k].ka, want[k].kd, want[k].illum)), k


@pytest.fixture
def obj_dir(tmp_path):
    (tmp_path / "scene.mtl").write_text(textwrap.dedent(MTLS["illums"]))
    (tmp_path / "scene.obj").write_text(textwrap.dedent("""\
        mtllib scene.mtl
        v 0 0 0
        v 1 0 0
        v 0 1 0
        v 1 1 0
        f 1 3 4
        usemtl red_wall
        f 1 2 3
        usemtl lamp
        f 2 4 3
        usemtl weird
        f 1 2 4
        usemtl missing
        f 4 3 1
    """))
    return tmp_path


def test_obj_materials_match_jax(obj_dir):
    """illum 1 takes Kd, illum 2 emits Ka, an unknown illum, a face before
    any usemtl and an undefined material take Diffuse(0.5)."""
    path, mtl = str(obj_dir / "scene.obj"), str(obj_dir)
    tscene = tpt.load_obj_scene(path, mtl_path=mtl, device="cpu")
    jscene = jpt.load_obj_scene(path, mtl_path=mtl)
    assert tscene.num_tris == 5
    assert_same_arrays(jscene, tscene, SCENE_FIELDS)
    mtype, albedo, emit, _ = tscene.host_materials()
    assert list(mtype[:5]) == [tpt.DIFFUSE, tpt.DIFFUSE, tpt.EMIT,
                               tpt.DIFFUSE, tpt.DIFFUSE]
    np.testing.assert_array_equal(albedo[1], [1, 0, 0])
    np.testing.assert_array_equal(emit[2], [2, 2, 2])
    for k in (0, 3, 4):
        np.testing.assert_array_equal(albedo[k], [0.5, 0.5, 0.5])


def test_obj_scene_renders_like_jax(obj_dir):
    """An OBJ scene through the whole pipeline: the port's film against
    the JAX package's within the film bar."""
    path, mtl = str(obj_dir / "scene.obj"), str(obj_dir)
    args = ((0.5, 0.5, 2.5), (0, 0, -1), (0, 1, 0), (8, 8),
            60 * jpt.DEG2RAD, 1.0)
    got = tpt.render_film(tpt.make_camera(*args, device="cpu"),
                          tpt.load_obj_scene(path, mtl_path=mtl,
                                             device="cpu"),
                          4, 3, backend="brute").data
    want = jpt.render_film(jpt.make_camera(*args),
                           jpt.load_obj_scene(path, mtl_path=mtl),
                           samples=4, depth=3, backend="brute").data
    assert float(got.max()) > 0
    assert_films_close(got, np.asarray(want))


@pytest.mark.parametrize("n", [3, 5, 6])
def test_polygon_triangulation_matches_jax(tmp_path, n):
    """An n-gon is a fan of n - 2 triangles, or under the reference's
    strict triangulation its first three vertices only."""
    ring = "".join(f"v {np.cos(2 * np.pi * k / n):.6f} "
                   f"{np.sin(2 * np.pi * k / n):.6f} 0\n" for k in range(n))
    path = tmp_path / "p.obj"
    path.write_text(ring + "f " + " ".join(str(k + 1) for k in range(n))
                    + "\n")
    for strict, count in ((False, n - 2), (True, 1)):
        tscene = tobj.load_obj(
            str(path), strict_reference_triangulation=strict).build(
                device="cpu")
        jscene = jobj.load_obj(
            str(path), strict_reference_triangulation=strict).build()
        assert tscene.num_tris == count
        assert_same_arrays(jscene, tscene, SCENE_FIELDS)


@pytest.mark.parametrize("face", ["f 1/1 2/2 3/3", "f 1//1 2//2 3//3",
                                  "f -1 -2 -3", "f 3/1/1 -3 2//1"])
def test_face_index_forms_match_jax(tmp_path, face):
    """Texture and normal indices are skipped, negative indices count back
    from the last vertex read; vt and vn lines are ignored."""
    path = tmp_path / "f.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nvt 0.5 0.5\nv 0 1 0\nvn 0 0 1\n"
                    + face + "\n")
    tscene = tpt.load_obj_scene(str(path), device="cpu")
    jscene = jpt.load_obj_scene(str(path))
    assert tscene.num_tris == 1
    assert_same_arrays(jscene, tscene, SCENE_FIELDS)
