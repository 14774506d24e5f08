"""pathtracer_tpu_torch's cluster set and beam accel against pathtracer_tpu:
the builders array for array, and the cluster intersection's plain version
against the JAX package's brute intersection and its cluster kernel in
interpret mode."""

import numpy as np
import pytest
import torch

import pathtracer_tpu as jpt
from pathtracer_tpu import clusters as jclusters
from pathtracer_tpu import meshes as jmeshes
from pathtracer_tpu.ops import intersect as jisect
from pathtracer_tpu.ops.pallas import beam_kernel as jbk
from pathtracer_tpu.ops.pallas import cluster_kernel as jck

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch import clusters as tclusters
from pathtracer_tpu_torch import meshes as tmeshes
from pathtracer_tpu_torch.ops.cuda import cluster_kernel as tck

from _torch_parity import SCENE_FIELDS, as_np, carry
from test_torch_bvh import _random_rays, assert_hits_match, assert_same_arrays

CLUSTER_FIELDS = ("tri_data", "tid_map", "start", "count", "bounds")
BEAM_FIELDS = ("tri_cols", "tid_map", "cl_bounds", "sc_bounds", "sc_first",
               "sc_ncl", "sc_order", "mats")
BEAM_INTS = ("num_clusters", "num_superclusters", "num_materials", "ctris",
             "mats_inline")


def inline_scenes():
    """The 70-material scene of tests/test_beam.py, built by each package:
    more than 64 materials, so the beam accel inlines them."""
    out = []
    for m in (jpt, tpt):
        sb = m.SceneBuilder()
        s = 100.0
        sb.add_quad(((s, s - 1, 30), (s, s - 1, 70), (0, s - 1, 70),
                     (0, s - 1, 30)), m.Emit(1))
        for i in range(70):
            x = (i % 10) * 10.0
            z = (i // 10) * 12.0 + 5.0
            sb.add_quad(((x, 0, z), (x + 9, 0, z), (x + 9, 0, z + 10),
                         (x, 0, z + 10)), m.Diffuse(0.1 + 0.012 * i, 0.5, 0.9))
        out.append(sb.build(**({"device": "cpu"} if m is tpt else {})))
    return tuple(out)


def _mesh_pair(name, *args, **kwargs):
    """(JAX scene, port scene on the CPU) of one procedural mesh."""
    port = getattr(tmeshes, name)(*args, device="cpu", **kwargs)[1]
    return (getattr(jmeshes, name)(*args, **kwargs)[1].build(),
            port.build(device="cpu"))


SCENES = {
    "sphere8x12": lambda: _mesh_pair("sphere_in_box", 8, 12),
    "sphere10x20": lambda: _mesh_pair("sphere_in_box", 10, 20),
    "garden2": lambda: _mesh_pair("mesh_garden", grid=2),
    "cornell": lambda: (jpt.cornell_box(res=(8, 8))[1],
                        carry(*jpt.cornell_box(res=(8, 8)))[1]),
    "inline70": inline_scenes,
}


def _bvhs(jscene, tscene):
    return jpt.build_bvh(jscene), tpt.build_bvh(tscene)


@pytest.mark.parametrize("max_tris", [16, 64])
@pytest.mark.parametrize("name", ["sphere8x12", "sphere10x20", "garden2"])
def test_build_clusters_matches_jax(name, max_tris):
    jscene, tscene = SCENES[name]()
    jb, tb = _bvhs(jscene, tscene)
    jcs = jpt.build_clusters(jscene, bvh=jb, max_tris=max_tris)
    tcs = tpt.build_clusters(tscene, bvh=tb, max_tris=max_tris)
    assert_same_arrays(jcs, tcs, CLUSTER_FIELDS)
    assert (tcs.num_clusters, tcs.max_count) == (jcs.num_clusters,
                                                 jcs.max_count)
    for a, b in zip(tcs.scene_bounds, jcs.scene_bounds):
        np.testing.assert_array_equal(as_np(a), np.asarray(b))
    np.testing.assert_array_equal(as_np(tcs.centers), np.asarray(jcs.centers))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_beam_accel_matches_jax(name):
    jscene, tscene = SCENES[name]()
    jb, tb = _bvhs(jscene, tscene)
    ja = jpt.build_beam_accel(jscene, bvh=jb)
    ta = tpt.build_beam_accel(tscene, bvh=tb)
    assert_same_arrays(ja, ta, BEAM_FIELDS)
    for f in BEAM_INTS:
        assert getattr(ta, f) == getattr(ja, f), f
    assert ta.mats_inline == (name == "inline70")


def test_beam_accel_cut_sizes_match_jax():
    """An explicit supercluster cut and 16-row clusters: the padding, the
    sentinel cluster and the per-octant orders still agree."""
    jscene, tscene = SCENES["sphere10x20"]()
    ja = jpt.build_beam_accel(jscene, ctris=16, sc_tris=64)
    ta = tpt.build_beam_accel(tscene, ctris=16, sc_tris=64)
    assert_same_arrays(ja, ta, BEAM_FIELDS)
    assert ta.tri_cols.shape[0] == (ta.num_clusters + 1) * 16
    assert ta.cl_bounds.shape[0] % 8 == 0
    assert (ta.cl_bounds.shape[0] - ta.num_clusters) >= 8


def test_builder_cut_rules_match_jax():
    assert tclusters.MAX_BEAM_SC == jbk.MAX_BEAM_SC == 1008
    assert tclusters.MAX_SC_CLUSTERS == jclusters.MAX_SC_CLUSTERS
    assert tclusters.PACK_PAD == jclusters.PACK_PAD
    assert tclusters.MAX_BEAM_MATERIALS == jclusters.MAX_BEAM_MATERIALS


def test_beam_accel_rejects_emissive_non_emit():
    for m in (jpt, tpt):
        sb = m.SceneBuilder()
        sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                        m.HostMaterial(m.DIFFUSE, color=(1, 1, 1),
                                       emit=(1, 0, 0)))
        with pytest.raises(ValueError, match="non-EMIT"):
            m.build_beam_accel(
                sb.build(**({"device": "cpu"} if m is tpt else {})))


def test_cluster_set_moves_to_device():
    _, tscene = SCENES["sphere8x12"]()
    cs = tpt.build_clusters(tscene)
    moved = cs.to("cpu")
    assert moved.device.type == "cpu" and moved.num_clusters == cs.num_clusters
    acc = tpt.build_beam_accel(tscene).to("cpu")
    assert acc.device.type == "cpu"


def test_intersect_clusters_matches_jax():
    """The rays of tests/test_clusters.py: the port's plain version and its
    CPU wrapper against the JAX package's brute intersection and its
    cluster kernel in interpret mode."""
    jscene, tscene = SCENES["sphere8x12"]()
    jcs = jpt.build_clusters(jscene, max_tris=16)
    tcs = tpt.build_clusters(tscene, max_tris=16)
    ro, rd = _random_rays(50, 450, 700)
    t_b, tid_b = jisect.intersect_brute(ro, rd, jscene.v1, jscene.v2,
                                        jscene.v3)
    t_k, tid_k = jck.intersect_clusters(ro, rd, jcs, interpret=True)
    o, d = torch.from_numpy(ro), torch.from_numpy(rd)
    t_p, tid_p = tck.intersect_clusters_reference(o, d, tcs)
    assert tid_p.dtype == torch.int32 and (as_np(tid_p) >= 0).sum() > 300
    assert_hits_match(t_p, tid_p, t_b, tid_b)
    assert_hits_match(t_p, tid_p, t_k, tid_k)
    t_w, tid_w = tck.intersect_clusters(o, d, tcs)   # CPU: the plain version
    assert torch.equal(t_w, t_p) and torch.equal(tid_w, tid_p)


def test_intersect_clusters_checks_inputs():
    _, tscene = SCENES["sphere8x12"]()
    cs = tpt.build_clusters(tscene)
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="float32"):
        tck.intersect_clusters(o.double(), o.double(), cs)
    with pytest.raises(ValueError, match="shape"):
        tck.intersect_clusters(o, torch.zeros((4, 2)), cs)


@pytest.mark.parametrize("max_tris", [16, 64])
def test_intersect_tree_matches_jax(max_tris):
    """The plain walk of the cluster set's box tree, the cluster kernel's
    traversal, against the JAX package's brute intersection and its
    cluster kernel in interpret mode, on the rays of tests/test_clusters.py
    mapped to scene triangle ids."""
    from pathtracer_tpu_torch.ops import intersect as tisect
    jscene, tscene = SCENES["sphere10x20"]()
    jcs = jpt.build_clusters(jscene, max_tris=max_tris)
    tcs = tpt.build_clusters(tscene, max_tris=max_tris)
    ro, rd = _random_rays(50, 450, 700, seed=3)
    t_b, tid_b = jisect.intersect_brute(ro, rd, jscene.v1, jscene.v2,
                                        jscene.v3)
    t_k, tid_k = jck.intersect_clusters(ro, rd, jcs, interpret=True)
    t, row = tisect.intersect_tree(torch.from_numpy(ro), torch.from_numpy(rd),
                                   tcs.tree, tcs.tree_depth, tcs.start,
                                   tcs.count, tcs.tri_data)
    tid = torch.where(row >= 0, tcs.tid_map[row.clamp_min(0)], -1).int()
    assert int((tid >= 0).sum()) > 300
    assert_hits_match(t, tid, t_b, tid_b)
    assert_hits_match(t, tid, t_k, tid_k)


def test_scene_fields_survive_build():
    """Building the cluster set leaves the scene's arrays as they were."""
    _, tscene = SCENES["sphere8x12"]()
    before = [as_np(getattr(tscene, f)).copy() for f in SCENE_FIELDS]
    tpt.build_clusters(tscene)
    tpt.build_beam_accel(tscene)
    for f, b in zip(SCENE_FIELDS, before):
        np.testing.assert_array_equal(as_np(getattr(tscene, f)), b)
