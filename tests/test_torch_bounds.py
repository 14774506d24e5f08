"""The work counts behind the kernels' bounds, on the CPU.

Divided by the card's fp32 rate, these operation counts gave each kernel's
least time in the card runs recorded in PERF.md's kernel table; here they
are held to what they count on
small scenes: the boxes any exact traversal must open (those entered
before the nearest hit, and the ones that hold it), the rows of the
clusters so opened, the live segments.
"""

import numpy as np
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.ops import intersect as tisect
from pathtracer_tpu_torch.ops.cuda import beam_kernel as tbk
from pathtracer_tpu_torch.ops.cuda import cluster_kernel as tck
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

from _torch_parity import scene_pair


def _sphere(res=(16, 16), n_lat=6, n_lon=8):
    _, sb = tpt.meshes.sphere_in_box(n_lat, n_lon, device="cpu")
    cam = tpt.make_camera((250, 250, -420), (0, 0.35, 1), (0, 1, 0), res,
                          60 * tpt.DEG2RAD, 1.0, device="cpu")
    return cam, sb.build(device="cpu")


def test_boxes_entered_stops_at_the_hit():
    bounds = torch.tensor([[0, 0, 0, 1, 1, 1, 0, 0],
                           [2, 0, 0, 3, 1, 1, 0, 0],
                           [0, 2, 0, 1, 3, 1, 0, 0]], dtype=torch.float32)
    o = torch.tensor([[-1.0, 0.5, 0.5]] * 2)
    d = torch.tensor([[1.0, 1e-9, 1e-9]] * 2)
    t_hit = torch.tensor([10.0, 2.5])
    got = tisect.boxes_entered(o, 1.0 / d, t_hit, bounds)
    assert got.tolist() == [[True, True, False], [True, False, False]]


def test_cluster_work_counts_the_entered_clusters():
    """Each hit ray opens at least the cluster of its hit, with its rows;
    no ray opens more boxes than a loop over every cluster box tests."""
    _, scene = _sphere()
    cs = tpt.build_clusters(scene, max_tris=16)
    gen = np.random.default_rng(4)
    o = torch.from_numpy(gen.uniform(50, 450, (512, 3)).astype(np.float32))
    d = torch.from_numpy(gen.normal(size=(512, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    t, tid = tck.intersect_clusters_reference(o, d, cs)
    work = tck.count_work(o, d, cs, t, tid)
    hits = int((tid >= 0).sum())
    assert hits > 100
    assert hits <= work["box_tests"] < 512 * cs.num_clusters
    assert hits * int(cs.count.min()) <= work["rows"]
    assert work["rows"] < 512 * int(cs.count.sum())
    assert work["ops"] == (work["box_tests"] * tisect.SLAB_OPS
                           + work["rows"] * tisect.PLUCKER_OPS
                           + 512 * (tisect.MOMENT_OPS + 3))
    # One ray at a time: each hit counts its own cluster and its rows.
    start, count = cs.start.long(), cs.count.long()
    row_of = torch.empty_like(cs.tid_map, dtype=torch.int64)
    row_of[cs.tid_map[:scene.num_tris].long()] = torch.arange(scene.num_tris)
    for r in torch.nonzero(tid >= 0).squeeze(1)[:32].tolist():
        one = tck.count_work(o[r:r + 1], d[r:r + 1], cs, t[r:r + 1],
                             tid[r:r + 1])
        c = int(torch.searchsorted(start, row_of[int(tid[r])],
                                   right=True)) - 1
        assert one["box_tests"] >= 1 and one["rows"] >= int(count[c])


def test_hit_on_a_flat_box_counts_its_cluster():
    """A floor quad's cluster box is flat, and the hit lies on its face: the
    slab test enters it no earlier than the hit, so only the rule that
    counts the hit's own cluster opens it."""
    sb = tpt.SceneBuilder()
    sb.add_quad(((0, 0, 0), (10, 0, 0), (10, 0, 10), (0, 0, 10)),
                tpt.Diffuse(0.5))
    scene = sb.build(device="cpu")
    cs = tpt.build_clusters(scene)
    o = torch.tensor([[3.0, 5.0, 4.0], [6.0, 2.0, 7.0]])
    d = torch.tensor([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])
    t, tid = tck.intersect_clusters_reference(o, d, cs)
    assert bool((tid >= 0).all())
    entered = tisect.boxes_entered(o, 1.0 / d, t, cs.bounds)
    assert not bool(entered.any())          # strictly before the hit: none
    work = tck.count_work(o, d, cs, t, tid)
    assert work["box_tests"] == 2 and work["rows"] == 2 * 2


def test_beam_work_counts_live_segments():
    """Every hit segment counts at least one supercluster, one cluster and
    its rows; no segment more boxes than the loops over every supercluster
    box and over the cluster boxes of each supercluster entered."""
    cam, scene = _sphere()
    accel = tbk._accel_for(scene)
    work = tbk.count_work(cam, scene, 0, 1, 3)
    segments = []
    tbk.render_tiles_beam_reference(cam, scene, 0, 1, 3, accel=accel,
                                    segments=segments)
    live = work["live_segments"]
    hits = sum(int((row >= 0).sum()) for *_, row in segments)
    wp, hp = tbk._padded_res(16, 16)   # the kernel traces the padded film
    pixels = wp * hp
    assert pixels <= live <= 3 * pixels
    assert live == sum(o.shape[0] for o, *_ in segments) and hits > 0
    S = accel.num_superclusters
    flat_cl = 0
    for o, d, t, _ in segments:
        sc_in = tisect.boxes_entered(o, 1.0 / d, t, accel.sc_bounds[:S])
        flat_cl += int((sc_in.long() * accel.sc_ncl.long()).sum())
    assert hits <= work["sc_box_tests"] <= live * S
    assert hits <= work["cluster_box_tests"] <= flat_cl + hits * int(
        accel.sc_ncl.max())
    assert work["rows"] == work["cluster_box_tests"] * accel.ctris
    assert work["ops"] == (
        (work["sc_box_tests"] + work["cluster_box_tests"]) * tisect.SLAB_OPS
        + work["rows"] * tisect.PLUCKER_OPS
        + live * (tisect.MOMENT_OPS + ttk.SHADE_OPS + 3))


def test_trace_ops_count_every_triangle_per_live_segment():
    _, (cam, scene) = scene_pair("cornell", (8, 8))
    live = ttk.count_live_segments(cam, scene, 0, 2, 5)
    paths = 8 * 8 * 2
    ops = ttk.count_ops(scene, live, paths)
    later = live - paths
    assert ops == (paths * scene.num_tris * tisect.PLUCKER_PRIMARY_OPS
                   + later * (scene.num_tris * tisect.PLUCKER_OPS
                              + tisect.MOMENT_OPS)
                   + later * ttk.SHADE_OPS
                   + paths * ttk.CAMERA_OPS)
    assert later > 0
    # The cheaper test: below every live segment at Möller–Trumbore's count.
    assert ops < live * scene.num_tris * tisect.MT_OPS
