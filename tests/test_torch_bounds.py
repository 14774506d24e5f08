"""The work counts behind the kernels' bounds, on the CPU.

``chip_smoke.py`` divides these operation counts by the card's fp32 rate
to give each kernel's least time; here they are held to what they count on
small scenes: the boxes a front-to-back traversal must open, the rows of
the clusters it enters before the nearest hit, the live segments.
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
    _, scene = _sphere()
    cs = tpt.build_clusters(scene, max_tris=16)
    gen = np.random.default_rng(4)
    o = torch.from_numpy(gen.uniform(50, 450, (512, 3)).astype(np.float32))
    d = torch.from_numpy(gen.normal(size=(512, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    t, tid = tck.intersect_clusters_reference(o, d, cs)
    work = tck.count_work(o, d, cs, t)
    assert work["box_tests"] == 512 * cs.num_clusters
    # Every hit ray opens at least the cluster of its hit; no ray opens
    # more rows than the set holds.
    assert int((tid >= 0).sum()) <= work["rows"]
    assert work["rows"] < 512 * int(cs.count.sum())
    assert work["ops"] == (work["box_tests"] * tisect.SLAB_OPS
                           + work["rows"] * tisect.MT_OPS + 3 * 512)


def test_beam_work_counts_live_segments():
    cam, scene = _sphere()
    accel = tbk._accel_for(scene)
    work = tbk.count_work(cam, scene, 0, 1, 3)
    wp, hp = tbk._padded_res(16, 16)   # the kernel traces the padded film
    pixels = wp * hp
    assert pixels <= work["live_segments"] <= 3 * pixels
    assert work["sc_box_tests"] == (work["live_segments"]
                                    * accel.num_superclusters)
    assert 0 < work["cluster_box_tests"]
    assert 0 < work["rows"] <= (work["live_segments"] * accel.num_clusters
                                * accel.ctris)


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
