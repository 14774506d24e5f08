"""The frozen work counts equal the port's own at small sizes."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.counts import beam_layout, work  # noqa: E402
from benchmark.reference import scenes  # noqa: E402
from benchmark.reference.beam import BeamTracer  # noqa: E402
from benchmark.reference.render import PixelTracer  # noqa: E402

from pathtracer_tpu_torch import bvh, clusters  # noqa: E402
from pathtracer_tpu_torch.camera import make_camera  # noqa: E402
from pathtracer_tpu_torch.ops import intersect  # noqa: E402
from pathtracer_tpu_torch.ops.cuda import beam_kernel  # noqa: E402
from pathtracer_tpu_torch.ops.cuda import trace_kernel  # noqa: E402
from pathtracer_tpu_torch.scene import Scene  # noqa: E402

CPU = torch.device("cpu")
SEED = 77


def setup(name, res, **scene):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["scene"].update(scene)
    arrays = scenes.make_scene(cfg)
    return (arrays, scenes.make_camera(cfg, res),
            make_camera(**scenes.camera_args(cfg, res), device="cpu"),
            Scene.from_arrays(*arrays.as_args(), device="cpu"))


def test_operation_constants_are_the_ports():
    assert work.PLUCKER_OPS == intersect.PLUCKER_OPS
    assert work.PLUCKER_PRIMARY_OPS == intersect.PLUCKER_PRIMARY_OPS
    assert work.MOMENT_OPS == intersect.MOMENT_OPS
    assert work.SLAB_OPS == intersect.SLAB_OPS
    assert work.SHADE_OPS == trace_kernel.SHADE_OPS
    assert work.CAMERA_OPS == trace_kernel.CAMERA_OPS


def test_trace_ops_and_live_segments_equal_the_ports():
    res = (12, 10)
    arrays, cam_ref, cam, scene = setup("cornell_box", res)
    live = trace_kernel.count_live_segments(cam, scene, 0, 6, 5, seed=SEED)
    pix = torch.arange(res[0] * res[1])
    sidx = torch.arange(6)
    lengths = PixelTracer(arrays, cam_ref, CPU).path_lengths(
        (pix % res[0])[None], (pix // res[0])[None], sidx[:, None], 5, SEED)
    assert int(lengths.sum()) == live
    paths = res[0] * res[1] * 6
    assert work.trace_ops(arrays.num_tris, live, paths) == \
        trace_kernel.count_ops(scene, live, paths)


def test_path_sample_is_seeded_and_in_range():
    a = work.sample(np.random.default_rng(3), 20, 10, 64, 500)
    b = work.sample(np.random.default_rng(3), 20, 10, 64, 500)
    for x, y, hi in zip(a, b, (20, 10, 64)):
        assert np.array_equal(x, y) and x.min() >= 0 and x.max() < hi


def layouts(arrays, scene):
    """The frozen layout and the port's beam accel of one scene, over the
    port's numpy BVH builder (its native builder splits some ties
    another way)."""
    n = arrays.num_tris
    mine = beam_layout.build(arrays.v1[:n], arrays.v2[:n], arrays.v3[:n])
    return mine, clusters.build_beam_accel(
        scene, bvh.build_bvh(scene, use_native=False))


@pytest.mark.parametrize("max_sc", [None, 3])
def test_beam_layout_is_the_ports(max_sc, monkeypatch):
    """Box for box; ``max_sc`` 3 makes both double their supercluster cut
    size."""
    if max_sc is not None:
        monkeypatch.setattr(beam_layout, "MAX_SC", max_sc)
        monkeypatch.setattr(clusters, "MAX_BEAM_SC", max_sc)
    arrays, _, _, scene = setup("garden105708", (8, 8), grid=2, n_lat=6,
                                n_lon=8)
    mine, accel = layouts(arrays, scene)
    S, C = accel.num_superclusters, accel.num_clusters
    assert max_sc is None or S <= max_sc
    assert np.array_equal(mine.sc_ncl, accel.sc_ncl.numpy())
    assert np.array_equal(mine.sc_bounds, accel.sc_bounds[:S, :6].numpy())
    assert np.array_equal(mine.cl_bounds, accel.cl_bounds[:C, :6].numpy())
    tid_map = accel.tid_map.long()
    rows = torch.nonzero(tid_map >= 0).squeeze(1)
    assert np.array_equal(mine.cluster_of_tri[tid_map[rows].numpy()],
                          (rows // accel.ctris).numpy())


def test_beam_work_equals_the_ports(monkeypatch):
    res = (64, 64)
    arrays, cam_ref, cam, scene = setup("garden105708", res, grid=2,
                                        n_lat=6, n_lon=8)
    mine, accel = layouts(arrays, scene)
    monkeypatch.setattr(beam_kernel, "_accel_for", lambda scene: accel)
    want = beam_kernel.count_work(cam, scene, 0, 2, 3, seed=SEED)
    tracer = BeamTracer(arrays, cam_ref, CPU)
    pix = torch.arange(res[0] * res[1])
    segs = []
    for s in range(2):
        segs += tracer.segments(pix % res[0], pix // res[0], s, 3, SEED)
    got = work.beam_work(segs, mine)
    assert want["live_segments"] > 0
    assert got == want
