"""The realtime cell: its data files, its two span readers over synthetic
traces, the plain viewer's blend and grouped intersection test, and whole
runs on the CPU at a small size, sound and with the program broken
underneath, and the bfloat16 control."""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import control_realtime  # noqa: E402
from benchmark.harness import core  # noqa: E402
from benchmark.harness import trace as tr  # noqa: E402
from benchmark.reference import realtime as ref  # noqa: E402
from benchmark.reference import scenes  # noqa: E402
from benchmark.reference.beam import BeamTracer  # noqa: E402
from benchmark.reference.render import mt_intersector  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
CELL = "garden_realtime"
SEED = 2**31 + 29


def layer(name, traced):
    return core.reader("metrics", name).read(traced)


def traced(spans, requests, kernels=(), window=(0.0, 10000.0)):
    bench = [("bench.window",) + window] + [("bench.request", a, b)
                                            for a, b in requests]
    r = tr.RankTrace(list(kernels), list(kernels), bench + list(spans),
                     bench + list(spans))
    return tr.TraceRun([r], len(requests), {}, H100)


FRAMES = [(0.0, 5000.0), (5000.0, 10000.0)]
STEPS = [("pt.realtime.step", 10.0, 4000.0),
         ("pt.realtime.step", 5010.0, 9500.0)]
BEAM = [("beam_kernel<0,0>", 500.0, 3000.0),
        ("beam_kernel<0,0>", 5500.0, 8500.0)]
# Each frame's display copy; the first frame's render took two launches.
DEVICE = BEAM + [("beam_kernel<0,0>", 3000.0, 3400.0),
                 ("Memcpy DtoH (Device -> Pageable)", 3900.0, 4000.0),
                 ("Memcpy DtoH (Device -> Pageable)", 9200.0, 9300.0)]


def test_tail_is_last_kernel_end_to_the_copy_end():
    """On the device's clock alone: a host clock a millisecond off the
    device's moves nothing."""
    t = traced(STEPS, FRAMES, DEVICE)
    assert layer("tail_ms.realtime", t) == pytest.approx((0.6 + 0.8) / 2)
    shifted = [(n, a - 1000.0, b - 1000.0) for n, a, b in DEVICE]
    t = traced(STEPS, FRAMES, shifted)
    assert layer("tail_ms.realtime", t) == pytest.approx((0.6 + 0.8) / 2)


def test_resets_count_over_frames():
    resets = [("pt.realtime.reset", -50.0, -40.0),      # the warm-up's
              ("pt.realtime.reset", 4800.0, 4801.0)]
    t = traced(STEPS + resets, FRAMES, BEAM)
    assert layer("resets.realtime", t) == 0.5


@pytest.mark.parametrize("name", ["tail_ms.realtime", "resets.realtime"])
def test_readers_none_without_steps(name):
    assert layer(name, traced([], FRAMES, DEVICE)) is None


def test_resets_zero_without_a_reset():
    assert layer("resets.realtime", traced(STEPS, FRAMES, BEAM)) == 0


def test_the_data_files_load():
    b = core.benchmark_file()
    ctx = core.context(CELL, 1, 1.0, False, 0.0)
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "garden105708.json")) as f:
        garden = json.load(f)
    assert ctx.config["scene"] == garden["scene"]
    assert ctx.config["camera"] == garden["camera"]
    assert ctx.traffic["frame_samples"] * ctx.traffic["depth"] == 75
    assert ctx.workload["chips"] == 1 and ctx.workload["limits"]
    assert core.driver(ctx.workload["driver"]).run
    (cell,) = [w for w in b["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"]) == (ctx.workload["config"],
                                                 ctx.workload["traffic"])
    e2e = [m["name"] for m in b["end_to_end"] if core.applies(m, CELL)]
    assert e2e == ["rays_per_s.mesh", "latency_p95_ms", "setup_s"]
    layers = [m["name"] for m in b["per_layer"] if core.applies(m, CELL)]
    assert layers == ["beam_kernel_roofline.realtime", "device_idle.realtime",
                      "tail_ms.realtime", "resets.realtime"]
    for name in layers:
        assert core.reader("metrics", name).read


def test_blend_is_the_float32_running_mean():
    """The viewer's blend is ``acc * (1 - t) + cur * t`` in float32, within
    a few roundings of the mean of the frames."""
    g = torch.Generator().manual_seed(3)
    films = [torch.rand(64, 3, generator=g) for _ in range(9)]
    acc = torch.zeros(64, 3)
    for k, cur in enumerate(films):
        acc = acc * np.float32(1.0 - 1.0 / (k + 1)) \
            + cur * np.float32(1.0 / (k + 1))
    blended = ref.blend(films)
    assert blended.dtype == torch.float32
    assert torch.equal(blended, acc)
    mean = torch.stack([f.double() for f in films]).mean(0)
    assert torch.allclose(blended.double(), mean, rtol=0, atol=1e-6)


def small_config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "garden105708_realtime.json")) as f:
        cfg = json.load(f)
    cfg["scene"].update(grid=2, n_lat=6, n_lon=8)
    return cfg


def test_grouped_test_equals_the_dense_test():
    """Rays from every corner of the room, and the camera's own rays:
    nearest distances and triangles bit for bit."""
    arrays = scenes.make_scene(small_config())
    cpu = torch.device("cpu")
    dense = mt_intersector(arrays, cpu)
    grouped = ref.grouped_intersector(arrays, cpu, group=7)
    g = torch.Generator().manual_seed(5)
    o = torch.rand(4000, 3, generator=g) * 520.0 - 10.0
    d = torch.randn(4000, 3, generator=g)
    d[::7, 0] = 0.0                     # rays along a box's face
    d = d / d.norm(dim=-1, keepdim=True)
    for rays in ((o, d), (torch.tensor([[250.0, 330.0, -420.0]]).expand(
            4000, 3), d.abs() * torch.tensor([0.4, -0.3, 1.0]))):
        t_d, id_d = dense(*rays)
        t_g, id_g = grouped(*rays)
        assert torch.equal(id_d, id_g) and torch.equal(t_d, t_g)
        assert int((id_d >= 0).sum()) > 1000


def test_sample_tracer_equals_the_beam_reference():
    """A launch's samples traced in one pass, and with the grouped test:
    the beam reference's film and path segments bit for bit."""
    cfg = small_config()
    arrays = scenes.make_scene(cfg)
    cam = ref.camera_after(scenes.make_camera(cfg, (48, 40)), ["left", "w"])
    cpu = torch.device("cpu")
    pix = torch.arange(0, 48 * 40, 3)
    w, h = pix % 48, pix // 48
    want = BeamTracer(arrays, cam, cpu).film(w, h, 5, 3, SEED, 2)
    batched = ref.SampleBeamTracer(arrays, cam, cpu)
    assert torch.equal(batched.film(w, h, 5, 3, SEED, 2), want)
    batched.intersect = ref.grouped_intersector(arrays, cpu)
    assert torch.equal(batched.film(w, h, 5, 3, SEED, 2), want)
    assert float(want.max()) > 0.0
    segs = [BeamTracer(arrays, cam, cpu).segments(w, h, 4, 3, SEED),
            batched.segments(w, h, 4, 3, SEED)]
    assert len(segs[0]) == len(segs[1])
    for a, b in zip(*segs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def small(seed=SEED, seconds=0.4):
    ctx = core.context(CELL, seed, seconds, False, time.perf_counter(),
                       device="cpu")
    t = dict(ctx.traffic, width=32, height=32, frame_samples=2, depth=2,
             backend="beam", key_every=3)
    w = json.loads(json.dumps(ctx.workload))
    w["check"].update(launch_spp=2, pixels=64)
    return dataclasses.replace(ctx, traffic=t, workload=w,
                               config=small_config())


def test_realtime_cell_sound_and_broken():
    run = core.driver("realtime").run
    sound = run(small())
    assert sound.correct, sound.checks
    assert sound.checks["film_gap"]["value"] == 0.0
    for fault in ("half_samples", "no_reset"):
        with control_realtime.broken(fault):
            broken = run(small())
        assert not broken.correct, (fault, broken.checks)


def test_control_fails_at_a_small_size():
    ctx = small()
    gap = control_realtime.control_reading(ctx, torch.device("cpu"),
                                           frames=6)
    assert gap > ctx.workload["limits"]["film_gap"]
