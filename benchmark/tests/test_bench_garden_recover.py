"""The garden recovery cell on the CPU at a small size: the driver's
set-up, a window of two steps and the check, sound and with faults; its
work count scaled to the window; and its four readers over synthetic
traces, None where the span or the kernel is absent."""

import dataclasses
import json
import math
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.drivers import recover_mesh  # noqa: E402
from benchmark.harness import core, peaks  # noqa: E402
from benchmark.harness import trace as tr  # noqa: E402
from benchmark.reference import compare  # noqa: E402

CELL = "garden_recover"
SEED = 2**33 + 41
H100 = "NVIDIA H100 80GB HBM3"


def small(drawn_within=2):
    ctx = core.context(CELL, SEED, 0.0, False, time.perf_counter(),
                       device="cpu")
    t, w = dict(ctx.traffic), json.loads(json.dumps(ctx.workload))
    c = json.loads(json.dumps(ctx.config))
    t.update(width=16, height=16, samples=4, target_samples=8, depth=3)
    c["scene"].update(grid=2, n_lat=6, n_lon=8)
    w["check"].update(drawn_within=drawn_within, count_paths=256)
    return dataclasses.replace(ctx, traffic=t, workload=w, config=c)


def window_of(ctx, steps=2):
    """Set-up, ``steps`` window steps and the check: the verdict."""
    cell = recover_mesh.MeshRecoverCell(ctx)
    cell.warmup()
    for i in range(steps):
        cell.request(i)
    cell.release()
    return compare.verdict(cell.check(steps), ctx.workload["limits"])


def test_sound_run_is_correct_and_follows_the_drawn_steps():
    ctx = small()
    v = window_of(ctx)
    assert v["correct"], v["checks"]
    assert set(v["checks"]) == {"loss_gap", "grad_gap", "update_gap",
                                "drawn_loss_gap", "drawn_update_gap"}


def test_a_drawn_step_the_window_missed_fails():
    v = window_of(small(drawn_within=20), steps=0)
    assert not v["correct"]
    assert v["checks"]["drawn_loss_gap"]["value"] == math.inf


def no_step(self, closure=None):
    return None


def test_frozen_optimizer_fails(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", no_step)
    v = window_of(small())
    assert not v["correct"]
    assert v["checks"]["update_gap"]["value"] == pytest.approx(1.0)
    assert v["checks"]["drawn_update_gap"]["value"] == pytest.approx(1.0)


def test_work_count_scales_a_sample_to_the_window(monkeypatch):
    """With every sampled step's count fixed, the count is that count
    per sampled path times the window's paths; the segments counted are
    live ones, at most ``depth`` a path."""
    ctx = small()
    cell = recover_mesh.MeshRecoverCell(ctx)
    seen = []

    def fixed(segments, layout):
        seen.append(sum(s[0].shape[0] for s in segments))
        return {"ops": 1000}
    monkeypatch.setattr(recover_mesh.counts, "beam_work", fixed)
    paths = 16 * 16 * 4
    for n in (1, 3, 12):
        seen.clear()
        work = cell.trace_work(n)["cluster_kernel"]
        steps = min(n, 8)
        per_step = 256 // steps
        assert len(seen) == steps
        assert work == pytest.approx(1000 * n * paths / per_step)
        assert all(0 < s <= per_step * 3 for s in seen)


def rank(kernels, spans, requests, window=(0.0, 1000.0), other=()):
    bench = [("bench.window",) + window] + [("bench.request", a, b)
                                            for a, b in requests]
    device = list(kernels) + list(other)
    return tr.RankTrace(device, list(kernels), bench + list(spans),
                        bench + list(spans))


def layer(name, traced):
    return core.reader("metrics", name).read(traced)


KERNELS = [("void cluster_kernel<true>(float const*)", 100.0, 300.0),
           ("void cluster_kernel<true>(float const*)", 600.0, 700.0),
           ("elementwise", 250.0, 400.0), ("index_add", 800.0, 900.0)]
SPANS = [("pt.diff.render", 10.0, 210.0), ("pt.diff.render", 220.0, 420.0),
         ("pt.diff.render", 510.0, 610.0), ("pt.diff.render", 620.0, 720.0),
         ("pt.diff.render", -300.0, -100.0)]       # the warm-up's


def test_the_four_readers():
    ops = peaks.fp32_flops(H100) * 300e-6 * 0.02
    t = tr.TraceRun([rank(KERNELS, SPANS, [(0, 500), (500, 1000)])], 2,
                    {"cluster_kernel": ops}, H100)
    assert layer("cluster_kernel_roofline.garden_recover", t) == \
        pytest.approx(2.0)
    assert layer("cluster_share.garden_recover", t) == pytest.approx(
        100.0 * 300 / 500)
    assert layer("render_host_ms.garden_recover", t) == pytest.approx(
        (200 + 200 + 100 + 100) / 2 / 1e3)
    assert layer("device_idle.garden_recover", t) == pytest.approx(50.0)


def test_readers_find_nothing_without_the_kernel_or_the_span():
    others = [k for k in KERNELS if "cluster" not in k[0]]
    t = tr.TraceRun([rank(others, [], [(0, 1000)])], 1,
                    {"cluster_kernel": 1e9}, H100)
    assert layer("cluster_kernel_roofline.garden_recover", t) is None
    assert layer("cluster_share.garden_recover", t) is None
    assert layer("render_host_ms.garden_recover", t) is None
    t = tr.TraceRun([rank(KERNELS, SPANS, [(0, 1000)])], 1, {}, H100)
    assert layer("cluster_kernel_roofline.garden_recover", t) is None


def test_control_and_half_batch_fail_the_check_at_a_small_size():
    from benchmark import control_recover_mesh
    ctx = small()
    limits = ctx.workload["limits"]
    out = control_recover_mesh.readings(ctx, torch.device("cpu"))
    for kind in ("bfloat16", "half_batch"):
        assert set(out[kind]) == set(limits)
        assert any(out[kind][n] > limits[n] for n in limits), (kind, out)
