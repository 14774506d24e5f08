"""The harness's arithmetic: the end-to-end metrics over a window, and the
per-layer readers over a synthetic trace (microseconds on one clock)."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import core, peaks  # noqa: E402
from benchmark.harness import trace as tr  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def e2e(name, window):
    return core.reader("e2e", name).compute(window)


def layer(name, traced):
    return core.reader("metrics", name).read(traced)


def test_end_to_end_metrics():
    spans = [(10.0 + i, 10.5 + i) for i in range(40)]
    w = core.Window(3.25, spans, [2.0] * 40)
    assert e2e("rays_per_s", w) == pytest.approx(80.0 / 39.5)
    assert e2e("rays_per_s.mesh", w) == e2e("rays_per_s", w)
    assert e2e("step_s", w) == pytest.approx(39.5 / 40)
    assert e2e("latency_p95_ms", w) == pytest.approx(500.0)
    assert e2e("setup_s", w) == 3.25
    assert e2e("latency_p95_ms", core.Window(1.0, spans[:19], [1] * 19)) \
        is None


def rank(kernels, requests, window=(0.0, 1000.0), other=()):
    spans = [("bench.window",) + window] + [("bench.request", a, b)
                                            for a, b in requests]
    device = list(kernels) + list(other)
    return tr.RankTrace(device, list(kernels), spans,
                        spans + [("aten::copy_", 0.0, 1000.0)])


def test_union_and_idle_share():
    r = rank([("trace_kernel<1>", 0, 100), ("trace_kernel<1>", 50, 150),
              ("x", 300, 400)], [(0, 500)])
    assert tr.union_us(r.device) == 250
    t = tr.TraceRun([r], 1, {}, H100)
    assert t.idle_share() == pytest.approx(75.0)
    assert layer("device_idle.rays", t) == layer("device_idle.step", t)
    assert t.busy_s() == pytest.approx(250e-6)
    empty = tr.TraceRun([rank([], [(0, 10)])], 1, {}, H100)
    assert empty.idle_share() is None


def test_launch_gaps_within_jobs_only():
    k = [("trace_kernel<0>", 10, 20), ("trace_kernel<0>", 22, 30),
         ("trace_kernel<0>", 610, 620), ("trace_kernel<0>", 630, 640)]
    t = tr.TraceRun([rank(k, [(0, 500), (600, 900)])], 2, {}, H100)
    assert layer("launch_gap_us.cornell", t) == pytest.approx((2 + 10) / 2)


def test_prep_is_span_start_to_first_beam_kernel():
    k = [("beam_kernel<0,0>", 8000, 9000), ("beam_kernel<0,0>", 9100, 9500),
         ("beam_kernel<0,0>", 22000, 23000)]
    t = tr.TraceRun([rank(k, [(0, 10000), (10000, 30000)],
                          window=(0, 30000))], 2, {}, H100)
    assert layer("prep_ms.garden", t) == pytest.approx((8 + 12) / 2)


def test_rooflines_need_counts_and_a_known_card():
    k = [("trace_kernel<0>", 0, 1e6)]
    ops = peaks.fp32_flops(H100) * 0.25
    t = tr.TraceRun([rank(k, [(0, 1e6)], (0, 1e6))], 1,
                    {"trace_kernel": ops}, H100)
    assert layer("trace_kernel_roofline", t) == pytest.approx(25.0)
    assert layer("beam_kernel_roofline", t) is None
    t.kind = "some other card"
    assert layer("trace_kernel_roofline", t) is None


def test_kernels_per_step_gather_and_skew():
    k0 = [("elementwise", i, i + 1) for i in range(0, 600, 10)]
    nccl = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 700, 900),
            ("ncclDevKernel_Broadcast_RING_LL", 950, 990)]
    r0 = rank(k0 + nccl + [("trace_kernel<0>", 0, 400)], [(0, 500),
                                                          (500, 1000)])
    r1 = rank([("trace_kernel<0>", 0, 300)], [(0, 500), (500, 1000)])
    t = tr.TraceRun([r0, r1], 2, {}, H100)
    assert layer("kernels_per_step.recover", t) == pytest.approx(63 / 2)
    assert layer("gather_ms.sharded", t) == pytest.approx(0.1)
    assert layer("rank_skew.sharded", t) == pytest.approx(25.0)
    assert layer("rank_skew.sharded", tr.TraceRun([r0], 2, {}, H100)) is None


def test_breakdown_names_gaps_by_host_work():
    r = rank([("trace_kernel<0>", 0, 100), ("fill", 600, 700)], [(0, 1000)])
    r.host.append(("aten::zeros", 150, 550))
    b = tr.TraceRun([r], 1, {}, H100).breakdown()
    assert b["device_ops"][0] == ["trace_kernel<0>", 1e-4]
    assert b["idle_gaps"][0] == ["aten::zeros", 5e-4]
    assert len(b["idle_gaps"]) == 2


def test_chrome_trace_is_read(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 20,
         "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1,
         "dur": 2},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 3}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = tr.load_chrome(str(path))
    assert [k[0] for k in r.kernels] == ["k"] and len(r.device) == 2
    assert r.window() == (0.0, 100.0) and r.busy_us() == 10
