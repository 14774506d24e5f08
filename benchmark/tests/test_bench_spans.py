"""The readers of the program's own spans (``pt.*``, source
``program_span``) over synthetic traces: their values, None where the
window holds no span of their family (a program without spans), and 0
where the family is there and the counted span is not."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import core  # noqa: E402
from benchmark.harness import trace as tr  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def layer(name, traced):
    return core.reader("metrics", name).read(traced)


def traced(spans, requests, kernels=(), window=(0.0, 10000.0)):
    """One rank's window: the benchmark's spans, the program's ``spans``
    and ``kernels``."""
    bench = [("bench.window",) + window] + [("bench.request", a, b)
                                            for a, b in requests]
    r = tr.RankTrace(list(kernels), list(kernels), bench + list(spans),
                     bench + list(spans))
    return tr.TraceRun([r], len(requests), {}, H100)


GARDEN = [(0.0, 5000.0), (5000.0, 10000.0)]


def garden_spans(hashes):
    return [("pt.render_film", 0.0, 4000.0),
            ("pt.render_film", 5000.0, 9000.0)] + hashes


def test_scene_hash_time_and_count():
    hashes = [("pt.scene.hash", 100.0, 900.0),
              ("pt.scene.hash", 1000.0, 1800.0),
              ("pt.scene.hash", 5100.0, 5700.0),
              ("pt.scene.hash", 5500.0, 6100.0)]   # overlaps: one union
    t = traced(garden_spans(hashes), GARDEN)
    assert layer("scene_hash_ms.garden", t) == pytest.approx(
        (0.8 + 0.8 + 1.0) / 2)
    assert layer("scene_hashes.garden", t) == 2.0


def test_scene_hash_outside_the_window_is_not_counted():
    hashes = [("pt.scene.hash", -900.0, -100.0),   # the warm-up's
              ("pt.scene.hash", 100.0, 900.0)]
    t = traced(garden_spans(hashes), GARDEN)
    assert layer("scene_hashes.garden", t) == 0.5
    assert layer("scene_hash_ms.garden", t) == pytest.approx(0.4)


@pytest.mark.parametrize("name", ["scene_hash_ms.garden",
                                  "scene_hashes.garden"])
def test_scene_hash_readers_none_without_spans_zero_without_hashes(name):
    assert layer(name, traced([], GARDEN)) is None
    assert layer(name, traced(garden_spans([]), GARDEN)) == 0


TRACE = [("trace_kernel<0>", 100.0 + 10 * i, 105.0 + 10 * i)
         for i in range(4)]


def test_launch_host_us_is_loop_time_over_launches():
    loops = [("pt.trace.launches", 50.0, 70.0),
             ("pt.trace.launches", 5050.0, 5070.0)]
    kernels = TRACE + [("trace_kernel<0>", 5100.0, 5105.0)]
    t = traced(loops, GARDEN, kernels)
    assert layer("launch_host_us.cornell", t) == pytest.approx(40.0 / 5)


def test_launch_host_us_none_without_its_span_or_kernels():
    assert layer("launch_host_us.cornell", traced([], GARDEN, TRACE)) is None
    loop = [("pt.trace.launches", 50.0, 50.0)]
    assert layer("launch_host_us.cornell", traced(loop, GARDEN, TRACE)) == 0
    assert layer("launch_host_us.cornell", traced(loop, GARDEN)) is None


def step(start, sync):
    """A 4-ms step whose last ``sync`` ms wait for the device."""
    end = start + 4000.0
    return [("pt.train_step", start, end),
            ("pt.step.forward", start, start + 1000.0),
            ("pt.step.sync", end - sync * 1e3, end)]


def test_host_ms_is_step_less_sync():
    t = traced(step(0.0, 3.0) + step(5000.0, 2.5), GARDEN)
    assert layer("host_ms.recover", t) == pytest.approx((1.0 + 1.5) / 2)


def test_host_ms_none_without_steps_zero_when_all_sync():
    assert layer("host_ms.recover", traced([], GARDEN)) is None
    t = traced(step(0.0, 4.0), [(0.0, 5000.0)])
    assert layer("host_ms.recover", t) == 0


def test_breakdown_names_a_gap_by_the_innermost_span():
    """A gap is named by the latest-starting host interval over its middle:
    the program's innermost span there."""
    spans = garden_spans([("pt.accel.lookup", 100.0, 3000.0),
                          ("pt.scene.hash", 200.0, 2900.0)])
    t = traced(spans, GARDEN, [("beam_kernel<0,0>", 3100.0, 4000.0),
                               ("beam_kernel<0,0>", 4000.0, 10000.0)])
    assert t.breakdown()["idle_gaps"][0] == ["pt.scene.hash", 3.1e-3]
