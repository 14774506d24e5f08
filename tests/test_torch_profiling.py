"""The port's spans (``utils/profiling.trace_annotation``) on the CPU: a
shared no-op without a profiler; under ``torch.profiler`` the ``pt.*``
spans of a render and of a recovery step, where the work they name
happens, and their counts (a cache hit builds, copies and hashes
nothing)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch import inverse as tinv
from pathtracer_tpu_torch.ops.cuda import beam_kernel as tbk
from pathtracer_tpu_torch.utils import profiling


def _spans(prof):
    """The ``pt.*`` spans of a profile: (name, start, end), by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("pt.")),
                  key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def _lit_sphere():
    """A 48-triangle sphere in a box, the ceiling light in view."""
    _, sb = tpt.meshes.sphere_in_box(4, 6, device="cpu")
    cam = tpt.make_camera((250, 250, -420), (0, 0.35, 1), (0, 1, 0),
                          (16, 16), 60 * tpt.DEG2RAD, 1.0, device="cpu")
    return cam, sb.build(device="cpu")


def _beam(cam, scene):
    return lambda: tpt.render_film(cam, scene, 1, 1, backend="beam")


def test_span_is_a_shared_noop_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    assert not torch.autograd._profiler_enabled()
    span = profiling.trace_annotation("pt.off")
    assert span is profiling.trace_annotation("pt.other")
    with span:
        torch.ones(4).sum()
    assert calls == []


def test_span_records_under_a_profiler():
    def run():
        with profiling.trace_annotation("pt.on"):
            torch.ones(4).sum()
    assert [s[0] for s in _profiled(run)] == ["pt.on"]


def test_render_film_span_holds_the_lookup_and_the_hash(monkeypatch):
    monkeypatch.setattr(tbk, "_ACCEL_CACHE", [])
    cam, scene = _lit_sphere()
    spans = _profiled(_beam(cam, scene))
    (film,) = _named(spans, "pt.render_film")
    (lookup,) = _named(spans, "pt.accel.lookup")
    (hashed,) = _named(spans, "pt.scene.hash")
    assert _inside(lookup, film) and _inside(hashed, lookup)
    (built,) = _named(spans, "pt.accel.build")
    assert _inside(built, lookup) and built[1] >= hashed[2]


def test_a_second_render_builds_and_copies_nothing(monkeypatch):
    monkeypatch.setattr(tbk, "_ACCEL_CACHE", [])
    cam, scene = _lit_sphere()
    _beam(cam, scene)()
    spans = _profiled(_beam(cam, scene))
    # The unedited scene's key is memoised: the lookup hashes nothing.
    assert len(_named(spans, "pt.accel.lookup")) == 1
    assert _named(spans, "pt.scene.hash") == []
    assert _named(spans, "pt.accel.build") == []
    assert _named(spans, "pt.scene.host_copy") == []


def test_an_edit_copies_the_vertex_group_and_builds_once(monkeypatch):
    monkeypatch.setattr(tbk, "_ACCEL_CACHE", [])
    cam, scene = _lit_sphere()
    _beam(cam, scene)()
    materials = scene._host_m
    scene.v1[0] += 0.5
    spans = _profiled(_beam(cam, scene))
    assert len(_named(spans, "pt.scene.host_copy")) == 1
    assert len(_named(spans, "pt.accel.build")) == 1
    assert scene._host_m is materials
    assert float(scene._host_v[0][0, 0]) == float(scene.v1[0, 0])


def _specular():
    return tpt.modified_cornell(0.3, res=(8, 8), device="cpu")


STEP_CASES = {   # scene, groups optimised, whether SPSA runs
    "cornell": (lambda: tpt.cornell_box(res=(8, 8), device="cpu"),
                ("albedo", "emit"), False),
    "specular": (_specular, ("albedo", "emit"), False),
    "specular_roughness": (_specular, ("albedo", "emit", "roughness"), True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_spans_in_order(case):
    make, optimize, spsa = STEP_CASES[case]
    cam, scene = make()
    target = torch.zeros((8, 8, 3))
    spans = _profiled(lambda: tinv.recover_materials(
        cam, scene, target, steps=1, samples=2, depth=2,
        optimize=optimize))
    (step,) = _named(spans, "pt.train_step")
    inner = [s for s in spans if s[0].startswith("pt.step.")]
    assert all(_inside(s, step) for s in inner)
    want = ["pt.step.forward", "pt.step.backward", "pt.step.update",
            "pt.step.sync"]
    if spsa:
        want.insert(2, "pt.step.spsa")
    assert [s[0] for s in inner] == want
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
