"""The port's realtime session (``realtime.RealtimeSession``) held against
the benchmark's plain viewer (``benchmark/reference/realtime.py``) on the
CPU: displayed films on the beam route through camera keys, the camera
after each key, and the session's spans."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.reference import realtime as ref  # noqa: E402
from benchmark.reference import scenes  # noqa: E402

from pathtracer_tpu_torch.camera import make_camera  # noqa: E402
from pathtracer_tpu_torch.realtime import RealtimeSession  # noqa: E402
from pathtracer_tpu_torch.scene import Scene  # noqa: E402

RES = (32, 32)
SEED = 2**31 + 7
CAMERA_KEYS = ["left", "right", "up", "down", "w", "s", "a", "d", "space",
               "z"]


def small_garden():
    """The realtime configuration's garden at grid 2: a few hundred
    triangles, the same room, light and camera."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "garden105708_realtime.json")) as f:
        cfg = json.load(f)
    cfg["scene"].update(grid=2, n_lat=6, n_lon=8)
    return cfg


def session(cfg, **kw):
    arrays = scenes.make_scene(cfg)
    camera = make_camera(**scenes.camera_args(cfg, RES), device="cpu")
    scene = Scene.from_arrays(*arrays.as_args(), device="cpu")
    return arrays, RealtimeSession(camera, scene, seed=SEED, **kw)


def test_displays_match_the_plain_viewer_through_keys():
    """Seven frames on the beam route (the plain version on the CPU), a
    turn before frame 3 and a move before frame 5: every displayed value of
    every frame equals the plain viewer's."""
    cfg = small_garden()
    arrays, s = session(cfg, depth=3, frame_samples=4, backend="beam")
    pix = torch.arange(RES[0] * RES[1])
    viewer = ref.Viewer(arrays, scenes.make_camera(cfg, RES),
                        torch.device("cpu"), pix % RES[0], pix // RES[0],
                        depth=3, frame_samples=4, seed=SEED, launch_spp=4)
    keys, k = [], 0
    for frame in range(7):
        key = {3: "left", 5: "w"}.get(frame)
        if key:
            s.key(key)
            keys.append(key)
            k = 0
        shown = s.step()
        want = viewer.display(keys, k).reshape(RES[1], RES[0], 3).numpy()
        # A tile's rays share their bounce directions: at 4 spp a few
        # percent of the pixels see the light.
        assert float((want > 0).mean()) > 0.02
        # Both sides give the same bits here today (the film, the keys'
        # float32 camera steps, the blend); the tolerance is one float32
        # rounding of the tone map's pow, which another build may change.
        np.testing.assert_allclose(shown, want, rtol=2e-7, atol=0)
        k += 1


@pytest.mark.parametrize("key", CAMERA_KEYS)
def test_camera_keys_match_the_plain_viewer(key):
    """The port's camera after a turn, a move and then ``key`` equals the
    plain viewer's.  Both give the same bits here today; the tolerance is
    a float32 rounding or two of the vectors, what another build's cos or
    vector norm may change."""
    cfg = small_garden()
    _, s = session(cfg)
    history = ["up", "a", key]
    for k in history:
        s.key(k)
    want = ref.camera_after(scenes.make_camera(cfg, RES), history)
    for name in ("pos", "forward", "up", "right"):
        got = getattr(s.camera, name).numpy()
        np.testing.assert_allclose(got, getattr(want, name), rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(got).max()),
                                   err_msg=name)


def spans_of(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("pt.")),
                  key=lambda sp: sp[1])


def named(spans, name):
    return [sp for sp in spans if sp[0] == name]


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_step_span_holds_one_render_and_one_display():
    _, s = session(small_garden(), depth=2, frame_samples=1,
                   backend="beam")
    spans = spans_of(lambda: [s.step() for _ in range(2)])
    steps = named(spans, "pt.realtime.step")
    assert len(steps) == 2
    for name in ("pt.render_film", "pt.realtime.blend",
                 "pt.realtime.display"):
        found = named(spans, name)
        assert len(found) == 2, name
        for step in steps:
            assert sum(inside(f, step) for f in found) == 1, name
    assert named(spans, "pt.realtime.reset") == []


def test_reset_span_once_per_camera_key(tmp_path):
    _, s = session(small_garden(), depth=2, frame_samples=1,
                   backend="beam", screenshot_dir=str(tmp_path))
    s.step()

    def press():
        for k in ("p", "left", "w", "nothing", "r"):
            s.key(k)
        s.step()
    spans = spans_of(press)
    keys, resets = named(spans, "pt.realtime.key"), named(spans,
                                                           "pt.realtime.reset")
    assert len(keys) == len(resets) == 3
    assert all(inside(r, k) for r, k in zip(resets, keys))
    (step,) = named(spans, "pt.realtime.step")
    assert not any(inside(r, step) for r in resets)
