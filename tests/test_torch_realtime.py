"""pathtracer_tpu_torch.realtime (the progressive-accumulation state
machine, render.h:219-387) and utils/profiling: the cases of
tests/test_realtime.py on the CPU, and the session's film held against
the JAX package's."""

import importlib
import io
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu.realtime import RealtimeSession as JSession
from pathtracer_tpu_torch import clusters as tclusters
from pathtracer_tpu_torch.image import read_png
from pathtracer_tpu_torch.realtime import RealtimeSession, render_realtime
from pathtracer_tpu_torch.utils import profiling

from _torch_parity import as_np, assert_films_close, scene_pair

rt = importlib.import_module("pathtracer_tpu_torch.realtime")
trender = importlib.import_module("pathtracer_tpu_torch.render")


def _session(**kw):
    cam, scene = tpt.corner_scene(res=(16, 16), device="cpu")
    return RealtimeSession(cam, scene, depth=3, frame_samples=4, **kw)


def test_accumulation_is_running_mean():
    s = _session()
    f1 = s.step()
    assert s.frame == 1
    f2 = s.step()
    assert s.frame == 2
    assert f1.shape == (16, 16, 3)
    assert np.all(f2 >= 0) and np.isfinite(f2).all()
    # The film is the running mean of the frames render_film gives, and
    # stays on the scene's device.
    frames = [tpt.render_film(s.camera, s.scene, 4, 3, seed=1 + k).data
              for k in range(2)]
    assert torch.equal(s._accum, frames[0] * 0.5 + frames[1] * 0.5)
    assert s._accum.device == s.scene.device


def test_camera_move_resets_accumulation():
    s = _session()
    s.step()
    s.step()
    assert s.frame == 2
    s.key("w")
    assert s.frame == 0
    assert np.all(as_np(s._accum) == 0)
    np.testing.assert_allclose(
        as_np(s.camera.pos),
        as_np(tpt.move(s.initial_camera, tpt.FORWARD, 1.0).pos), atol=1e-6)


def test_reset_key_restores_camera():
    s = _session()
    for k in ("w", "a", "up", "left", "space"):
        s.key(k)
    s.key("r")
    np.testing.assert_allclose(as_np(s.camera.pos),
                               as_np(s.initial_camera.pos), atol=1e-6)
    np.testing.assert_allclose(as_np(s.camera.forward),
                               as_np(s.initial_camera.forward), atol=1e-6)


def test_screenshot(tmp_path):
    s = _session(screenshot_dir=str(tmp_path))
    s.step()
    s.key("p")
    path = os.path.join(str(tmp_path), "1.png")
    assert os.path.exists(path)
    assert read_png(path).shape == (16, 16, 3)


def test_headless_driver_with_key_script(tmp_path):
    cam, scene = tpt.corner_scene(res=(16, 16), device="cpu")
    sess = render_realtime(cam, scene, depth=2, frame_samples=2,
                           screenshot_dir=str(tmp_path), frames=4,
                           keys=",w,,p")
    # 'w' at loop-iter 1 reset accumulation; 3 steps ran since ('p' at
    # iter 3 only screenshots, no reset)
    assert sess.frame == 3
    assert "pos:" in sess.title


def test_non_accumulate_mode():
    s = _session(accumulate=False)
    f1 = s.step()
    f2 = s.step()
    np.testing.assert_allclose(f1, f2)  # same seed, fresh film each frame


def _cuda_like(scene):
    """A stand-in with the attributes _auto_backend reads, reporting a CUDA
    device, so the rule runs without a card."""
    class S:
        device = torch.device("cuda", 0)
        padded_size = scene.padded_size
    return S()


def test_pick_backend_resolves_auto_on_a_cuda_scene(monkeypatch):
    """On a CUDA scene 'auto' resolves once, by render._auto_backend: the
    trace kernel up to 512 padded triangles, then the beam kernel, then
    the cluster kernel with a warning; on a CPU scene it stays 'auto'."""
    cam, small = tpt.cornell_box(res=(32, 32), device="cpu")
    cam2, sb = tpt.meshes.sphere_in_box(16, 32, device="cpu")
    big = sb.build(device="cpu")          # 1036 triangles > BRUTE_MAX
    assert rt._pick_backend(cam, small, "auto") == "auto"
    assert rt._pick_backend(cam2, big, "auto") == "auto"
    assert rt._pick_backend(cam2, big, "cluster") == "cluster"
    assert rt._pick_backend(cam, _cuda_like(small), "auto") == "cuda"
    n_sc = {"n": 100}

    class Accel:
        @property
        def num_superclusters(self):
            return n_sc["n"]
    monkeypatch.setattr(trender.beam_kernel, "_accel_for",
                        lambda scene: Accel())
    assert rt._pick_backend(cam2, _cuda_like(big), "auto") == "beam"
    n_sc["n"] = tclusters.MAX_BEAM_SC + 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert rt._pick_backend(cam2, _cuda_like(big), "auto") == "cluster"
    assert any("cluster" in str(w.message) for w in caught)
    assert rt._pick_backend(cam2, _cuda_like(big), "beam") == "beam"


def test_ansi_frame_renders_halfblocks():
    img = np.zeros((4, 4, 3), np.float32)
    img[0, 0] = (1.0, 0.0, 0.0)
    s = rt.ansi_frame(img)
    lines = s.split("\n")
    assert len(lines) == 2            # 4 rows -> 2 half-block lines
    assert s.count("▀") == 8          # 4 cols x 2 lines
    assert "\x1b[38;2;255;0;0m" in lines[0]   # the red pixel, upper half
    assert lines[0].endswith("\x1b[0m")
    big = np.zeros((8, 256, 3), np.float32)
    s2 = rt.ansi_frame(big, max_cols=64)
    assert s2.split("\n")[0].count("▀") == 64


def test_run_interactive_requires_tty(monkeypatch):
    cam, scene = tpt.corner_scene(res=(8, 8), device="cpu")
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    with pytest.raises(ValueError, match="tty"):
        rt.run_interactive(cam, scene, max_frames=1)


def test_session_film_matches_jax():
    """Three accumulated frames, 16^2: the JAX session's film."""
    (jcam, jscene), (cam, scene) = scene_pair("corner", (16, 16))
    js = JSession(jcam, jscene, depth=3, frame_samples=4)
    ts = RealtimeSession(cam, scene, depth=3, frame_samples=4)
    for _ in range(3):
        jdisp, tdisp = js.step(), ts.step()
    assert js.frame == ts.frame == 3
    assert_films_close(ts._accum, js._accum)
    assert_films_close(tdisp, jdisp)
    assert as_np(ts._accum).max() > 0


def test_rays_per_second_and_profile_to(tmp_path):
    with profiling.profile_to(None) as prof:
        assert prof is None
    logdir = tmp_path / "trace"
    with profiling.profile_to(str(logdir)):
        with profiling.trace_annotation("pathtracer.step"):
            torch.ones(8).sum()
    trace = (logdir / "trace.json").read_text()
    assert "pathtracer.step" in trace
