"""pathtracer_tpu_torch render drivers against pathtracer_tpu, and the
package boundary (no JAX import)."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
from pathtracer_tpu_torch.utils import checkpoint as ckpt

from _torch_parity import as_np, assert_films_close, scene_pair

# The packages re-export render(), which shadows the module attribute.
jrender = importlib.import_module("pathtracer_tpu.render")
trender = importlib.import_module("pathtracer_tpu_torch.render")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,spp,depth", [("corner", 4, 5),
                                            ("cornell", 4, 5),
                                            ("specular", 2, 4)])
def test_brute_matches_jax_brute(name, spp, depth):
    (jcam, jscene), (tcam, tscene) = scene_pair(name, (32, 32))
    want = jpt.render_film(jcam, jscene, samples=spp, depth=depth,
                           backend="brute")
    got = tpt.render_film(tcam, tscene, spp, depth, backend="brute")
    assert (got.width, got.height) == (32, 32)
    assert float(got.data.sum()) > 0.0
    assert_films_close(got.data, want.data)


@pytest.mark.parametrize("name", ["cornell", "specular"])
def test_megakernel_backend_matches_jax_brute(name):
    """backend='cuda' on a CPU scene runs the kernel's plain version."""
    (jcam, jscene), (tcam, tscene) = scene_pair(name, (16, 16))
    want = jpt.render_film(jcam, jscene, samples=3, depth=4, backend="brute")
    got = tpt.render_film(tcam, tscene, 3, 4, backend="cuda")
    assert_films_close(got.data, want.data)


def test_auto_backend_rules():
    _, (cam, scene) = scene_pair("cornell", (8, 8))
    assert trender._auto_backend(cam, scene) == "brute"
    sb = tpt.SceneBuilder()
    for i in range(trender.BRUTE_MAX + 1):
        sb.add_triangle((i, 0, 0), (i + 1, 0, 0), (i, 1, 0), tpt.Diffuse(1))
    big = sb.build(device="cpu")
    # Above BRUTE_MAX a CPU scene takes the per-ray BVH traversal.
    assert trender._auto_backend(cam, big) == "bvh"
    assert torch.equal(tpt.render_film(cam, big, 1, 1).data,
                       tpt.render_film(cam, big, 1, 1, backend="bvh").data)
    with pytest.raises(ValueError):
        tpt.render_film(cam, scene, 1, 1, backend="pallas")


@pytest.mark.parametrize("width,height,samples,n_tris", [
    (1024, 1024, 4, 32), (64, 48, 8, 32), (33, 17, 3, 600), (7, 5, 100, 8)])
def test_plan_and_schedule_match_jax(width, height, samples, n_tris):
    plan = trender._plan(width, height, samples, n_tris)
    assert plan == jrender._plan(width, height, samples, n_tris, "brute")
    assert (trender._sample_schedule(samples, *plan[1:])
            == jrender._sample_schedule(samples, *plan[1:]))


@pytest.mark.parametrize("backend", ["brute", "cuda"])
def test_checkpoint_resume_is_bit_identical(tmp_path, monkeypatch, backend):
    _, (cam, scene) = scene_pair("corner", (16, 16))
    # Small tiles (the last one ragged) and sample windows, so the render
    # has several entries to resume at.
    monkeypatch.setattr(trender, "_plan", lambda *args: (6, 2, 1))
    monkeypatch.setattr(ttk, "RAYS_PER_CALL", 512)

    def run(samples=6, depth=3, **kwargs):
        return tpt.render_film(cam, scene, samples, depth, backend=backend,
                               **kwargs)

    plain = run()
    full = run(checkpoint=str(tmp_path / "full"))
    assert torch.equal(full.data, plain.data)
    path = str(tmp_path / "ck.npz")
    with pytest.raises(KeyboardInterrupt):
        run(checkpoint=path, _abort_after=1)
    _, done, meta = ckpt.load_render_checkpoint(path)
    assert 0 < done < 6 and meta["backend"] == backend
    resumed = run(checkpoint=path)
    assert torch.equal(resumed.data, full.data)
    with pytest.raises(ValueError, match="different render config"):
        run(depth=4, checkpoint=path)


def test_checkpoint_refuses_another_scene(tmp_path):
    """Two specular Cornell boxes differ in roughness only, which the
    JAX package's float-sum key does not see; the fingerprint does."""
    path = str(tmp_path / "ck.npz")
    cam, scene = tpt.modified_cornell(0.05, res=(8, 8), device="cpu")
    tpt.render_film(cam, scene, 4, 2, backend="brute", checkpoint=path)
    _, other = tpt.modified_cornell(0.8, res=(8, 8), device="cpu")
    for a, b in zip(other.host_verts() + other.host_materials()[1:2],
                    scene.host_verts() + scene.host_materials()[1:2]):
        np.testing.assert_array_equal(a, b)   # the float-sum key's arrays
    with pytest.raises(ValueError, match="different render config"):
        tpt.render_film(cam, other, 4, 2, backend="brute", checkpoint=path)


def test_jax_written_checkpoint_resumes(tmp_path):
    """A checkpoint the JAX package wrote has no fingerprint; it is held
    to the keys it has and resumes."""
    (jcam, jscene), (cam, scene) = scene_pair("corner", (8, 8))
    path = str(tmp_path / "jax.npz")
    want = jrender.render_film(jcam, jscene, 4, 2, backend="brute",
                               checkpoint=path)
    assert "scene_fingerprint" not in ckpt.load_render_checkpoint(path)[2]
    got = tpt.render_film(cam, scene, 4, 2, backend="brute", checkpoint=path)
    np.testing.assert_array_equal(as_np(got.data), np.asarray(want.data))


def test_render_normals_matches_jax():
    (jcam, jscene), (tcam, tscene) = scene_pair("cornell", (24, 16))
    want = jrender.render_normals(jcam, jscene)
    got = trender.render_normals(tcam, tscene)
    np.testing.assert_allclose(as_np(got.data), np.asarray(want.data),
                               atol=1.2e-7)


def test_render_debug_uv_matches_jax():
    np.testing.assert_array_equal(as_np(trender.render_debug_uv((9, 5)).data),
                                  jrender.render_debug_uv((9, 5)).data)


def test_render_pipeline_writes_png(tmp_path, capsys):
    _, (cam, scene) = scene_pair("corner", (16, 16))
    path = str(tmp_path / "out.png")
    film = tpt.render(cam, scene, 2, 3, filename=path)
    assert "rays/s" in capsys.readouterr().out
    linear = tpt.render_film(cam, scene, 2, 3)
    np.testing.assert_allclose(as_np(film.data),
                               as_np(linear.data).clip(0) ** (1 / 2.2),
                               atol=1e-6)
    np.testing.assert_array_equal(tpt.read_png(path), film.to_u8())


def test_launch_counter_untouched_on_cpu():
    _, (cam, scene) = scene_pair("corner", (8, 8))
    before = ttk.LAUNCHES
    tpt.render_film(cam, scene, 2, 2, backend="cuda")
    assert ttk.LAUNCHES == before


def test_package_never_imports_jax():
    code = (
        "import sys, importlib\n"
        "mods = ['pathtracer_tpu_torch', 'pathtracer_tpu_torch.render',\n"
        "        'pathtracer_tpu_torch.convert',\n"
        "        'pathtracer_tpu_torch.diff', 'pathtracer_tpu_torch.inverse',\n"
        "        'pathtracer_tpu_torch.ops.cuda.trace_kernel',\n"
        "        'pathtracer_tpu_torch.ops.cuda.cluster_kernel',\n"
        "        'pathtracer_tpu_torch.ops.cuda.beam_kernel',\n"
        "        'pathtracer_tpu_torch.bvh', 'pathtracer_tpu_torch.clusters',\n"
        "        'pathtracer_tpu_torch.meshes',\n"
        "        'pathtracer_tpu_torch.obj_loader',\n"
        "        'pathtracer_tpu_torch.examples.sphere_obj',\n"
        "        'pathtracer_tpu_torch.examples.modified_cornell',\n"
        "        'pathtracer_tpu_torch.utils.native',\n"
        "        'pathtracer_tpu_torch.utils.build',\n"
        "        'pathtracer_tpu_torch.utils.checkpoint',\n"
        "        'pathtracer_tpu_torch.utils.profiling',\n"
        "        'pathtracer_tpu_torch.parallel',\n"
        "        'pathtracer_tpu_torch.realtime', 'pathtracer_tpu_torch.cli']\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'pathtracer_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
