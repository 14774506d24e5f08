"""pathtracer_tpu_torch scene, camera, film and checkpoint layers against
pathtracer_tpu."""

import hashlib
import math
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu import camera as jcamera
from pathtracer_tpu import image as jimage
from pathtracer_tpu.utils import checkpoint as jckpt
from pathtracer_tpu_torch import camera as tcamera
from pathtracer_tpu_torch import image as timage
from pathtracer_tpu_torch.utils import checkpoint as tckpt

from _torch_parity import (CAMERA_FIELDS, SCENE_FIELDS, as_np, carry)

FIXTURES = {
    "corner": (jpt.corner_scene, tpt.corner_scene, ()),
    "cornell": (jpt.cornell_box, tpt.cornell_box, ()),
    "specular": (jpt.modified_cornell, tpt.modified_cornell, (0.05,)),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_scene_arrays_equal(name):
    jfn, tfn, args = FIXTURES[name]
    jcam, jscene = jfn(*args, res=(32, 24))
    tcam, tscene = tfn(*args, res=(32, 24), device="cpu")
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(as_np(getattr(tscene, f)),
                                      np.asarray(getattr(jscene, f)), f)
    assert tscene.num_tris == jscene.num_tris
    assert tscene.has_specular == jscene.has_specular
    assert tscene.padded_size == jscene.padded_size
    assert tscene.padded_size % 8 == 0
    for a, b in zip(tscene.host_verts() + tscene.host_materials(),
                    jscene.host_verts() + jscene.host_materials()):
        np.testing.assert_array_equal(a, b)
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(as_np(getattr(tcam, f)),
                                      np.asarray(getattr(jcam, f)), f)
    assert tcam.res == jcam.res == (32, 24)
    assert tcam.pixel_offset == jcam.pixel_offset == 0.5


def test_scene_builder_padding_and_errors():
    sb = tpt.SceneBuilder()
    with pytest.raises(ValueError):
        sb.build()
    for i in range(9):
        sb.add_triangle((i, 0, 0), (i + 1, 0, 0), (i, 1, 0), tpt.Diffuse(0.5))
    assert len(sb) == 9
    scene = sb.build(device="cpu")
    assert scene.padded_size == 16 and scene.num_tris == 9
    assert not scene.has_specular
    assert int(scene.mat_type[9:].abs().sum()) == 0
    assert tpt.SceneBuilder().add_triangle(
        (0, 0, 0), (1, 0, 0), (0, 1, 0),
        tpt.Specular(0.1)).build(pad_to_multiple=4,
                                 device="cpu").padded_size == 4


def test_scene_to_keeps_host_caches():
    _, scene = tpt.cornell_box(res=(8, 8), device="cpu")
    moved = scene.to("cpu")
    assert moved.device.type == "cpu"
    assert moved.host_verts()[0] is not None
    np.testing.assert_array_equal(moved.host_materials()[2],
                                  scene.host_materials()[2])
    # A scene built without the builder still answers from its tensors.
    bare = tpt.Scene(*(getattr(scene, f) for f in SCENE_FIELDS),
                     num_tris=scene.num_tris, has_specular=False)
    for a, b in zip(bare.host_verts(), scene.host_verts()):
        np.testing.assert_array_equal(a, b)


def test_in_place_edit_refreshes_host_caches():
    """An in-place edit of a scene tensor reaches every host cache and key:
    the fingerprint, the host arrays, the Plücker rows and the cached
    accels (the kernels would otherwise render the old scene)."""
    from pathtracer_tpu_torch import clusters as tclusters
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

    cam, scene = tpt.corner_scene(res=(8, 8), device="cpu")
    fp0 = scene.fingerprint()
    rows0 = ttk._plucker_rows(scene, cam)
    cache = []
    accel0 = tclusters.cached_accel(cache, scene, tclusters.build_clusters)
    assert tclusters.cached_accel(cache, scene,
                                  tclusters.build_clusters) is accel0
    with torch.no_grad():
        scene.v1[0] += 0.5
        scene.albedo[0] *= 0.5
    assert scene.fingerprint() != fp0
    n = scene.num_tris
    np.testing.assert_array_equal(scene.host_verts()[0], as_np(scene.v1)[:n])
    np.testing.assert_array_equal(scene.host_materials()[1],
                                  as_np(scene.albedo)[:n])
    rows = ttk._plucker_rows(scene, cam)
    assert rows is not rows0
    np.testing.assert_array_equal(
        as_np(rows), ttk._triangle_params_plucker(scene, cam.host_pos()))
    assert tclusters.cached_accel(cache, scene,
                                  tclusters.build_clusters) is not accel0
    # Undoing the edit exactly gives back SceneBuilder's bytes and key.
    with torch.no_grad():
        scene.v1[0] -= 0.5
        scene.albedo[0] *= 2.0
    assert scene.fingerprint() == fp0
    # A moved scene records its own tensors' counters.
    moved = scene.to("cpu")
    with torch.no_grad():
        moved.emit[2] *= 0.5
        moved.v3[1] += 1.0
    assert moved.fingerprint() != fp0
    np.testing.assert_array_equal(moved.host_materials()[2],
                                  as_np(moved.emit)[:n])
    np.testing.assert_array_equal(moved.host_verts()[2], as_np(moved.v3)[:n])


def test_inference_mode_scene_reads_its_tensors():
    """Inference tensors keep no version counter: such a scene's host
    arrays and key come from its tensors on every call."""
    _, ref = tpt.corner_scene(res=(8, 8), device="cpu")
    with torch.inference_mode():
        _, scene = tpt.corner_scene(res=(8, 8), device="cpu")
        assert scene.fingerprint() == ref.fingerprint()
        scene.v2[1] += 1.0
        assert scene.fingerprint() != ref.fingerprint()
        np.testing.assert_array_equal(scene.host_verts()[1],
                                      as_np(scene.v2)[:scene.num_tris])


def _independent_key(scene):
    """The fingerprint written out from the scene's own tensors: SHA-1 over
    each unpadded array's shape string and bytes, vertices then materials."""
    n = scene.num_tris
    h = hashlib.sha1()
    for f in SCENE_FIELDS:
        a = np.ascontiguousarray(as_np(getattr(scene, f))[:n])
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return (n, h.hexdigest())


@pytest.fixture
def scene_hashes(monkeypatch):
    """The count of SHA-1 objects ``pathtracer_tpu_torch.scene`` makes."""
    calls = []

    def sha1(*args):
        calls.append(1)
        return hashlib.sha1(*args)
    monkeypatch.setattr(sys.modules["pathtracer_tpu_torch.scene"],
                        "hashlib", types.SimpleNamespace(sha1=sha1))
    return calls


def test_fingerprint_is_hashed_once_per_content_version(scene_hashes):
    _, scene = tpt.cornell_box(res=(8, 8), device="cpu")
    key = scene.fingerprint()
    assert len(scene_hashes) == 1
    assert scene.fingerprint() == key and scene.fingerprint() == key
    assert len(scene_hashes) == 1
    assert key == _independent_key(scene)


_EDITS = {"v1": 0.5, "v2": -0.25, "v3": 1.0, "mat_type": 1, "albedo": -0.5,
          "emit": 0.75, "roughness": 0.25}


@pytest.mark.parametrize("field", SCENE_FIELDS)
def test_in_place_edit_of_each_field_rehashes(scene_hashes, field):
    _, scene = tpt.corner_scene(res=(8, 8), device="cpu")
    key = scene.fingerprint()
    with torch.no_grad():
        getattr(scene, field)[0] += _EDITS[field]
    new = scene.fingerprint()
    assert new != key and new == _independent_key(scene)
    assert len(scene_hashes) == 2
    assert scene.fingerprint() == new and len(scene_hashes) == 2


def test_to_keeps_the_key_and_replace_materials_rehashes(scene_hashes):
    _, scene = tpt.cornell_box(res=(8, 8), device="cpu")
    key = scene.fingerprint()
    moved = scene.to("cpu")
    assert moved.fingerprint() == key and len(scene_hashes) == 1
    # Swapped materials are another content: a new key, hashed once.
    new = scene.replace_materials(albedo=scene.albedo * 0.5)
    assert new.fingerprint() != key and len(scene_hashes) == 2
    assert new.fingerprint() == _independent_key(new)
    assert len(scene_hashes) == 2
    # A scene edited after its key was kept moves without that key.
    with torch.no_grad():
        scene.emit[0] += 1.0
    moved = scene.to("cpu")
    assert moved.fingerprint() == _independent_key(scene) != key
    assert len(scene_hashes) == 3


def test_inference_mode_scene_hashes_every_call(scene_hashes):
    with torch.inference_mode():
        _, scene = tpt.corner_scene(res=(8, 8), device="cpu")
        for i in range(1, 4):
            assert scene.fingerprint() == _independent_key(scene)
            assert len(scene_hashes) == i


def test_cached_accel_hashes_a_scene_once(scene_hashes):
    from pathtracer_tpu_torch import clusters as tclusters

    _, scene = tpt.corner_scene(res=(8, 8), device="cpu")
    cache = []
    accels = [tclusters.cached_accel(cache, scene, tclusters.build_clusters)
              for _ in range(3)]
    assert accels[1] is accels[0] and accels[2] is accels[0]
    assert len(scene_hashes) == 1 and len(cache) == 1


def test_convert_carries_jax_scene_unchanged():
    jcam, jscene = jpt.modified_cornell(0.3, res=(16, 16))
    cam, scene = carry(jcam, jscene)
    tcam, tscene = tpt.modified_cornell(0.3, res=(16, 16), device="cpu")
    for f in SCENE_FIELDS:
        assert torch.equal(getattr(scene, f), getattr(tscene, f)), f
    for f in CAMERA_FIELDS:
        assert torch.equal(getattr(cam, f), getattr(tcam, f)), f
    assert cam.res == tcam.res and scene.num_tris == tscene.num_tris


def test_make_camera_rejects_parallel_up():
    with pytest.raises(ValueError):
        tpt.make_camera((0, 0, 0), (0, 1, 0), (0, 1, 0), (8, 8), 1.0,
                        device="cpu")


@pytest.mark.parametrize("offset", [0.5, 0.0])
def test_get_rays_match(offset):
    jcam = jcamera.make_camera((278, 278, -500), (0, 0, 1), (0, 1, 0),
                               (48, 32), 60 * math.pi / 180, 1.0,
                               pixel_offset=offset)
    tcam = tcamera.make_camera((278, 278, -500), (0, 0, 1), (0, 1, 0),
                               (48, 32), 60 * math.pi / 180, 1.0,
                               pixel_offset=offset, device="cpu")
    rng = np.random.default_rng(8)
    w = np.broadcast_to(np.arange(48, dtype=np.int32)[None], (32, 48))
    h = np.broadcast_to(np.arange(32, dtype=np.int32)[:, None], (32, 48))
    u1 = rng.random((32, 48), dtype=np.float32)
    u2 = rng.random((32, 48), dtype=np.float32)
    jo, jd = jcamera.get_rays(jcam, *map(jnp.asarray, (w, h, u1, u2)))
    to, td = tcamera.get_rays(tcam, *map(torch.from_numpy,
                                         (w.copy(), h.copy(), u1, u2)))
    np.testing.assert_array_equal(as_np(to), np.asarray(jo))
    np.testing.assert_allclose(as_np(td), np.asarray(jd), atol=1e-6)


@pytest.mark.parametrize("direction", range(6))
def test_rotate_and_move_match(direction):
    jcam, _ = jpt.cornell_box(res=(8, 8))
    tcam, _ = tpt.cornell_box(res=(8, 8), device="cpu")
    jr = jcamera.rotate(jcam, direction, 0.3)
    tr = tcamera.rotate(tcam, direction, 0.3)
    jm = jcamera.move(jcam, direction, 7.5)
    tm = tcamera.move(tcam, direction, 7.5)
    for f in ("forward", "up", "right"):
        np.testing.assert_allclose(as_np(getattr(tr, f)),
                                   np.asarray(getattr(jr, f)), atol=1e-6)
    np.testing.assert_allclose(as_np(tm.pos), np.asarray(jm.pos), atol=1e-4)


def test_film_to_u8_and_gamma_match():
    rng = np.random.default_rng(9)
    data = rng.uniform(-0.2, 1.3, (12, 20, 3)).astype(np.float32)
    jf = jimage.Film((20, 12), data=data.copy())
    tf = timage.Film((20, 12), data=torch.from_numpy(data.copy()))
    np.testing.assert_array_equal(tf.to_u8(), jf.to_u8())
    jf.gamma_correct(2.2)
    tf.gamma_correct(2.2)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf.data), atol=1e-6)
    tf += tf
    tf /= 2.0
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf.data), atol=1e-6)


def test_png_roundtrip_and_cross_read(tmp_path):
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    path = str(tmp_path / "t.png")
    timage.write_png(path, img)
    np.testing.assert_array_equal(timage.read_png(path), img)
    np.testing.assert_array_equal(jimage.read_png(path), img)
    film = timage.Film((23, 17), data=torch.from_numpy(
        (img.astype(np.float32) + 0.5) / 255.0))
    film.save_png(path)
    back = timage.read_png(path)
    np.testing.assert_array_equal(back, film.to_u8())
    np.testing.assert_array_equal(back, img[::-1])  # row 0 is the bottom
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        timage.read_png(str(tmp_path / "bad.png"))


def test_psnr_matches():
    rng = np.random.default_rng(11)
    a = rng.random((8, 8, 3), dtype=np.float32)
    b = a + rng.normal(0, 0.01, a.shape).astype(np.float32)
    assert timage.psnr(torch.from_numpy(a), b) == pytest.approx(
        jimage.psnr(a, b), rel=1e-12)
    assert timage.psnr(a, a) == float("inf")


def test_render_checkpoint_layout_is_shared(tmp_path):
    film = np.random.default_rng(12).random((4, 6, 3), dtype=np.float32)
    meta = {"width": 6, "height": 4, "samples": 8, "backend": "cuda"}
    path = str(tmp_path / "ck")
    tckpt.save_render_checkpoint(path, torch.from_numpy(film), 5, meta)
    got = jckpt.load_render_checkpoint(path)
    np.testing.assert_array_equal(got[0], film)
    assert got[1:] == (5, meta)
    jckpt.save_render_checkpoint(str(tmp_path / "j.npz"), film, 3, meta)
    got = tckpt.load_render_checkpoint(str(tmp_path / "j"))
    np.testing.assert_array_equal(got[0], film)
    assert got[1:] == (3, meta)


def test_timer_measures_elapsed_time():
    timer = tpt.Timer("cpu")
    assert timer.seconds() >= 0.0
    timer.reset()
    assert tpt.Timer().seconds() >= 0.0
