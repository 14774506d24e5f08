"""pathtracer_tpu_torch's large-scene render drivers against
pathtracer_tpu: the "bvh", "cluster" and "beam" backends of render_film on
one scene, and the auto backend's choice on CPU and (mocked) CUDA scenes."""

import numpy as np
import pytest
import torch

import pathtracer_tpu as jpt

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.clusters import BeamAccel
from pathtracer_tpu_torch.render import BRUTE_MAX, _auto_backend
from pathtracer_tpu_torch.ops.cuda import beam_kernel as tbk
from pathtracer_tpu_torch.scene import Scene

from _torch_parity import assert_films_close, carry
from test_torch_beam import lit_sphere


@pytest.mark.parametrize("backend", ["bvh", "cluster", "beam"])
def test_render_film_matches_jax_backend(backend):
    """16^2, 2 spp, depth 3 on the lit 392-triangle sphere scene, against
    the JAX package's same backend (its cluster and beam kernels
    interpreted); film bar of tests/_torch_parity.py."""
    jcam, jscene = lit_sphere(jpt, (16, 16))
    want = np.asarray(jpt.render_film(jcam, jscene, 2, 3, seed=5,
                                      backend=backend).data)
    assert want.max() > 0
    tcam, tscene = carry(jcam, jscene)
    got = tpt.render_film(tcam, tscene, 2, 3, seed=5, backend=backend).data
    assert_films_close(got, want)


def test_cluster_and_bvh_backends_agree():
    """Both keep per-pixel independent sampling and exact nearest hits, so
    on one package they give the same film; a prebuilt accel is used."""
    cam, scene = lit_sphere(tpt, (16, 16), 8, 12)
    bvh = tpt.build_bvh(scene)
    f_bvh = tpt.render_film(cam, scene, 2, 3, bvh=bvh, backend="bvh")
    f_cl = tpt.render_film(cam, scene, 2, 3, bvh=bvh, backend="cluster")
    f_cs = tpt.render_film(cam, scene, 2, 3, backend="cluster",
                           bvh=tpt.build_clusters(scene, bvh=bvh))
    assert float(f_bvh.data.max()) > 0
    assert torch.equal(f_cl.data, f_bvh.data)
    assert torch.equal(f_cs.data, f_bvh.data)


def test_auto_backend_on_the_cpu():
    cam, scene = lit_sphere(tpt, (8, 8), 8, 12)          # 180 + 12 tris
    assert scene.padded_size <= BRUTE_MAX
    assert _auto_backend(cam, scene) == "brute"
    cam, scene = lit_sphere(tpt, (8, 8))                  # 392 + 12 tris
    big = tpt.meshes.mesh_garden(grid=1, device="cpu")[1].build(
        device="cpu")
    assert big.padded_size > BRUTE_MAX
    assert _auto_backend(cam, big) == "bvh"
    film = tpt.render_film(cam, big, 1, 2)
    assert torch.equal(film.data,
                       tpt.render_film(cam, big, 1, 2, backend="bvh").data)


@pytest.fixture
def on_mock_cuda(monkeypatch):
    """Scenes report a CUDA device; nothing is moved or launched."""
    monkeypatch.setattr(Scene, "device", property(
        lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(BeamAccel, "to", lambda self, device: self)


def test_auto_backend_on_cuda_picks_the_kernels(on_mock_cuda):
    cam, small = tpt.cornell_box(res=(8, 8), device="cpu")
    assert _auto_backend(cam, small) == "cuda"
    big = tpt.meshes.mesh_garden(grid=1, device="cpu")[1].build(
        device="cpu")
    assert _auto_backend(cam, big) == "beam"


def test_auto_backend_on_cuda_falls_back_to_cluster(on_mock_cuda):
    """A non-EMIT emissive material has no beam encoding: auto takes the
    cluster kernel and says so, as the JAX package does."""
    sb = tpt.meshes.mesh_garden(grid=1, device="cpu")[1]
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                    tpt.HostMaterial(tpt.DIFFUSE, color=(1, 1, 1),
                                     emit=(1, 0, 0)))
    big = sb.build(device="cpu")
    cam, _ = tpt.cornell_box(res=(8, 8), device="cpu")
    with pytest.warns(UserWarning, match="cluster"):
        assert _auto_backend(cam, big) == "cluster"
    with pytest.raises(ValueError, match="non-EMIT"):
        tbk._accel_for(big)


def test_unknown_backend_raises():
    cam, scene = tpt.cornell_box(res=(8, 8), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tpt.render_film(cam, scene, 1, 1, backend="pallas")
