"""The megakernel's wrapper, plain version and scene packing.

The plain version (``render_sum_reference``) against pathtracer_tpu's
Pallas megakernel in interpret mode, loop "mt", and the window, band and
packing contracts, on the CPU.  The CUDA kernel itself is held against the
plain version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu.ops.pallas import trace_kernel as jtk
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

from _torch_parity import as_np, assert_films_close, scene_pair

PALLAS_CASES = [("corner", 4, 3), ("cornell", 2, 3), ("specular", 2, 3)]


@pytest.mark.parametrize("name,spp,depth", PALLAS_CASES)
def test_reference_matches_pallas_mt(name, spp, depth):
    (jcam, jscene), (tcam, tscene) = scene_pair(name, (16, 16))
    want = jtk.render_film_pallas(jcam, jscene, spp, depth, seed=1,
                                  loop="mt", interpret=True, tile_rows=8)
    got = ttk.render_sum_reference(tcam, tscene, 0, spp, depth, seed=1) / spp
    assert float(got.sum()) > 0.0
    assert_films_close(got, want.data)


def test_cuda_wrapper_takes_plain_version_on_cpu():
    _, (cam, scene) = scene_pair("specular", (16, 8))
    before = ttk.LAUNCHES
    got = ttk.render_sum_cuda(cam, scene, 3, 3, 3, seed=5)
    want = ttk.render_sum_reference(cam, scene, 3, 3, 3, seed=5)
    assert ttk.LAUNCHES == before
    assert torch.equal(got, want)


def test_multi_call_accumulation():
    """Samples split across calls equal one call, up to the order of the
    float sums."""
    _, (cam, scene) = scene_pair("corner", (16, 16))
    one = ttk.render_sum_reference(cam, scene, 0, 4, 3)
    split = ttk.render_sum_reference(cam, scene, 0, 4, 3, spp_per_call=1)
    windows = (ttk.render_sum_reference(cam, scene, 0, 2, 3)
               + ttk.render_sum_reference(cam, scene, 2, 2, 3))
    np.testing.assert_allclose(as_np(split), as_np(one), atol=1e-6)
    np.testing.assert_allclose(as_np(windows), as_np(one), atol=1e-6)


@pytest.mark.parametrize("h0,band_h", [(0, 5), (5, 7), (12, 4)])
def test_band_rows_equal_full_film(h0, band_h):
    _, (cam, scene) = scene_pair("cornell", (16, 16))
    full = ttk.render_sum_reference(cam, scene, 0, 2, 4)
    band = ttk.render_sum_reference(cam, scene, 0, 2, 4, h0=h0,
                                    band_h=band_h)
    assert tuple(band.shape) == (band_h, 16, 3)
    assert torch.equal(band, full[h0:h0 + band_h])


def test_memory_chunks_do_not_change_the_sum(monkeypatch):
    _, (cam, scene) = scene_pair("specular", (8, 8))
    whole = ttk.render_sum_reference(cam, scene, 0, 5, 3)
    monkeypatch.setattr(ttk, "REFERENCE_RAYS_PER_CHUNK", 2 * 64)
    assert torch.equal(ttk.render_sum_reference(cam, scene, 0, 5, 3), whole)


def test_bad_windows_raise():
    _, (cam, scene) = scene_pair("corner", (8, 8))
    for kwargs in ({"h0": 8}, {"h0": 4, "band_h": 5}, {"band_h": 0}):
        with pytest.raises(ValueError):
            ttk.render_sum_cuda(cam, scene, 0, 1, 1, **kwargs)
    with pytest.raises(ValueError):
        ttk.render_sum_cuda(cam, scene, -1, 1, 1)


@pytest.mark.parametrize("name", ["corner", "cornell", "specular"])
def test_kernel_params_equal_jax_packing(name):
    (jcam, jscene), (tcam, tscene) = scene_pair(name, (32, 16))
    np.testing.assert_array_equal(as_np(ttk._camera_params(tcam)),
                                  jtk._camera_params(jcam))
    np.testing.assert_array_equal(as_np(ttk._triangle_params(tscene)),
                                  np.asarray(jtk._triangle_params(jscene)))
    got = as_np(ttk._packed_table(tscene))
    want = np.asarray(jtk._packed_table(jscene))
    assert got.shape == (tscene.num_tris, 8)
    cols = [0, 1, 2, 3, 7]  # color, roughness, flags: exact
    np.testing.assert_array_equal(got[:, cols], want[:, cols])
    # Normals: one ulp, see test_torch_trace.test_shade_table_equal.
    np.testing.assert_allclose(got[:, 4:7], want[:, 4:7], rtol=0, atol=1.2e-7)


def _emissive_diffuse_scene():
    sb = tpt.SceneBuilder()
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                    tpt.HostMaterial(tpt.DIFFUSE, color=(1, 1, 1),
                                     emit=(1, 0, 0)))
    return sb.build(device="cpu")


def test_packed_table_rejects_emissive_non_emit():
    with pytest.raises(ValueError, match="non-EMIT"):
        ttk._packed_table(_emissive_diffuse_scene())
