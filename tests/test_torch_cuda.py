"""The CUDA megakernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without one.
This file imports neither JAX nor pathtracer_tpu, so on a machine with a
card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Kernel and plain version round every operation alike (the library builds
with --fmad=false), so they are held to the film bar of the CPU parity
tests: atol 2e-4 on all but 1% of the pixels (see tests/_torch_parity.py).
"""

import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

FILM_ATOL = 2e-4
MAX_FLIP_SHARE = 0.01

SCENES = {
    "corner": lambda res: tpt.corner_scene(res=res),
    "cornell": lambda res: tpt.cornell_box(res=res),
    "specular": lambda res: tpt.modified_cornell(0.3, res=res),
}


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: these tests run on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run `pytest -m cuda` "
                    "on the card)")
    return torch.device("cuda")


def _on(device, name, res):
    cam, scene = SCENES[name](res)
    return cam.to(device), scene.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_matches_reference(cuda_device, name):
    cam, scene = _on(cuda_device, name, (64, 64))
    before = ttk.LAUNCHES
    got = ttk.render_sum_cuda(cam, scene, 0, 4, 5) / 4
    assert ttk.LAUNCHES == before + 1
    want = ttk.render_sum_reference(cam, scene, 0, 4, 5) / 4
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and float(got.sum()) > 0.0
    bad = ((got - want).abs().amax(dim=-1) > FILM_ATOL).float().mean()
    assert float(bad) <= MAX_FLIP_SHARE


@pytest.mark.cuda
def test_band_and_window_identities(cuda_device):
    cam, scene = _on(cuda_device, "specular", (64, 48))
    full = ttk.render_sum_cuda(cam, scene, 0, 4, 5)
    band = ttk.render_sum_cuda(cam, scene, 0, 4, 5, h0=17, band_h=13)
    assert torch.equal(band, full[17:30])
    split = (ttk.render_sum_cuda(cam, scene, 0, 1, 5)
             + ttk.render_sum_cuda(cam, scene, 1, 3, 5))
    torch.testing.assert_close(split, full, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_auto_backend_launches_kernel(cuda_device):
    cam, scene = _on(cuda_device, "cornell", (32, 32))
    before = ttk.LAUNCHES
    film = tpt.render_film(cam, scene, 4, 5)
    assert ttk.LAUNCHES > before
    brute = tpt.render_film(cam, scene, 4, 5, backend="brute")
    torch.cuda.synchronize()
    bad = ((film.data - brute.data).abs().amax(dim=-1) > FILM_ATOL)
    assert float(bad.float().mean()) <= MAX_FLIP_SHARE


@pytest.mark.cuda
def test_wrapper_does_not_synchronise(cuda_device):
    """The call returns while earlier work on the stream still runs."""
    import time

    cam, scene = _on(cuda_device, "cornell", (64, 64))
    ttk.render_sum_cuda(cam, scene, 0, 1, 1)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of device time at ~2 GHz
    t0 = time.perf_counter()
    ttk.render_sum_cuda(cam, scene, 0, 4, 5)
    seconds = time.perf_counter() - t0
    pending = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert pending and seconds < 0.25


@pytest.mark.cuda
def test_rejects_emissive_non_emit(cuda_device):
    sb = tpt.SceneBuilder()
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                    tpt.HostMaterial(tpt.DIFFUSE, color=(1, 1, 1),
                                     emit=(1, 0, 0)))
    scene = sb.build().to(cuda_device)
    cam = tpt.make_camera((0.2, 0.2, 2), (0, 0, -1), (0, 1, 0), (8, 8),
                          1.0).to(cuda_device)
    with pytest.raises(ValueError, match="non-EMIT"):
        ttk.render_sum_cuda(cam, scene, 0, 1, 2)
