"""The card tests' helpers (tests/_torch_card.py) on the CPU, where the
kernels' wrappers run their plain versions: each hold passes there, and
fails when one value of a wrapper's output moves by one ulp; the golden
comparison reads the committed renders and refuses a film a few percent
off; the light check takes every saturated pixel only when told to.

The sphere stands in for meshes.sphere_in_box(50, 100): a 180-triangle
sphere in the same lit room, seen from a camera tilted up to the light
(the plain beam version's dense test of 9,812 rows costs seconds a sample
here)."""

import os

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.ops.cuda import beam_kernel as tbk
from pathtracer_tpu_torch.ops.cuda import brute_kernel as tbr
from pathtracer_tpu_torch.ops.cuda import cluster_kernel as tck
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

import _torch_card as card

CPU = torch.device("cpu")


def _small_sphere():
    _, sb = tpt.meshes.sphere_in_box(8, 12, device="cpu")
    cam = tpt.make_camera((250, 250, -420), (0, 0.35, 1), (0, 1, 0),
                          (16, 16), 60 * tpt.DEG2RAD, 1.0, device="cpu")
    return cam, sb.build(device="cpu")


def _one_ulp(fn, pick):
    """``fn`` with one element of its output (``pick`` selects the tensor)
    moved one ulp up."""
    def perturbed(*args, **kw):
        out = fn(*args, **kw)
        x = pick(out).view(-1)
        x[0] = torch.nextafter(x[0], torch.tensor(float("inf")))
        return out
    return perturbed


def _fuzz(kind):
    def hold():
        assert card.case_holds(
            card.run_fuzz_case(CPU, kind, card.FUZZ_CASES[kind][0]), CPU)
    return hold


def _bands():
    cam, scene = _small_sphere()
    return lambda: card.hold_main_path_bands(cam, scene, 2)


def _clusters():
    cam, scene = _small_sphere()
    cs = tpt.build_clusters(scene)
    o, d = card.camera_rays(cam, 300, np.random.default_rng(1))
    return lambda: card.hold_clusters(o, d, cs, 300)


@pytest.mark.parametrize("hold, module, name, pick", [
    (lambda: _fuzz("trace"), ttk, "render_sum_cuda", lambda out: out),
    (lambda: _fuzz("beam"), tbk, "render_tiles_beam", lambda out: out),
    (lambda: _fuzz("brute"), tbr, "intersect_brute_cuda",
     lambda out: out[0]),
    (_bands, tbk, "render_tiles_beam", lambda out: out),
    (_clusters, tck, "intersect_clusters", lambda out: out[0]),
], ids=["fuzz_trace", "fuzz_beam", "fuzz_brute", "main_path_bands",
        "clusters"])
def test_one_ulp_in_the_kernel_fails_the_hold(monkeypatch, hold, module,
                                              name, pick):
    """A hold passes on the plain version and fails once one value of the
    wrapper's output is one ulp off it."""
    check = hold()
    check()
    monkeypatch.setattr(module, name, _one_ulp(getattr(module, name), pick))
    with pytest.raises(AssertionError):
        check()


def _golden_film(name):
    """A linear film whose 8-bit PNG is the committed render."""
    u8 = tpt.read_png(os.path.join(card.REPO, card.GOLDENS[name]))
    lin = ((u8[::-1].astype(np.float64) + 0.5) / 255.0) ** 2.2
    return torch.from_numpy(lin.astype(np.float32).copy())


def _save(film, path):
    tpt.Film((film.shape[1], film.shape[0]), data=film).gamma_correct(
    ).save_png(str(path))
    return str(path)


@pytest.mark.parametrize("name", sorted(card.GOLDENS))
def test_committed_render_holds_its_own_bars(name, tmp_path):
    """The committed render, written back as a film's PNG, reads its own
    linear mean and holds the bars; the same film 3% brighter is outside
    the mean's bar."""
    film = _golden_film(name)
    png = _save(film, tmp_path / "a.png")
    psnr, mean, want = card.golden_compare(png, card.GOLDENS[name])
    assert psnr == float("inf") and mean == pytest.approx(want, rel=1e-12)
    card.hold_golden(png, card.GOLDENS[name], card.GOLDEN_MIN_PSNR[name])
    png = _save(film * 1.03, tmp_path / "b.png")
    with pytest.raises(AssertionError, match="linear mean"):
        card.hold_golden(png, card.GOLDENS[name], card.GOLDEN_MIN_PSNR[name])


def test_golden_compare_refuses_another_view(tmp_path):
    """The 256^2 sphere render is held at its own resolution: its 512^2
    view does not compare."""
    film = torch.full((512, 512, 3), 0.2)
    png = _save(film, tmp_path / "a.png")
    with pytest.raises(AssertionError, match="512"):
        card.golden_compare(png, card.GOLDENS["sphere9812"])


@pytest.mark.parametrize("scale, holds", [(1.0, True), (1.1, False)])
def test_hold_golden_of_a_render(tmp_path, scale, holds):
    """A 16^2 beam render held against a golden that is the same render
    times ``scale``: the same image holds, a golden 10% brighter (a mean
    several % off once 8-bit) does not."""
    cam, scene = _small_sphere()
    own = tpt.render_film(cam, scene, 2, 5, backend="beam").data
    golden = _save(own * scale, tmp_path / "golden.png")
    png = _save(own, tmp_path / "own.png")
    if holds:
        card.hold_golden(png, golden, 30.0)
    else:
        with pytest.raises(AssertionError, match="linear mean"):
            card.hold_golden(png, golden, 30.0)


def test_hold_golden_refuses_noise_of_the_same_mean(tmp_path):
    """A film with the golden's mean but other pixels fails the PSNR
    bar."""
    film = _golden_film("garden105708")
    perm = torch.randperm(film.shape[0] * film.shape[1],
                          generator=torch.Generator().manual_seed(0))
    shuffled = film.reshape(-1, 3)[perm].reshape(film.shape)
    png = _save(shuffled, tmp_path / "a.png")
    with pytest.raises(AssertionError, match="PSNR"):
        card.hold_golden(png, card.GOLDENS["garden105708"],
                         card.GOLDEN_MIN_PSNR["garden105708"])


def _centre_hits(cam, scene):
    """The triangle index each pixel's centre ray hits, (H, W), film rows
    (bottom first)."""
    from pathtracer_tpu_torch.camera import get_rays
    from pathtracer_tpu_torch.ops.intersect import intersect_brute
    h, w = torch.meshgrid(torch.arange(cam.height), torch.arange(cam.width),
                          indexing="ij")
    half = torch.full(w.shape, 0.5)
    o, d = get_rays(cam, w, h, half, half)
    return intersect_brute(o, d, scene.v1, scene.v2, scene.v3)[1]


@pytest.mark.parametrize("ties", [True, False])
def test_light_check_takes_every_pixel_as_bright(ties):
    """The specular box at 32^2 with a wall pixel and a light pixel both
    saturated, the wall's first: with ``ties`` the light pixel holds the
    check; without, the first brightest pixel, the wall's, fails it."""
    cam, scene = tpt.modified_cornell(0.05, res=(32, 32), device="cpu")
    tid = _centre_hits(cam, scene)
    light = scene.mat_type[tid.clamp_min(0).long()] == tpt.EMIT
    lh, lw = (int(x) for x in light.nonzero()[-1])
    wall = (~light & (tid >= 0)).nonzero()
    wh, ww = (int(x) for x in wall[0])
    assert (wh, ww) < (lh, lw)          # the wall's is the first maximum
    img = np.zeros((32, 32, 3), np.uint8)
    img[31 - wh, ww] = img[31 - lh, lw] = 255
    if ties:
        assert card.brightest_sees_light(cam, scene, img, ties=True) == (
            lw, lh, 255.0)
    else:
        with pytest.raises(AssertionError, match="not the light"):
            card.brightest_sees_light(cam, scene, img)
