"""pathtracer_tpu_torch against the reference renderer's own image, and the
port's examples.

The golden, ``docs/mod0.05.png``, is the reference's ``modified_cornell``
sweep image at roughness 0.05: 1024^2, 10k spp, depth 5, gamma 2.2, 8 bit.
The port renders the same view at 64^2 with the brute backend on the CPU.
A camera sample of pixel w lands in [w + pixel_offset, w + pixel_offset + 1)
of the image plane, pixel_offset = 0.5, so a 64^2 pixel covers a 16 x 16
block of the golden shifted by 8 golden pixels; the golden is averaged over
those shifted blocks in linear space, and the port's film is clamped to
[0, 1] as the 8-bit golden is.

Bars, set from runs on the CPU at 256 spp: the linear means within 3%
(measured +0.51% at seed 1, +2.12% at seed 2); the brightest pixel (first
maximum of the clamped luminance) at the same 64^2 pixel (measured: the
same pixel, on the light panel).
"""

import os

import numpy as np

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.examples import cornell_box, modified_cornell
from pathtracer_tpu_torch.examples import sphere_obj

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "docs", "mod0.05.png")
RES = 64
SPP = 256
MEAN_RTOL = 0.03


def test_modified_cornell_matches_the_reference_image():
    golden = (tpt.read_png(GOLDEN).astype(np.float64) / 255.0) ** 2.2
    k = golden.shape[0] // RES                       # 16 golden px per pixel
    half = k // 2
    # Image rows run top to bottom; film row h is image row RES - 1 - h.
    # Port image pixel (r, c), r >= 1 and c < RES - 1, covers golden rows
    # [k r - half, k r + half) and columns [k c + half, k c + k + half).
    blocks = golden[half:-half, half:-half].reshape(
        RES - 1, k, RES - 1, k, 3).mean(axis=(1, 3))
    cam, scene = tpt.modified_cornell(0.05, res=(RES, RES), device="cpu")
    film = tpt.render_film(cam, scene, SPP, 5, backend="brute")
    img = np.minimum(film.data.numpy().astype(np.float64)[::-1], 1.0)
    img = img[1:, :RES - 1]
    assert abs(img.mean() / blocks.mean() - 1.0) <= MEAN_RTOL, (
        img.mean(), blocks.mean())
    lum, glum = img.mean(-1), blocks.mean(-1)
    assert (np.unravel_index(lum.argmax(), lum.shape)
            == np.unravel_index(glum.argmax(), glum.shape))
    assert lum.max() == 1.0 and glum.max() > 0.99   # the light panel


def test_sphere_obj_example_runs(tmp_path):
    out = str(tmp_path / "sphere.png")
    sphere_obj.main([out, "--n-lat", "10", "--n-lon", "20", "--res", "16",
                     "--spp", "1", "--device", "cpu"])
    img = tpt.read_png(out)
    assert img.shape == (16, 16, 3)


def test_cornell_examples_run(tmp_path):
    out = str(tmp_path / "cb.png")
    cornell_box.main([out, "--res", "8", "--spp", "1", "--device", "cpu"])
    assert tpt.read_png(out).shape == (8, 8, 3)
    prefix = str(tmp_path / "mod")
    modified_cornell.main([prefix, "--res", "8", "--spp", "1", "--depth",
                           "2", "--device", "cpu"])
    for r in modified_cornell.ROUGHNESS:
        assert tpt.read_png(f"{prefix}{r:g}.png").shape == (8, 8, 3)
