"""pathtracer_tpu_torch's PNG files and checkpoint names against
pathtracer_tpu on the CPU: the counterparts of tests/test_image.py and
tests/test_checkpoint.py for what tests/test_torch_scene.py does not
already hold (it holds a 17 x 23 PNG and the shared render checkpoint
layout)."""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu import image as jimage
from pathtracer_tpu.utils import checkpoint as jckpt

from pathtracer_tpu_torch import image as timage
from pathtracer_tpu_torch.utils import checkpoint as tckpt


@pytest.mark.parametrize("h,w", [(1, 1), (7, 5), (3, 130)])
def test_png_round_trip_across_packages(tmp_path, h, w):
    """A PNG either package writes reads back the same bytes in both, at a
    single pixel, an odd shape and a wide strip."""
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                 dtype=np.uint8)
    ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    timage.write_png(ours, img)
    jimage.write_png(theirs, img)
    for path in (ours, theirs):
        np.testing.assert_array_equal(timage.read_png(path), img)
        np.testing.assert_array_equal(jimage.read_png(path), img)


@pytest.mark.parametrize("name", ["ck", "ck.npz", "run.v2/ck"])
def test_checkpoint_path_names_the_file_savez_writes(tmp_path, name):
    """checkpoint_path gives the file np.savez writes for a path, so a
    render checkpoint the JAX package saved under any of these names loads
    in the port."""
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    film = np.random.default_rng(2).random((3, 4, 3), dtype=np.float32)
    meta = {"width": 4, "height": 3, "samples": 16}
    jckpt.save_render_checkpoint(str(path), film, 9, meta)
    written = tckpt.checkpoint_path(str(path))
    assert written.endswith(".npz") and os.path.exists(written)
    got, done, got_meta = tckpt.load_render_checkpoint(str(path))
    np.testing.assert_array_equal(got, film)
    assert (done, got_meta) == (9, meta)
    tckpt.save_render_checkpoint(str(path), torch.from_numpy(film), 10, meta)
    assert jckpt.load_render_checkpoint(written)[1] == 10
