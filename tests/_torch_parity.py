"""Helpers for the tests that hold pathtracer_tpu_torch against pathtracer_tpu.

Scenes and cameras are built once by the JAX package and carried across as
numpy arrays (``pathtracer_tpu_torch.convert``), so both packages render the
identical scene.
"""

import numpy as np
import torch

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt

CAMERA_FIELDS = ("pos", "forward", "up", "right", "world_up", "v_res",
                 "cell_size", "distance")
SCENE_FIELDS = ("v1", "v2", "v3", "mat_type", "albedo", "emit", "roughness")

# Film tolerance: the JAX package's own bar for its kernel against its
# oracle (tests/test_pallas.py, atol 2e-4 on 16^2 films at 2-4 spp).
FILM_ATOL = 2e-4
# Share of pixels allowed beyond FILM_ATOL.  XLA's and PyTorch's CPU float32
# kernels differ by one ulp on some inputs (sin/cos in ~5% of inputs, rsqrt
# and sqrt less often), and a one-ulp change can flip a near-tie hit, which
# changes that path's radiance by O(1 / spp).  Measured: Cornell box, 24^2,
# 4 spp, depth 5: 2 of 576 pixels (0.35%); 64^2, 8 spp, depth 5: 3 of 4096
# (0.07%); every 16^2 and 32^2 film of these tests: 0.  The bar is 1%.
MAX_FLIP_SHARE = 0.01

SCENES = {
    "corner": lambda res: jpt.corner_scene(res=res),
    "cornell": lambda res: jpt.cornell_box(res=res),
    "specular": lambda res: jpt.modified_cornell(0.3, res=res),
}


def carry(jcam, jscene, device="cpu"):
    """The port's (Camera, Scene) for a pathtracer_tpu camera and scene."""
    cam = tpt.camera_from_arrays(
        *(np.asarray(getattr(jcam, f)) for f in CAMERA_FIELDS),
        jcam.res, jcam.pixel_offset, device=device)
    scene = tpt.scene_from_arrays(
        *(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS),
        jscene.num_tris, device=device)
    return cam, scene


def scene_pair(name, res):
    jcam, jscene = SCENES[name](res)
    return (jcam, jscene), carry(jcam, jscene)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_films_close(got, ref, atol=FILM_ATOL, max_flip_share=MAX_FLIP_SHARE):
    """Every pixel within ``atol`` except at most ``max_flip_share`` of the
    pixels (near-tie flips, see MAX_FLIP_SHARE)."""
    got, ref = as_np(got), as_np(ref)
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got))
    bad = np.any(np.abs(got - ref) > atol, axis=-1)
    assert bad.sum() <= int(max_flip_share * bad.size), (
        f"{bad.sum()} of {bad.size} pixels beyond {atol}: max diff "
        f"{np.abs(got - ref).max()}")
