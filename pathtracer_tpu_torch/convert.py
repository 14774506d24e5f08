"""Build the port's ``Camera`` / ``Scene`` / material parameters from numpy
arrays.

The arrays may come from any source, for example ``np.asarray`` of each
field of a ``pathtracer_tpu`` camera or scene, of its material parameters
(``inverse.init_params``) or of a JAX train checkpoint's ``params:i``
arrays: that carries one scene or one optimizer's state across the two
packages unchanged, which is how the port is held against the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .camera import Camera, _with_host_pos
from .scene import Scene


def scene_from_arrays(v1, v2, v3, mat_type, albedo, emit, roughness,
                      num_tris: int, *, device="cuda") -> Scene:
    """Padded (T, 3) vertex arrays, (T,) material types, (T, 3) albedo and
    emission and (T,) roughness -> a ``Scene`` on ``device``."""
    return Scene.from_arrays(v1, v2, v3, mat_type, albedo, emit, roughness,
                             num_tris, device=device)


def camera_from_arrays(pos, forward, up, right, world_up, v_res, cell_size,
                       distance, res, pixel_offset=0.5, *,
                       device="cuda") -> Camera:
    """Camera fields as arrays (vectors (3,), v_res (2,), scalars ()) ->
    a ``Camera`` on ``device``."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return _with_host_pos(
        Camera(pos=t(pos), forward=t(forward), up=t(up), right=t(right),
               world_up=t(world_up), v_res=t(v_res), cell_size=t(cell_size),
               distance=t(distance), res=(int(res[0]), int(res[1])),
               pixel_offset=float(pixel_offset)), pos)


def material_params_from_arrays(arrays: Mapping[str, np.ndarray], *,
                                device="cuda") -> Dict[str, torch.Tensor]:
    """{name: array} of material parameters (``albedo`` (T, 3), ``emit``
    (T, 3), ``roughness`` (T,), physical or unconstrained) -> the same
    names as float32 tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in arrays.items()}
