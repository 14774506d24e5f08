"""Pinhole camera (L2), the PyTorch counterpart of ``pathtracer_tpu/camera.py``.

``Camera`` is a frozen dataclass of tensors; ``get_rays`` is batched over
pixel coordinates and jitter uniforms.  ``rotate`` / ``move`` return a new
camera.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .linalg import cross, normalize

FORWARD, BACKWARD, LEFT, RIGHT, UP, DOWN = range(6)

_TENSOR_FIELDS = ("pos", "forward", "up", "right", "world_up", "v_res",
                  "cell_size", "distance")


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: torch.Tensor        # (3,)
    forward: torch.Tensor    # (3,) unit
    up: torch.Tensor         # (3,) unit
    right: torch.Tensor      # (3,) unit
    world_up: torch.Tensor   # (3,) unit, the fixed yaw axis
    v_res: torch.Tensor      # (2,) image-plane size
    cell_size: torch.Tensor  # () v_res.x / res.x
    distance: torch.Tensor   # () image-plane distance
    res: Tuple[int, int]     # (width, height)
    # Sub-pixel convention of the reference GPU megakernel: rays go through
    # (w + 0.5 + u) * cell, gl_FragCoord's half-pixel offset plus the jitter.
    pixel_offset: float = 0.5

    @property
    def width(self) -> int:
        return self.res[0]

    @property
    def height(self) -> int:
        return self.res[1]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def to(self, device) -> "Camera":
        new = dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS})
        if hasattr(self, "_host_pos"):
            object.__setattr__(new, "_host_pos", self._host_pos)
        return new

    def host_pos(self) -> np.ndarray:
        """The (3,) float32 position on the host: from the copy the
        constructors keep (carried by ``to``, so reading it never waits for
        the device), else copied from ``pos``.  A camera made by
        ``dataclasses.replace`` (``move``, ``rotate``) keeps no copy."""
        cached = getattr(self, "_host_pos", None)
        return cached if cached is not None else self.pos.cpu().numpy()


def _with_host_pos(cam: Camera, pos: np.ndarray) -> Camera:
    object.__setattr__(cam, "_host_pos",
                       np.array(pos, np.float32).reshape(3))
    return cam


def make_camera(pos, forward, up, res, fov, distance=1.0,
                pixel_offset=0.5, device="cuda") -> Camera:
    """Build a camera on ``device``.  ``fov`` is the horizontal field of
    view in radians; ``res`` is (width, height)."""
    pos = np.asarray(pos, np.float32)
    forward = np.asarray(forward, np.float32)
    up = np.asarray(up, np.float32)

    fwd = forward / np.linalg.norm(forward)
    upn = up / np.linalg.norm(up)
    if abs(float(np.dot(fwd, upn))) > 0.999:
        raise ValueError("Up vector is too close to forward vector")
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)

    w, h = int(res[0]), int(res[1])
    vx = 2.0 * distance * math.tan(fov / 2.0)
    vy = vx * h / w

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return _with_host_pos(Camera(
        pos=t(pos),
        forward=t(fwd),
        up=t(upn),
        right=t(right),
        world_up=t(upn),
        v_res=t([vx, vy]),
        cell_size=t(vx / w),
        distance=t(distance),
        res=(w, h),
        pixel_offset=float(pixel_offset),
    ), pos)


def get_rays(cam: Camera, w, h, u1, u2):
    """Batched primary rays.

    w, h: integer pixel coordinates; u1, u2: jitter uniforms in [0, 1), all
    broadcastable.  Returns (ray_o, ray_d), each (..., 3), ray_d unit.  The
    world direction is x * right + y * up + distance * forward.
    """
    off = cam.pixel_offset
    x = (w.to(torch.float32) + off + u1) * cam.cell_size - cam.v_res[0] * 0.5
    y = (h.to(torch.float32) + off + u2) * cam.cell_size - cam.v_res[1] * 0.5
    d = normalize(x[..., None] * cam.right + y[..., None] * cam.up
                  + cam.distance * cam.forward)
    return cam.pos.expand(d.shape), d


def rotate(cam: Camera, direction: int, angle: float) -> Camera:
    """FPS-style rotation: yaw about world_up, pitch about right.  Only
    elementwise float32 operations touch the camera (the cosine and sine
    of the float32 angle are taken on the host, ``linalg.normalize`` sums
    in a fixed order), so a turn gives the same bits on every device."""
    a = float(np.float32(angle))
    c, s = math.cos(a), math.sin(a)
    fwd, up, right = cam.forward, cam.up, cam.right
    if direction == LEFT:
        fwd = normalize(fwd * c - right * s)
        right = normalize(cross(fwd, cam.world_up))
        up = normalize(cross(right, fwd))
    elif direction == RIGHT:
        fwd = normalize(fwd * c + right * s)
        right = normalize(cross(fwd, cam.world_up))
        up = normalize(cross(right, fwd))
    elif direction == UP:
        fwd = normalize(fwd * c + up * s)
        up = normalize(cross(right, fwd))
    elif direction == DOWN:
        fwd = normalize(fwd * c - up * s)
        up = normalize(cross(right, fwd))
    return dataclasses.replace(cam, forward=fwd, up=up, right=right)


def move(cam: Camera, direction: int, amount: float) -> Camera:
    """Translation relative to world_up / right."""
    pos = cam.pos
    if direction == UP:
        pos = pos + cam.world_up * amount
    elif direction == DOWN:
        pos = pos - cam.world_up * amount
    elif direction == FORWARD:
        pos = pos + normalize(cross(cam.world_up, cam.right)) * amount
    elif direction == BACKWARD:
        pos = pos - normalize(cross(cam.world_up, cam.right)) * amount
    elif direction == LEFT:
        pos = pos - cam.right * amount
    elif direction == RIGHT:
        pos = pos + cam.right * amount
    return dataclasses.replace(cam, pos=pos)
