"""Vector math on batched tensors (L1), the PyTorch counterpart of
``pathtracer_tpu/linalg.py``.

Vectors are tensors whose trailing dimension is 3.  ``dot`` is written out
component by component, so its sum order is fixed at ``(x + y) + z`` on
every device; the CUDA kernel (``csrc/trace_kernel.cu``) adds in the same
order, which keeps it bit-comparable with the plain path.
"""

from __future__ import annotations

import math

import torch

DEG2RAD = math.pi / 180.0
EPS = 1e-6
FLOAT_INF = 1e30
SHIFT_BIAS = 1e-4  # hit-point offset along the normal


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched vec3 dot product over the trailing dimension."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched vec3 cross product over the trailing dimension."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Unit vector along ``a``; no epsilon guard, as in the reference."""
    return a / torch.sqrt(dot(a, a))[..., None]
