"""Ray-scene intersection, the PyTorch counterpart of
``pathtracer_tpu/ops/intersect.py::intersect_brute``.

Dense Möller–Trumbore of every ray against every triangle.  Invalid
candidates are masked to FLOAT_INF and the nearest hit is the FIRST index
of the minimum, the tie rule the CUDA kernel's strict ``t < best_t`` in
triangle order reproduces.
"""

from __future__ import annotations

import torch

from ..linalg import EPS, FLOAT_INF, cross, dot


def intersect_brute(ray_o, ray_d, v1, v2, v3):
    """ray_o, ray_d: (..., 3); v1, v2, v3: (T, 3).

    Returns (t, tid): t (...,) nearest positive hit or FLOAT_INF; tid (...,)
    int32 triangle index or -1.  Degenerate (padding) triangles fail the
    |det| < EPS test.
    """
    e1 = v2 - v1
    e2 = v3 - v1
    d = ray_d[..., None, :]
    o = ray_o[..., None, :]

    h = cross(d, e2)               # (..., T, 3)
    a = dot(e1, h)
    f = 1.0 / a                    # inf where degenerate; masked below
    s = o - v1
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(d, q)
    t = f * dot(e2, q)

    valid = ((torch.abs(a) >= EPS)
             & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0)
             & (t > 0.0))
    t = torch.where(valid, t, FLOAT_INF)
    tid = torch.argmin(t, dim=-1).to(torch.int32)
    tmin = torch.amin(t, dim=-1)
    tid = torch.where(tmin < FLOAT_INF, tid, -1)
    return tmin, tid
