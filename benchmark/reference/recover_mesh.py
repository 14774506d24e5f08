"""Plain material recovery on a large mesh: ``recover.Recovery`` over a
grouped intersection.

``Recovery`` tests every ray against every triangle, which on the
105,708-triangle garden costs minutes a step.  Here a ray tests only the
triangles of the boxes it enters (``nearest_hits``: the boxes of
``realtime.grouped_intersector``, under a second level of boxes), whose
hits are the dense test's bit for bit.  The rest is ``Recovery``'s: the
paired loss over two half-sample films, the detached rays, the float64
gather of the backward, the masked Adam.  ``step_from`` takes one step
from a given state (the parameters, Adam's moments and count), so a check
can follow a step from the middle of a run without replaying the steps
before it.

Departures from the source (the JAX package's garden recovery in
``bench_invert.py``): the target is rendered by this reference at the
traffic's ``target_samples``, not by the beam route at 8192 samples, and
the learning rate is constant, with no cosine decay: a window has one
learning rate, as ``cornell_recover``'s has.

In bfloat16 (the control) the paths are bfloat16 and the hits are the
grouped test's in float32 of the bfloat16 rays: dense bfloat16
Möller–Trumbore against 105,708 triangles would take minutes a step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .realtime import BOX_MARGIN, GROUP, _morton_order
from .recover import ADAM_EPS, BETAS, NAMES, Recovery
from .render import EPS, FLOAT_INF, PixelTracer, cross, dot
from .scenes import CameraArrays, SceneArrays

TOP = 32                  # boxes of GROUP triangles under one top box
RAYS_PER_BATCH = 1 << 15


def _slab(o, inv, lo, hi):
    """Whether rays (o, 1 / d) enter boxes [lo, hi], broadcasting."""
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    near = torch.amax(torch.minimum(t1, t2), dim=-1)
    far = torch.amin(torch.maximum(t1, t2), dim=-1)
    return (far >= 0.0) & (near <= far)


def nearest_hits(sc: SceneArrays, device, rays_per_batch=RAYS_PER_BATCH):
    """The nearest hits (t, tid) of ``render.mt_intersector`` in float32,
    bit for bit.  The triangles and their boxes are
    ``realtime.grouped_intersector``'s: runs of GROUP along a Z-order curve
    of the centroids, each under one box widened by BOX_MARGIN, which holds
    every triangle a ray entering no other box can hit.  Above them, runs
    of TOP boxes go under one top box, their union.  A ray tests the boxes
    under the top boxes it enters and the triangles of the boxes it enters,
    as lists of (ray, box) and (ray, triangle) pairs, each pair with the
    dense test's arithmetic; then per ray the nearest t, ties to the lowest
    triangle index."""
    n = sc.num_tris

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[:n])).to(device)

    v1, v2, v3 = t(sc.v1), t(sc.v2), t(sc.v3)
    e1, e2 = v2 - v1, v3 - v1
    n_groups = -(-n // GROUP)
    members = torch.full((n_groups * GROUP,), -1, dtype=torch.int64,
                         device=device)
    members[:n] = _morton_order((v1 + v2 + v3) / 3.0)
    members = members.reshape(n_groups, GROUP)
    slots = torch.where(members >= 0, members, members[:, :1])
    lo = torch.minimum(torch.minimum(v1, v2), v3)[slots].amin(dim=1)
    hi = torch.maximum(torch.maximum(v1, v2), v3)[slots].amax(dim=1)
    lo, hi = lo - BOX_MARGIN, hi + BOX_MARGIN
    n_top = -(-n_groups // TOP)
    last = torch.arange(n_top * TOP, device=device).clamp_max(n_groups - 1)
    top_lo = lo[last].reshape(n_top, TOP, 3).amin(dim=1)
    top_hi = hi[last].reshape(n_top, TOP, 3).amax(dim=1)
    under = torch.arange(TOP, device=device)
    in_group = torch.arange(GROUP, device=device)

    def one(o, d):
        m = o.shape[0]
        inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
        r, top = torch.nonzero(_slab(o[:, None], inv[:, None], top_lo[None],
                                     top_hi[None]), as_tuple=True)
        g = (top[:, None] * TOP + under).reshape(-1)
        r = r[:, None].expand(-1, TOP).reshape(-1)
        real = g < n_groups
        r, g = r[real], g[real]
        inside = _slab(o[r], inv[r], lo[g], hi[g])
        r, g = r[inside], g[inside]
        tri = members[g].reshape(-1)
        ray = r[:, None].expand(-1, GROUP).reshape(-1)
        real = tri >= 0
        tri, ray = tri[real], ray[real]
        od, oo = d[ray], o[ray]
        a_e1, a_e2 = e1[tri], e2[tri]
        h = cross(od, a_e2)
        a = dot(a_e1, h)
        f = 1.0 / a
        s = oo - v1[tri]
        u = f * dot(s, h)
        q = cross(s, a_e1)
        v = f * dot(od, q)
        tt = f * dot(a_e2, q)
        valid = ((torch.abs(a) >= EPS) & (u >= 0.0) & (u <= 1.0)
                 & (v >= 0.0) & (u + v <= 1.0) & (tt > 0.0))
        tt = torch.where(valid, tt, FLOAT_INF)
        tmin = torch.full((m,), FLOAT_INF, dtype=tt.dtype, device=device)
        tmin = tmin.scatter_reduce(0, ray, tt, "amin")
        at = tt == tmin[ray]
        tid = torch.full((m,), n, dtype=torch.int64, device=device)
        tid = tid.scatter_reduce(0, ray[at], tri[at], "amin")
        return tmin, torch.where(tmin < FLOAT_INF, tid, -1).to(torch.int32)

    def intersect(o, d):
        shape = o.shape[:-1]
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        parts = [one(o[b:b + rays_per_batch], d[b:b + rays_per_batch])
                 for b in range(0, o.shape[0], rays_per_batch)]
        return (torch.cat([p[0] for p in parts]).reshape(shape),
                torch.cat([p[1] for p in parts]).reshape(shape))

    return intersect


def intersector(sc: SceneArrays, device, dtype=torch.float32):
    """``nearest_hits``, its t in ``dtype``."""
    fn = nearest_hits(sc, device)
    if dtype == torch.float32:
        return fn

    def intersect(o, d):
        t, tid = fn(o.float(), d.float())
        return t.to(dtype), tid
    return intersect


def tracer(sc: SceneArrays, cam: CameraArrays, device,
           dtype=torch.float32) -> PixelTracer:
    """The plain path tracer of the scene over the grouped intersection."""
    tr = PixelTracer(sc, cam, device, loop="mt", dtype=dtype)
    tr.intersect = intersector(sc, device, dtype)
    return tr


class MeshRecovery(Recovery):
    """``Recovery`` over the grouped intersection.  Matmuls stay in full
    float32 (no TF32), as a float32 reference must."""

    def __init__(self, sc: SceneArrays, cam: CameraArrays, target, **kw):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(sc, cam, target, **kw)
        self.tracer.intersect = intersector(sc, self.device, self.dtype)

    def step_from(self, params, m, v, t: int, k: int):
        """One masked Adam step from the parameters ``params`` and Adam's
        moments ``m``, ``v`` after ``t`` steps, tracing the sample windows
        of step ``k``: (loss, parameters, m, v after), in ``run``'s
        arithmetic."""
        p, m, v = dict(params), dict(m), dict(v)
        loss, g = self.value_and_grad(p, k)
        t = t + 1
        for n in NAMES:
            m[n] = BETAS[0] * m[n] + (1 - BETAS[0]) * g[n]
            v[n] = BETAS[1] * v[n] + (1 - BETAS[1]) * g[n] * g[n]
            step = self.lr / (1 - BETAS[0] ** t)
            denom = (torch.sqrt(v[n]) / math.sqrt(1 - BETAS[1] ** t)
                     + ADAM_EPS)
            new = p[n] - step * m[n] / denom
            p[n] = torch.where(self.masks[n] > 0, new, p[n])
        return loss, p, m, v
