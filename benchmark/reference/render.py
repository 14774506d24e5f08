"""Plain path tracer: the reference the benchmark holds the program to.

Plain PyTorch, written from the renderer's published definitions (the
upstream's megakernel: jittered pinhole rays, forward accumulation of
``throughput * emission``, a diffuse bounce ``2 * albedo * cos`` with a
uniform hemisphere sample, a hit offset of ``1e-4`` along the normal, the
per-(pixel, sample) hash streams of ``rng.py``).  It traces chosen pixels
only, so a check costs a few seconds, and it sums each pixel's samples in
the order the renderer documents: the samples of one launch one by one,
then each launch's sum into the film.

``dtype`` is the precision of every per-path operation; float32 is the
configuration's, bfloat16 the control's (the film sums stay float32).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from . import rng
from .scenes import EMIT, SPECULAR, CameraArrays, SceneArrays

EPS = 1e-6
FLOAT_INF = 1e30
SHIFT_BIAS = 1e-4
SPECULAR_TRIES = 8
TWO_PI = float(np.float32(2.0 * math.pi))
RAYS_PER_CHUNK = 1 << 18


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def camera_params(cam: CameraArrays, device, dtype=torch.float32):
    """(16,) [pos, right, up, distance * forward, cell, v_res / 2,
    offset]."""
    f = np.float32
    vals = np.concatenate([cam.pos, cam.right, cam.up,
                           f(cam.distance) * cam.forward, [cam.cell],
                           cam.v_res * f(0.5), [f(cam.offset)]])
    return torch.from_numpy(vals.astype(np.float32)).to(device).to(dtype)


def primary_rays(cam: CameraArrays, cp, w, h, u1, u2, rsqrt: bool = False):
    """Jittered camera rays through pixels (w, h): (origin, unit dir)."""
    x = (w.to(cp.dtype) + cp[15] + u1) * cp[12] - cp[13]
    y = (h.to(cp.dtype) + cp[15] + u2) * cp[12] - cp[14]
    if rsqrt:
        d = torch.stack([x * cp[3] + y * cp[6] + cp[9],
                         x * cp[4] + y * cp[7] + cp[10],
                         x * cp[5] + y * cp[8] + cp[11]], dim=-1)
        d = d * torch.rsqrt(dot(d, d))[..., None]
    else:
        d = x[..., None] * cp[3:6] + y[..., None] * cp[6:9] + cp[9:12]
        d = d / torch.sqrt(dot(d, d))[..., None]
    return cp[0:3].expand(d.shape), d


def shade_table(sc: SceneArrays, device, dtype=torch.float32, albedo=None,
                emit=None):
    """(T, 12) [albedo, emit, roughness, unit normal, is_emit, is_spec];
    ``albedo``/``emit`` override the scene's (the recovery's
    parameters)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    v1, v2, v3 = t(sc.v1), t(sc.v2), t(sc.v3)
    n = cross(v2 - v1, v3 - v1)
    norm = torch.sqrt(dot(n, n))[:, None]
    n = n / torch.where(norm > 0, norm, 1.0)
    mtype = t(sc.mat_type)
    table = torch.cat([
        t(sc.albedo) if albedo is None else albedo,
        t(sc.emit) if emit is None else emit,
        t(sc.roughness)[:, None], n,
        (mtype == EMIT)[:, None].to(torch.float32),
        (mtype == SPECULAR)[:, None].to(torch.float32)], dim=-1)
    return table.to(dtype)


def gather(table, tid):
    """Rows of ``table`` by triangle id, zero on a miss.  Where a gradient
    flows into the table, the rows are gathered from a float64 copy, whose
    values are the same, so the backward sums every ray's contribution to
    a row in float64."""
    src = table.double() if table.requires_grad else table
    rows = src.index_select(0, tid.clamp_min(0).reshape(-1).to(torch.int64))
    rows = rows.to(table.dtype).reshape(tuple(tid.shape) + (table.shape[1],))
    return torch.where((tid >= 0)[..., None], rows, 0.0)


def _nearest(t, valid):
    t = torch.where(valid, t, FLOAT_INF)
    tid = torch.argmin(t, dim=-1).to(torch.int32)
    tmin = torch.amin(t, dim=-1)
    return tmin, torch.where(tmin < FLOAT_INF, tid, -1)


def plucker_rows(sc: SceneArrays, cam_pos) -> np.ndarray:
    """(T, 27) Plücker coefficient rows of the real triangles, in float64
    then rounded: [-N, N, -N.v1, -(e2 x v1), e2, -(v1 x e1), -e1,
    e2 x o - e2 x v1, -e1 x o - v1 x e1, N.o - N.v1, 0] for the camera
    position o, N = e1 x e2."""
    n = sc.num_tris
    v1 = sc.v1[:n].astype(np.float64)
    e1 = sc.v2[:n].astype(np.float64) - v1
    e2 = sc.v3[:n].astype(np.float64) - v1
    o = np.asarray(cam_pos, np.float64).reshape(1, 3)
    nrm = np.cross(e1, e2)
    kp = -np.cross(e2, v1)
    kq = -np.cross(v1, e1)
    me1 = -e1
    nv = -np.sum(nrm * v1, -1, keepdims=True)
    pc = np.cross(e2, np.broadcast_to(o, e2.shape)) + kp
    qc = np.cross(me1, np.broadcast_to(o, me1.shape)) + kq
    r0 = np.sum(nrm * o, -1, keepdims=True) + nv
    return np.concatenate([-nrm, nrm, nv, kp, e2, kq, me1, pc, qc, r0,
                           np.zeros_like(r0)], axis=-1).astype(np.float32)


def plucker_intersector(rows: torch.Tensor):
    """(intersect, primary_intersect) by the Plücker rows: with the ray
    moment c = o x d, a = Na.d, u*a = e2.c + kp.d, v*a = me1.c + kq.d,
    t*a = N.o + nv, summed left to right; at bounce 0 every ray starts at
    the camera and the sums collapse to pc.d, qc.d and r0."""
    r = [rows[:, i] for i in range(27)]

    def test(ray_o, ray_d, primary):
        d = ray_d[..., None, :]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        a = r[0] * dx + r[1] * dy + r[2] * dz
        f = 1.0 / a
        if primary:
            p = r[19] * dx + r[20] * dy + r[21] * dz
            q = r[22] * dx + r[23] * dy + r[24] * dz
            t = f * r[25]
        else:
            o = ray_o[..., None, :]
            ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
            cx = oy * dz - oz * dy
            cy = oz * dx - ox * dz
            cz = ox * dy - oy * dx
            p = (r[10] * cx + r[11] * cy + r[12] * cz
                 + r[7] * dx + r[8] * dy + r[9] * dz)
            q = (r[16] * cx + r[17] * cy + r[18] * cz
                 + r[13] * dx + r[14] * dy + r[15] * dz)
            t = f * (r[3] * ox + r[4] * oy + r[5] * oz + r[6])
        u = f * p
        v = f * q
        return _nearest(t, (torch.abs(a) >= EPS) & (u >= 0.0) & (v >= 0.0)
                        & (u + v <= 1.0) & (t > 0.0))

    return (lambda o, d: test(o, d, False)), (lambda o, d: test(o, d, True))


def mt_intersector(sc: SceneArrays, device, dtype=torch.float32,
                   pairs_per_chunk: int = 1 << 26):
    """Dense Möller–Trumbore against every real triangle, in chunks of
    rays: h = d x e2, a = e1.h, f = 1/a, s = o - v1, u = f s.h,
    q = s x e1, v = f d.q, t = f e2.q; the nearest hit is the first index
    of the minimum."""
    n = sc.num_tris
    v1 = torch.from_numpy(sc.v1[:n]).to(device)
    e1 = (torch.from_numpy(sc.v2[:n]).to(device) - v1).to(dtype)
    e2 = (torch.from_numpy(sc.v3[:n]).to(device) - v1).to(dtype)
    v1 = v1.to(dtype)
    chunk = max(1, pairs_per_chunk // max(n, 1))

    def one(o, d):
        o, d = o[:, None, :], d[:, None, :]
        h = cross(d, e2)
        a = dot(e1, h)
        f = 1.0 / a
        s = o - v1
        u = f * dot(s, h)
        q = cross(s, e1)
        v = f * dot(d, q)
        t = f * dot(e2, q)
        return _nearest(t, (torch.abs(a) >= EPS) & (u >= 0.0) & (u <= 1.0)
                        & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0))

    def intersect(o, d):
        shape = o.shape[:-1]
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        parts = [one(o[r:r + chunk], d[r:r + chunk])
                 for r in range(0, o.shape[0], chunk)]
        return (torch.cat([p[0] for p in parts]).reshape(shape),
                torch.cat([p[1] for p in parts]).reshape(shape))

    return intersect


def hemisphere(u, v, normal):
    x = 2.0 * u - 1.0
    ct = torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0))
    phi = TWO_PI * v
    sample = torch.stack([ct * torch.cos(phi), ct * torch.sin(phi), -x],
                         dim=-1)
    return sample * torch.where(dot(sample, normal)[..., None] < 0.0, -1.0,
                                1.0).to(sample.dtype)


def specular(ray_d, normal, rough, cube):
    reflected = ray_d - normal * (2.0 * dot(ray_d, normal))[..., None]
    chosen = reflected
    for k in range(cube.shape[0] - 1, -1, -1):
        cand = reflected + (cube[k] - 0.5) * rough[..., None]
        chosen = torch.where(dot(cand, normal)[..., None] >= 0.0, cand,
                             chosen)
    return chosen / torch.sqrt(dot(chosen, chosen))[..., None]


def trace(table, intersect, primary, ray_o, ray_d, depth, state,
          has_specular, live: Optional[List[torch.Tensor]] = None):
    """Radiance (..., 3) of a ray batch, the bounce loop with forward
    accumulation; ``live`` receives each bounce's alive mask."""
    dtype = ray_d.dtype
    thr = torch.ones_like(ray_o)
    rad = torch.zeros_like(ray_o)
    alive = torch.ones(ray_o.shape[:-1], dtype=torch.bool,
                       device=ray_o.device)
    for b in range(depth):
        if live is not None:
            live.append(alive)
        # Hits are discrete: the intersection gets detached rays.
        t, tid = (primary if b == 0 and primary is not None
                  else intersect)(ray_o.detach(), ray_d.detach())
        hit = (tid >= 0) & alive
        hitm = hit[..., None]
        feat = gather(table, torch.where(hit, tid, -1))
        albedo, emit, rough = feat[..., 0:3], feat[..., 3:6], feat[..., 6]
        n_geo = feat[..., 7:10]
        is_emit, is_spec = feat[..., 10] > 0.5, feat[..., 11] > 0.5
        rad = rad + torch.where(hitm, thr * emit, 0.0)
        cont = hit & ~is_emit
        contm = cont[..., None]
        n = torch.where((dot(n_geo, ray_d) < 0.0)[..., None], n_geo, -n_geo)
        state, u = rng.rand01(state, dtype)
        state, v = rng.rand01(state, dtype)
        new_d = hemisphere(u, v, n)
        if has_specular:
            cube = []
            for _ in range(3 * SPECULAR_TRIES):
                state, c = rng.rand01(state, dtype)
                cube.append(c)
            cube = torch.movedim(torch.stack(cube).reshape(
                (SPECULAR_TRIES, 3) + tuple(u.shape)), 1, -1)
            new_d = torch.where(is_spec[..., None],
                                specular(ray_d, n, rough, cube), new_d)
        cos = dot(n, new_d)
        thr = thr * torch.where(contm, 2.0 * albedo * cos[..., None], 1.0)
        hit_p = ray_o + ray_d * t[..., None]
        ray_o = torch.where(contm, hit_p + n * SHIFT_BIAS, ray_o)
        ray_d = torch.where(contm, new_d, ray_d)
        alive = cont
    return rad


class PixelTracer:
    """The plain path tracer of one scene and camera, over chosen pixels.

    ``loop`` is the intersection: ``"plucker"`` (the coefficient rows
    with the bounce-0 collapse) or ``"mt"`` (dense Möller–Trumbore)."""

    def __init__(self, sc: SceneArrays, cam: CameraArrays, device,
                 loop: str = "plucker", dtype=torch.float32):
        self.sc, self.cam, self.device, self.dtype = sc, cam, device, dtype
        self.cp = camera_params(cam, device, dtype)
        self.table = shade_table(sc, device, dtype)
        self.has_specular = bool(np.any(sc.mat_type[:sc.num_tris]
                                        == SPECULAR))
        if loop == "plucker":
            rows = torch.from_numpy(plucker_rows(sc, cam.pos)).to(device)
            self.intersect, self.primary = plucker_intersector(
                rows.to(dtype))
        elif loop == "mt":
            self.intersect, self.primary = mt_intersector(sc, device,
                                                          dtype), None
        else:
            raise ValueError(f"unknown loop {loop!r}")

    def radiance(self, w, h, sidx, depth, seed, table=None, live=None):
        """Radiance (..., 3) of the paths (w, h, sidx), three broadcastable
        integer tensors of pixel column, row and sample index."""
        state = rng.sample_seed(w, h, self.cam.height, sidx, seed)
        state, u1 = rng.rand01(state, self.dtype)
        state, u2 = rng.rand01(state, self.dtype)
        o, d = primary_rays(self.cam, self.cp, w, h, u1, u2)
        return trace(self.table if table is None else table, self.intersect,
                     self.primary, o, d, depth, state, self.has_specular,
                     live)

    def film(self, w, h, samples: int, depth: int, seed: int,
             launch_spp: int) -> torch.Tensor:
        """(P, 3) float32 mean radiance over the samples [0, samples) of
        the pixels (w, h) (P,): per launch of
        ``launch_spp`` samples the samples added one by one, each launch's
        sum added to the film, the film divided by ``samples``."""
        film = torch.zeros((w.shape[0], 3), dtype=torch.float32,
                           device=self.device)
        acc = torch.zeros_like(film)
        per_chunk = max(1, RAYS_PER_CHUNK // max(w.shape[0], 1))
        with torch.no_grad():
            for c0 in range(0, samples, per_chunk):
                n = min(per_chunk, samples - c0)
                sidx = torch.arange(c0, c0 + n, device=self.device)
                rad = self.radiance(w[None], h[None], sidx[:, None], depth,
                                    seed).float()
                for k in range(n):
                    acc = acc + rad[k]
                    done = c0 + k + 1
                    if done % launch_spp == 0 or done == samples:
                        film = film + acc
                        acc = torch.zeros_like(film)
        return film / samples

    def path_lengths(self, w, h, sidx, depth, seed) -> torch.Tensor:
        """int64 segments each path (w, h, sidx) traces while alive."""
        live = []
        with torch.no_grad():
            self.radiance(w, h, sidx, depth, seed, live=live)
        return sum(m.to(torch.int64) for m in live)
