"""Plain realtime viewer: the camera keys and the accumulation state
machine of the upstream's ``render_realtime`` (render.h:219-387), over the
coherent-beam reference.

Written from the upstream's description of its viewer:
  * a turn swings ``forward`` by 5 degrees toward ``right`` or ``-right``
    (left, right: the yaw; ``right`` stays level, so this is a turn about
    ``world_up`` while the camera is level) or toward ``up`` or ``-up``
    (up, down: the pitch about ``right``); the basis is then rebuilt,
    ``right = forward x world_up`` after a yaw and ``up = right x forward``
    after either, each normalised (camera.h:77-107);
  * a move steps 1.0 along the level forward ``world_up x right`` (w, s),
    along ``right`` (a, d) or along ``world_up`` (space, z)
    (camera.h:108-141); ``r`` restores the first camera;
  * every key that changes the camera clears the film; frame k after the
    clear renders at seed ``seed + k`` and is blended as
    ``mix(prev, cur, 1 / (k + 1))`` (shader.h:299-304) in float32, and the
    display is ``clamp_min(0) ** (1 / 2.2)`` of the blend.

Cameras are float32 numpy (``scenes.CameraArrays``).  The films are
``beam.BeamTracer.film``'s at the chosen pixels, bit for bit, by two
equivalents that cut its Python calls: ``SampleBeamTracer`` traces a
launch's samples in one pass, and ``grouped_intersector`` returns the
dense test's nearest hits testing each ray only against the triangles of
the boxes it enters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import rng
from .beam import BeamTracer, tile_of
from .render import (EPS, FLOAT_INF, SHIFT_BIAS, TWO_PI, cross, dot,
                     primary_rays)
from .scenes import CameraArrays, SceneArrays

TURN = math.radians(5.0)
STEP = 1.0
TURNS = ("left", "right", "up", "down")
MOVES = ("w", "s", "a", "d", "space", "z")
GROUP = 32           # triangles under one box of the grouped test
BOX_MARGIN = 1.0     # scene units added around each box


def _unit(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.float32)
    return v / np.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], np.float32)


def rotate(cam: CameraArrays, world_up: np.ndarray, key: str,
           angle: float = TURN) -> CameraArrays:
    """The camera after one turn key."""
    c = np.float32(math.cos(float(np.float32(angle))))
    s = np.float32(math.sin(float(np.float32(angle))))
    toward = {"left": -cam.right, "right": cam.right, "up": cam.up,
              "down": -cam.up}[key]
    fwd = _unit(cam.forward * c + toward * s)
    right = cam.right
    if key in ("left", "right"):
        right = _unit(_cross(fwd, world_up))
    up = _unit(_cross(right, fwd))
    return dataclasses.replace(cam, forward=fwd, up=up, right=right)


def move(cam: CameraArrays, world_up: np.ndarray, key: str,
         amount: float = STEP) -> CameraArrays:
    """The camera after one move key."""
    level = _unit(_cross(world_up, cam.right))
    along = {"w": level, "s": -level, "a": -cam.right, "d": cam.right,
             "space": world_up, "z": -world_up}[key]
    return dataclasses.replace(
        cam, pos=(cam.pos + along * np.float32(amount)).astype(np.float32))


def camera_after(cam0: CameraArrays, keys: Sequence[str]) -> CameraArrays:
    """The camera after the key presses ``keys`` from ``cam0`` (whose
    ``up`` is the world's up); keys that do not move it are skipped."""
    world_up = cam0.up
    cam = cam0
    for k in keys:
        if k in TURNS:
            cam = rotate(cam, world_up, k)
        elif k in MOVES:
            cam = move(cam, world_up, k)
        elif k == "r":
            cam = cam0
    return cam


def blend(films: Sequence[torch.Tensor]) -> torch.Tensor:
    """The running mean of the frames since a clear, in the viewer's
    float32 order: ``acc * (1 - t) + cur * t`` with ``t = 1 / (k + 1)``."""
    acc = torch.zeros_like(films[0])
    for k, cur in enumerate(films):
        t = 1.0 / (k + 1)
        acc = acc * (1.0 - t) + cur * t
    return acc


def tone(film: torch.Tensor) -> torch.Tensor:
    """The displayed values of a linear film."""
    return torch.clamp_min(film, 0.0) ** (1.0 / 2.2)


def _morton_order(cent: torch.Tensor) -> torch.Tensor:
    """Indices of the points ``cent`` (N, 3) along a Z-order curve of a
    1024^3 grid over their bounds."""
    lo, hi = cent.amin(dim=0), cent.amax(dim=0)
    q = ((cent - lo) / torch.clamp_min(hi - lo, 1e-30) * 1023.0).long()
    code = torch.zeros(cent.shape[0], dtype=torch.int64, device=cent.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return torch.argsort(code)


def grouped_intersector(sc: SceneArrays, device, group: int = GROUP,
                        pairs_per_chunk: int = 1 << 24):
    """The nearest hits (t, tid) of ``render.mt_intersector`` in float32,
    bit for bit: the same Möller–Trumbore arithmetic on each (ray,
    triangle) pair, the nearest t, ties to the lower index.  Triangles go
    in runs of ``group`` along a Z-order curve of their centroids, each
    run under one box widened by ``BOX_MARGIN``; a ray tests the triangles
    of the boxes it enters, which hold every triangle it can hit.  Rays go
    in batches of at most ``pairs_per_chunk`` (ray, triangle) pairs."""
    n = sc.num_tris

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[:n])).to(device)

    v1, v2, v3 = t(sc.v1), t(sc.v2), t(sc.v3)
    e1, e2 = v2 - v1, v3 - v1
    n_groups = -(-n // group)
    members = torch.full((n_groups * group,), -1, dtype=torch.int64,
                         device=device)
    members[:n] = _morton_order((v1 + v2 + v3) / 3.0)
    members = members.reshape(n_groups, group)
    # The last group's empty slots (-1) take its first triangle's box.
    slots = torch.where(members >= 0, members, members[:, :1])
    box_lo = torch.minimum(torch.minimum(v1, v2), v3)[slots].amin(dim=1)
    box_hi = torch.maximum(torch.maximum(v1, v2), v3)[slots].amax(dim=1)
    box_lo, box_hi = box_lo - BOX_MARGIN, box_hi + BOX_MARGIN
    rays = max(1, (1 << 24) // n_groups)

    def entered(o, d):
        d = torch.where(d == 0.0, 1e-30, d)
        inv = 1.0 / d
        t1 = (box_lo[None] - o[:, None]) * inv[:, None]
        t2 = (box_hi[None] - o[:, None]) * inv[:, None]
        near = torch.amax(torch.minimum(t1, t2), dim=-1)
        far = torch.amin(torch.maximum(t1, t2), dim=-1)
        return (far >= 0.0) & (near <= far)

    def one(o, d):
        r, g = torch.nonzero(entered(o, d), as_tuple=True)
        m = o.shape[0]
        count = torch.bincount(r, minlength=m)
        width = group * int(count.max()) if r.numel() else 1
        if m > 1 and m * width > pairs_per_chunk:
            a, b = one(o[:m // 2], d[:m // 2]), one(o[m // 2:], d[m // 2:])
            return torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]])
        # Each ray's boxes in a row of its own (nonzero lists them ray by
        # ray), a box's triangles side by side, empty slots at t = inf;
        # then per row the nearest t and the lowest triangle at it.
        box = torch.arange(r.shape[0], device=device) - (
            torch.cumsum(count, 0) - count)[r]
        tri = members[g]                                   # (pairs, group)
        cols = box[:, None] * group + torch.arange(group, device=device)
        ray = r[:, None].expand_as(tri)
        real = tri >= 0
        tri, ray, cols = tri[real], ray[real], cols[real]
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
        rows_t = torch.full((m, width), FLOAT_INF, dtype=tt.dtype,
                            device=device)
        rows_t[ray, cols] = torch.where(valid, tt, FLOAT_INF)
        rows_id = torch.full((m, width), n, dtype=torch.int64, device=device)
        rows_id[ray, cols] = tri
        tmin = rows_t.amin(dim=1)
        tid = torch.where(rows_t == tmin[:, None], rows_id, n).amin(dim=1)
        return tmin, torch.where(tmin < FLOAT_INF, tid, -1).to(torch.int32)

    def intersect(o, d):
        shape = o.shape[:-1]
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        parts = [one(o[r:r + rays], d[r:r + rays])
                 for r in range(0, o.shape[0], rays)]
        return (torch.cat([p[0] for p in parts]).reshape(shape),
                torch.cat([p[1] for p in parts]).reshape(shape))

    return intersect


class SampleBeamTracer(BeamTracer):
    """``BeamTracer`` with a sample index per ray: ``film`` traces the
    (pixel, sample) pairs of a launch in one pass and sums them in
    ``BeamTracer.film``'s order, so its films are ``BeamTracer.film``'s bit
    for bit at a fifteenth of the calls.  ``radiance`` is
    ``BeamTracer.radiance`` with the tile stream seeded per ray."""

    def radiance(self, w, h, sidx, depth: int, seed: int,
                 live=None) -> torch.Tensor:
        dev, dtype = self.device, self.dtype
        state = rng.sample_seed(w, h, self.cam.height, sidx, seed)
        state, j1 = rng.rand01(state, dtype)
        state, j2 = rng.rand01(state, dtype)
        o, d = primary_rays(self.cam, self.cp, w, h, j1, j2, rsqrt=True)
        tiles = rng.u32(tile_of(w, h, self.cam.width))
        tstate = rng.hash_u32(((tiles + rng.TILE_MIX) & rng.MASK)
                              ^ rng.mul_u32(rng.u32(sidx), rng.GOLDEN))
        tstate = rng.hash_u32(tstate ^ ((int(seed) * rng.SEED_MIX)
                                        & rng.MASK))
        n = w.shape[0]
        thr = torch.ones((n, 3), dtype=dtype, device=dev)
        rad = torch.zeros((n, 3), dtype=dtype, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        for _ in range(depth):
            tstate, u1 = rng.rand01(tstate, dtype)
            tstate, u2 = rng.rand01(tstate, dtype)
            if live is not None:
                live.append(alive)
            best_t = torch.full((n,), FLOAT_INF, dtype=dtype, device=dev)
            best = torch.full((n,), -1, dtype=torch.int64, device=dev)
            idx = torch.nonzero(alive).squeeze(1)
            if idx.numel():
                t_l, tid_l = self.intersect(o[idx], d[idx])
                best_t[idx] = t_l
                best[idx] = tid_l.to(torch.int64)
            hitting = (best >= 0)[:, None]
            row = best.clamp_min(0)
            col = torch.where(hitting, self.color[row], 0.0)
            nrm = torch.where(hitting, self.normal[row], 0.0)
            nrm = nrm * torch.rsqrt(torch.clamp_min(dot(nrm, nrm),
                                                    1e-30))[:, None]
            is_emit = (best >= 0) & self.is_emit[row]
            emitf = is_emit.to(dtype)[:, None]
            hit = (best_t < FLOAT_INF) & alive
            rad = rad + hit.to(dtype)[:, None] * thr * col * emitf
            cont = hit & ~is_emit
            nrm = nrm * torch.where(dot(nrm, d) < 0.0, 1.0, -1.0).to(
                dtype)[:, None]
            xx = 2.0 * u1 - 1.0
            ct = torch.sqrt(torch.clamp_min(1.0 - xx * xx, 0.0))
            phi = TWO_PI * u2
            sd = torch.stack([ct * torch.cos(phi), ct * torch.sin(phi), -xx],
                             dim=-1)
            new_d = sd * torch.where(dot(sd, nrm) < 0.0, -1.0, 1.0).to(
                dtype)[:, None]
            w2c = 2.0 * dot(nrm, new_d)
            contm = cont[:, None]
            thr = thr * torch.where(contm, w2c[:, None] * col * (1.0 - emitf),
                                    1.0)
            hit_p = o + d * best_t[:, None]
            o = torch.where(contm, hit_p + nrm * SHIFT_BIAS, o)
            d = torch.where(contm, new_d, d)
            alive = cont
        return rad

    def film(self, w, h, samples: int, depth: int, seed: int,
             launch_spp: int) -> torch.Tensor:
        p = w.shape[0]
        film = torch.zeros((p, 3), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            for l0 in range(0, samples, launch_spp):
                k = min(samples, l0 + launch_spp) - l0
                sidx = torch.arange(l0, l0 + k, device=self.device)
                rad = self.radiance(w.repeat(k), h.repeat(k),
                                    sidx.repeat_interleave(p), depth,
                                    seed).float().reshape(k, p, 3)
                acc = torch.zeros_like(film)
                for s in range(k):
                    acc = acc + rad[s]
                film = film + acc
        return film / samples


class Viewer:
    """The viewer's displayed values at the pixels (w, h), replayed from
    a key history: ``display(keys, k)`` is frame k after the last clear,
    the camera moved by ``keys``.  Frames are kept once rendered, so
    displays of one camera share them.  ``dtype`` is the precision of the
    paths (bfloat16 for the control, with the dense test); the blend stays
    float32."""

    def __init__(self, sc: SceneArrays, cam0: CameraArrays, device, w, h,
                 depth: int, frame_samples: int, seed: int,
                 launch_spp: int, dtype=torch.float32):
        self.sc, self.cam0, self.device = sc, cam0, device
        self.w, self.h = w, h
        self.depth, self.samples, self.seed = depth, frame_samples, seed
        self.launch_spp, self.dtype = launch_spp, dtype
        self.intersect = (grouped_intersector(sc, device)
                          if dtype == torch.float32 else None)
        self._tracers: Dict[Tuple[str, ...], SampleBeamTracer] = {}
        self._films: Dict[Tuple[Tuple[str, ...], int], torch.Tensor] = {}

    @property
    def rendered(self) -> int:
        """Frames rendered so far."""
        return len(self._films)

    def tracer(self, keys: Sequence[str]) -> SampleBeamTracer:
        keys = tuple(keys)
        if keys not in self._tracers:
            tr = SampleBeamTracer(self.sc, camera_after(self.cam0, keys),
                                  self.device, self.dtype)
            if self.intersect is not None:
                tr.intersect = self.intersect
            self._tracers[keys] = tr
        return self._tracers[keys]

    def frame(self, keys: Sequence[str], k: int) -> torch.Tensor:
        """(P, 3) linear film of frame k after the clear."""
        key = (tuple(keys), k)
        if key not in self._films:
            self._films[key] = self.tracer(keys).film(
                self.w, self.h, self.samples, self.depth, self.seed + k,
                self.launch_spp)
        return self._films[key]

    def display(self, keys: Sequence[str], k: int) -> torch.Tensor:
        """(P, 3) displayed values of frame k after the clear."""
        return tone(blend([self.frame(keys, j) for j in range(k + 1)]))
