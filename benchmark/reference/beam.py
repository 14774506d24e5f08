"""Plain coherent-beam path tracer (Sadeghi et al. 2009), the reference of
the large-mesh route.

The film is padded to 64x64 squares; within a square pixels are numbered
in Morton order (x on the even bits), squares row-major, and each run of
2048 pixels is a tile.  A pixel's camera jitter comes from its own
(pixel, sample) stream; every bounce's two uniforms come from the
(tile, sample) stream, so all rays of a tile take one hemisphere
direction, each flipped to its side of the surface.  The nearest hit is
dense Möller–Trumbore against every triangle; normals are ``e1 x e2``,
normalised by ``rsqrt``.  Plain PyTorch; one sample of chosen pixels at a
time.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .render import (FLOAT_INF, SHIFT_BIAS, TWO_PI, camera_params, cross,
                     dot, mt_intersector, primary_rays)
from .scenes import EMIT, SPECULAR, CameraArrays, SceneArrays

SQ = 64
TILE_PX = 2048


def tile_of(w: torch.Tensor, h: torch.Tensor, width: int) -> torch.Tensor:
    """The tile of each pixel: its 64x64 square times two, plus one in the
    square's lower half (bit 11 of the Morton index is y's bit 5)."""
    nsq_x = -(-width // SQ)
    sq = (h // SQ) * nsq_x + w // SQ
    return sq * 2 + ((h % SQ) >> 5)


class BeamTracer:
    def __init__(self, sc: SceneArrays, cam: CameraArrays, device,
                 dtype=torch.float32):
        if np.any(sc.mat_type[:sc.num_tris] == SPECULAR):
            raise ValueError("the beam reference renders diffuse scenes")
        self.sc, self.cam, self.device, self.dtype = sc, cam, device, dtype
        self.cp = camera_params(cam, device, dtype)
        n = sc.num_tris
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a[:n])).to(device)

        v1 = t(sc.v1)
        self.normal = cross(t(sc.v2) - v1, t(sc.v3) - v1).to(dtype)
        is_emit = torch.from_numpy(sc.mat_type[:n] == EMIT).to(device)
        self.color = torch.where(is_emit[:, None], t(sc.emit),
                                 t(sc.albedo)).to(dtype)
        self.is_emit = is_emit
        self.intersect = mt_intersector(sc, device, dtype)

    def radiance(self, w, h, sidx: int, depth: int, seed: int,
                 live=None) -> torch.Tensor:
        """(P, 3) radiance of sample ``sidx`` at the pixels (w, h)."""
        dev, dtype = self.device, self.dtype
        state = rng.sample_seed(w, h, self.cam.height, sidx, seed)
        state, j1 = rng.rand01(state, dtype)
        state, j2 = rng.rand01(state, dtype)
        o, d = primary_rays(self.cam, self.cp, w, h, j1, j2, rsqrt=True)
        tstate = rng.tile_seed(tile_of(w, h, self.cam.width), sidx, seed)
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
        """(P, 3) float32 mean over the samples [0, samples): per launch of
        ``launch_spp`` samples the samples added one by one, then each
        launch's sum into the film."""
        film = torch.zeros((w.shape[0], 3), dtype=torch.float32,
                           device=self.device)
        with torch.no_grad():
            for l0 in range(0, samples, launch_spp):
                acc = torch.zeros_like(film)
                for s in range(l0, min(samples, l0 + launch_spp)):
                    acc = acc + self.radiance(w, h, s, depth, seed).float()
                film = film + acc
        return film / samples

    def segments(self, w, h, sidx: int, depth: int, seed: int):
        """[(o, d, t, tid)] of the live rays of each bounce of one sample,
        for the work count."""
        out = []
        orig = self.intersect

        def recording(o, d):
            t, tid = orig(o, d)
            out.append((o, d, t, tid))
            return t, tid

        self.intersect = recording
        try:
            with torch.no_grad():
                self.radiance(w, h, sidx, depth, seed)
        finally:
            self.intersect = orig
        return out
