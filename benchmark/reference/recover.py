"""Plain material recovery: the reference of the differentiable path.

The method, written from its published description: materials live in an
unconstrained space (albedo = sigmoid(p), emission = softplus(p)); step k
renders two independent half-sample films A and B of the sample windows
[k S, k S + S/2) and [k S + S/2, (k + 1) S) with the rays detached (hits
and normals carry no gradient), takes the paired loss
mean(w (A - t) (B - t)) with w = 1 / (t + 0.02)^2, and applies Adam
(beta 0.9, 0.999, eps 1e-8) with the update masked after the step:
albedo moves on non-emitting rows, emission on emitting rows.  The film
is rendered in blocks of pixels, each block's share of the loss
back-propagated at once, so the memory stays small.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .render import PixelTracer, shade_table
from .scenes import EMIT, CameraArrays, SceneArrays

NAMES = ("albedo", "emit", "roughness")
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
REL_EPS = 2e-2
PIXELS_PER_BLOCK = 4096


def softplus_inv(y: float) -> float:
    y = max(y, 1e-6)
    return y + math.log(-math.expm1(-y))


def start_params(sc: SceneArrays, device, value: float = 0.5):
    """The uniform grey start: albedo and roughness at ``value``, emission
    at ``value`` on emitting rows and at 1e-6 elsewhere."""
    T = sc.v1.shape[0]
    is_emit = np.zeros((T, 1), bool)
    is_emit[:sc.num_tris, 0] = sc.mat_type[:sc.num_tris] == EMIT
    logit = math.log(value) - math.log1p(-value)
    emit = np.where(is_emit, np.float32(softplus_inv(value)),
                    np.float32(softplus_inv(1e-6))).repeat(3, 1)
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    return {"albedo": t(np.full((T, 3), logit)), "emit": t(emit),
            "roughness": t(np.full(T, logit))}


def masks(sc: SceneArrays, optimize, device) -> Dict[str, torch.Tensor]:
    T, n = sc.v1.shape[0], sc.num_tris
    mt = sc.mat_type[:n]
    active = {"albedo": mt != EMIT, "emit": mt == EMIT,
              "roughness": np.zeros(n, bool)}
    out = {}
    for k, rows in active.items():
        full = np.zeros(T, np.float32)
        full[:n] = rows if k in optimize else 0.0
        m = torch.from_numpy(full).to(device)
        out[k] = m if k == "roughness" else m[:, None]
    return out


class Recovery:
    """The reference's recovery of one scene, camera and target."""

    def __init__(self, sc: SceneArrays, cam: CameraArrays, target, *,
                 samples: int, depth: int, seed: int, lr: float, optimize,
                 device, dtype=torch.float32):
        self.sc, self.cam, self.device, self.dtype = sc, cam, device, dtype
        self.tracer = PixelTracer(sc, cam, device, loop="mt", dtype=dtype)
        self.target = torch.as_tensor(target, dtype=torch.float32,
                                      device=device).reshape(-1, 3)
        self.samples, self.depth, self.seed, self.lr = (samples, depth, seed,
                                                        lr)
        self.masks = masks(sc, optimize, device)
        pix = torch.arange(cam.width * cam.height, device=device)
        self.w, self.h = pix % cam.width, pix // cam.width

    def value_and_grad(self, params, k: int):
        """(loss, {name: gradient}) of step k."""
        leaves = {n: p.detach().clone().requires_grad_(True)
                  for n, p in params.items()}
        half = max(self.samples // 2, 1)
        n_pix = self.w.shape[0]
        total = 0.0
        grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
        for p0 in range(0, n_pix, PIXELS_PER_BLOCK):
            sl = slice(p0, min(n_pix, p0 + PIXELS_PER_BLOCK))
            table = shade_table(self.sc, self.device, self.dtype,
                                albedo=torch.sigmoid(leaves["albedo"]),
                                emit=F.softplus(leaves["emit"]))
            w, h, t = self.w[sl], self.h[sl], self.target[sl]

            def film(s0, n):
                sidx = torch.arange(s0, s0 + n, device=self.device)
                return self.tracer.radiance(w[None], h[None], sidx[:, None],
                                            self.depth,
                                            self.seed, table=table
                                            ).float().mean(dim=0)

            a = film(k * self.samples, half)
            b = film(k * self.samples + half, self.samples - half)
            wgt = 1.0 / (t + REL_EPS) ** 2
            part = torch.sum(wgt * (a - t) * (b - t)) / (n_pix * 3)
            g = torch.autograd.grad(part, [leaves["albedo"], leaves["emit"]])
            grads["albedo"] += g[0]
            grads["emit"] += g[1]
            total += float(part.detach())
        return total, grads

    def run(self, params, steps: int, at=()):
        """Losses, first gradient and parameters after ``steps`` steps of
        Adam from ``params``, and the parameters after each step count of
        ``at``, by count."""
        p = {n: v.detach().clone() for n, v in params.items()}
        kept = {}
        m = {n: torch.zeros_like(v) for n, v in p.items()}
        v2 = {n: torch.zeros_like(v) for n, v in p.items()}
        losses: List[float] = []
        first = None
        for k in range(steps):
            loss, g = self.value_and_grad(p, k)
            losses.append(loss)
            if first is None:
                first = {n: x.clone() for n, x in g.items()}
            t = k + 1
            for n in NAMES:
                m[n] = BETAS[0] * m[n] + (1 - BETAS[0]) * g[n]
                v2[n] = BETAS[1] * v2[n] + (1 - BETAS[1]) * g[n] * g[n]
                step = self.lr / (1 - BETAS[0] ** t)
                denom = (torch.sqrt(v2[n]) / math.sqrt(1 - BETAS[1] ** t)
                         + ADAM_EPS)
                new = p[n] - step * m[n] / denom
                p[n] = torch.where(self.masks[n] > 0, new, p[n])
            if t in at:
                kept[t] = {n: x.clone() for n, x in p.items()}
        return losses, first, p, kept
