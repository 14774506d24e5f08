"""Inverse rendering: recover material parameters from a target image, the
PyTorch counterpart of ``pathtracer_tpu/inverse.py``.

The optimizer works in an unconstrained space and maps into physical
ranges:

    albedo    = sigmoid(p)        in (0, 1)^3
    emission  = softplus(p)       in (0, inf)^3
    roughness = sigmoid(p)        in (0, 1)

Gradients come from the detached, reparameterized estimator of
``diff.py``; step k traces the sample window starting at ``k * samples``,
so successive steps see independent Monte-Carlo noise.  The method is the
JAX package's, unchanged: the paired unbiased loss with relative weights,
the material-type update masks, Adam with optax's defaults and an optional
cosine decay of the learning rate, common-random-number SPSA for roughness,
and resumable train checkpoints.  Two things differ on purpose: the
learning rate of step k is computed from k (optax's
``cosine_decay_schedule`` in closed form, so a resumed run needs no
scheduler state), and the SPSA signs come from a ``torch.Generator``
seeded from ``(seed ^ 0x5B57A, k)``: JAX's threefry bits cannot be
reproduced, so SPSA trajectories are held to recovery bars, not to JAX's
steps.  The train checkpoint keys the scene by its byte fingerprint, not
by JAX's float sum.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import materials as mat
from . import rng as prng
from .camera import Camera, get_rays
from .diff import _backend, make_accel, render_film_diff
from .ops.cuda import cluster_kernel
from .scene import Scene
from .utils import checkpoint as ckpt
from .utils.profiling import trace_annotation

PARAM_NAMES = ("albedo", "emit", "roughness")   # sorted: checkpoint order
LOSSES = ("paired", "relative", "mse", "sqrt")
SPSA_EPS = 0.15        # logit-space roughness perturbation (~0.04 at 0.5)
_SPSA_MIX = 0x5B57A
ADAM_BETAS = (0.9, 0.999)   # optax.adam's defaults
ADAM_EPS = 1e-8


def _softplus_inv(y):
    y = torch.clamp_min(y, 1e-6)
    return y + torch.log(-torch.expm1(-y))


def _logit(y):
    y = torch.clamp(y, 1e-5, 1 - 1e-5)
    return torch.log(y) - torch.log1p(-y)


def to_unconstrained(mats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"albedo": _logit(mats["albedo"]),
            "emit": _softplus_inv(mats["emit"]),
            "roughness": _logit(mats["roughness"])}


def to_materials(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"albedo": torch.sigmoid(params["albedo"]),
            "emit": F.softplus(params["emit"]),
            "roughness": torch.sigmoid(params["roughness"])}


def init_params(scene: Scene, value: float = 0.5) -> Dict[str, torch.Tensor]:
    """Uniform grey start with the scene's shapes, on the scene's device.

    Emission starts grey only on EMIT triangles and near zero elsewhere:
    the material TYPES are scene structure (the scene format declares the
    lights), the continuous values are what is unknown.  Without that, a
    little emission painted on every wall explains the image as well as
    reflected light does, and the albedos collapse."""
    T, dev = scene.padded_size, scene.device
    is_emit = np.zeros((T, 1), bool)
    is_emit[:scene.num_tris, 0] = scene.host_materials()[0] == mat.EMIT
    v = torch.tensor(value, dtype=torch.float32, device=dev)
    e0 = _softplus_inv(v)
    e_dark = _softplus_inv(torch.tensor(1e-6, dtype=torch.float32,
                                        device=dev))
    zeros3 = torch.zeros((T, 3), dtype=torch.float32, device=dev)
    return {"albedo": zeros3 + _logit(v),
            "emit": zeros3 + torch.where(torch.from_numpy(is_emit).to(dev),
                                         e0, e_dark),
            "roughness": torch.zeros(T, dtype=torch.float32, device=dev)
            + _logit(v)}


def cosine_lr(lr: float, lr_end: Optional[float], k: int, steps: int) -> float:
    """The learning rate of step k: ``lr``, or with ``lr_end`` optax's
    ``cosine_decay_schedule(lr, max(steps, 1), alpha=lr_end / lr)``."""
    if lr_end is None:
        return lr
    a = lr_end / lr
    n = max(steps, 1)
    return lr * ((1 - a) * 0.5 * (1 + math.cos(math.pi * min(k, n) / n)) + a)


def spsa_signs(seed: int, k: int, n: int) -> torch.Tensor:
    """(n,) float32 signs +-1 of step k's SPSA perturbation: on the CPU,
    from a generator seeded by (seed ^ 0x5B57A, k), so the same on every
    device and after a resume."""
    # The CPU generator keeps 32 bits of its seed: hash the pair into them.
    mix = prng.hash_u32(torch.tensor((seed ^ _SPSA_MIX) & prng.MASK))
    gen = torch.Generator().manual_seed(
        int(prng.hash_u32(mix ^ (k & prng.MASK))))
    return torch.randint(0, 2, (n,), generator=gen).to(torch.float32) * 2 - 1


def _row_masks(scene: Scene, optimize) -> Dict[str, torch.Tensor]:
    """{name: 1.0 where the coordinate may move}: the group is in
    ``optimize`` and the row's material type is one the parameter acts on
    (albedo on non-EMIT rows, emission on EMIT rows, roughness on SPECULAR
    rows); padding rows never move."""
    T, n = scene.padded_size, scene.num_tris
    mtype = scene.host_materials()[0]
    active = {"albedo": mtype != mat.EMIT, "emit": mtype == mat.EMIT,
              "roughness": mtype == mat.SPECULAR}
    out = {}
    for k, rows in active.items():
        full = np.zeros(T, np.float32)
        full[:n] = rows if k in optimize else 0.0
        m = torch.from_numpy(full).to(scene.device)
        out[k] = m if k == "roughness" else m[:, None]
    return out


@dataclasses.dataclass
class _Problem:
    """What every step of one recovery shares."""
    camera: Camera
    scene: Scene
    target: torch.Tensor
    samples: int
    depth: int
    seed: int
    backend: str
    accel: object
    loss: str
    rel_eps: float
    masks: Dict[str, torch.Tensor]   # 1.0 where a coordinate may move
    rough_spsa: bool

    def render(self, mats, samples: int, offset: int) -> torch.Tensor:
        return render_film_diff(self.camera, self.scene, mats, samples,
                                self.depth, seed=self.seed,
                                sample_offset=offset, backend=self.backend,
                                accel=self.accel)

    def value(self, params, k: int) -> torch.Tensor:
        """Step k's loss of the unconstrained ``params``."""
        mats = to_materials(params)
        t = self.target
        if self.loss == "sqrt":
            # Variance-stabilising: the Monte-Carlo noise of linear
            # radiance grows like sqrt(mean).  Biased by Var(film); kept
            # for ablation.
            film = self.render(mats, self.samples, k * self.samples)
            return torch.mean((torch.sqrt(torch.clamp_min(film, 0.0)
                                          + self.rel_eps)
                               - torch.sqrt(t + self.rel_eps)) ** 2)
        wgt = (1.0 / (t + self.rel_eps) ** 2
               if self.loss in ("relative", "paired") else 1.0)
        if self.loss == "paired":
            # Any loss nonlinear in the noisy film pays its variance:
            # E[(f - t)^2] = (E f - t)^2 + Var(f), and darker materials
            # make shorter, lower-variance paths, so "mse", "relative" and
            # "sqrt" darken the recovery.  Two independent half-sample
            # films A, B give E[(A - t)(B - t)] = (E f - t)^2 exactly, at
            # the same cost.
            half = max(self.samples // 2, 1)
            a = self.render(mats, half, k * self.samples)
            b = self.render(mats, self.samples - half,
                            k * self.samples + half)
            return torch.mean(wgt * (a - t) * (b - t))
        film = self.render(mats, self.samples, k * self.samples)
        return torch.mean(wgt * (film - t) ** 2)


def _train_step(pb: _Problem, params: Dict[str, torch.Tensor],
                opt: torch.optim.Adam, k: int, lr: float) -> float:
    """One optimizer step at learning rate ``lr``; returns the loss.

    Spans: ``pt.train_step`` over the step, and inside it, in order,
    ``pt.step.forward`` (the renders and the loss), ``pt.step.backward``,
    ``pt.step.spsa`` (only when roughness takes SPSA), ``pt.step.update``
    (Adam and the masked copy) and ``pt.step.sync`` (the host's wait for
    the loss)."""
    with trace_annotation("pt.train_step"):
        leaves = [params[n] for n in PARAM_NAMES]
        with trace_annotation("pt.step.forward"):
            loss = pb.value(params, k)
        with trace_annotation("pt.step.backward"):
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, torch.autograd.grad(
                         loss, leaves, allow_unused=True))]
        if pb.rough_spsa:
            # The pathwise roughness gradient is boundary-dominated
            # (diff.py) and measured wrong-signed; the expected paired loss
            # is smooth in roughness, so a two-point estimate with common
            # random numbers (the same sample window on both sides) takes
            # its place.
            with trace_annotation("pt.step.spsa"):
                r = params["roughness"]
                delta = spsa_signs(pb.seed, k, r.shape[0]).to(r.device) \
                    * (pb.masks["roughness"] > 0)
                with torch.no_grad():
                    up = pb.value({**params,
                                   "roughness": r + SPSA_EPS * delta}, k)
                    dn = pb.value({**params,
                                   "roughness": r - SPSA_EPS * delta}, k)
                grads[PARAM_NAMES.index("roughness")] = (
                    (up - dn) / (2.0 * SPSA_EPS) * delta)
        with trace_annotation("pt.step.update"):
            old = [p.detach().clone() for p in leaves]
            for p, g in zip(leaves, grads):
                p.grad = g
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            with torch.no_grad():
                # Mask the UPDATE, as the JAX package does: Adam's moments
                # take every coordinate's gradient; frozen and type-masked
                # coordinates keep their values.
                for n, p, o in zip(PARAM_NAMES, leaves, old):
                    p.copy_(torch.where(pb.masks[n] > 0, p, o))
        with trace_annotation("pt.step.sync"):
            return float(loss.detach())


def _opt_leaves(opt: torch.optim.Adam, params, with_schedule: bool
                ) -> List[torch.Tensor]:
    """Adam's state in optax's leaf order: count, the first moments, the
    second moments (sorted names), and the schedule's count with
    ``lr_end``."""
    state = [opt.state[params[n]] for n in PARAM_NAMES]
    count = torch.tensor(int(state[0]["step"]), dtype=torch.int32)
    return ([count] + [s["exp_avg"] for s in state]
            + [s["exp_avg_sq"] for s in state]
            + ([count] if with_schedule else []))


def _load_opt(opt: torch.optim.Adam, leaves: List[np.ndarray]) -> None:
    count = float(leaves[0])
    sd = opt.state_dict()
    sd["state"] = {i: {"step": torch.tensor(count),
                       "exp_avg": torch.from_numpy(leaves[1 + i]),
                       "exp_avg_sq": torch.from_numpy(leaves[4 + i])}
                   for i in range(len(PARAM_NAMES))}
    opt.load_state_dict(sd)


def recover_materials(camera: Camera, scene: Scene, target, *,
                      steps: int = 200, samples: int = 8, depth: int = 5,
                      lr: float = 5e-2, lr_end: Optional[float] = None,
                      seed: int = prng.SEED,
                      params0: Optional[Dict[str, torch.Tensor]] = None,
                      optimize: tuple = ("albedo", "emit", "roughness"),
                      checkpoint: Optional[str] = None,
                      checkpoint_every: int = 25, backend: str = "brute",
                      loss: str = "paired", rel_eps: float = 2e-2,
                      verbose: bool = False):
    """Descend the material parameters until the render matches ``target``
    (the linear (H, W, 3) film), on the scene's device.

    ``optimize``: the groups that move; the rest stay at their start
    (``params0``, unconstrained, default :func:`init_params`).  Within a
    group only the rows of the material type it acts on move: emission on
    EMIT rows, roughness on SPECULAR rows, albedo elsewhere, which breaks
    the emission-albedo degeneracy.
    ``lr_end``: the learning rate decays from ``lr`` to ``lr_end`` along a
    cosine over ``steps``: the Monte-Carlo noise floor shrinks with the
    step size.
    ``loss``: "paired" (default), the unbiased mean(w (A - t)(B - t)) of
    two independent half-sample films with relative weights
    w = 1 / (t + rel_eps)^2; "relative", "mse" and "sqrt" are biased by the
    film's variance (they darken the recovery) and kept for ablation.
    Roughness coordinates take common-random-number SPSA in place of their
    pathwise gradient (when the scene has speculars).
    ``checkpoint``: a .npz resume file: if it exists the run resumes at its
    step with the parameters and Adam's state restored, and continues the
    trajectory of an uninterrupted run; it is written every
    ``checkpoint_every`` steps and at the end.  A file written by another
    configuration or scene raises ``ValueError``.

    Returns (materials, losses): the recovered physical material tensors
    and the losses of the steps run in this call.
    """
    backend = _backend(backend)
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r} (use one of {LOSSES})")
    if loss == "paired" and samples < 2:
        raise ValueError(
            "loss='paired' needs samples >= 2 (two independent half-sample "
            f"renders; got samples={samples})")
    dev = scene.device
    start = init_params(scene) if params0 is None else params0
    params = {n: start[n].detach().to(device=dev, dtype=torch.float32)
              .clone().requires_grad_(True) for n in PARAM_NAMES}
    opt = torch.optim.Adam([params[n] for n in PARAM_NAMES], lr=lr,
                           betas=ADAM_BETAS, eps=ADAM_EPS)
    pb = _Problem(
        camera=camera, scene=scene,
        target=torch.as_tensor(target, dtype=torch.float32, device=dev),
        samples=samples, depth=depth, seed=seed, backend=backend,
        accel=make_accel(scene, backend), loss=loss, rel_eps=rel_eps,
        masks=_row_masks(scene, optimize),
        rough_spsa="roughness" in optimize and scene.has_specular)

    # Resuming with another estimator or scene would continue a different
    # optimisation; the scene is keyed by its bytes, since a float sum
    # misses edits that keep it.
    meta = {"samples": samples, "depth": depth, "seed": seed,
            "backend": backend, "loss": loss,
            "scene_fingerprint": list(scene.fingerprint())}
    start_step = 0
    if checkpoint is not None and os.path.exists(
            ckpt.checkpoint_path(checkpoint)):
        saved_params, leaves, start_step, saved = ckpt.load_train_checkpoint(
            checkpoint, PARAM_NAMES)
        if saved != meta:
            raise ValueError(
                f"checkpoint {checkpoint} was written by a different "
                f"training config:\n  saved: {saved}\n  this:  {meta}")
        with torch.no_grad():
            for n in PARAM_NAMES:
                params[n].copy_(torch.from_numpy(saved_params[n]))
        _load_opt(opt, leaves)
        if verbose:
            print(f"Resuming at step {start_step}/{steps}.")

    losses = []
    for k in range(start_step, steps):
        losses.append(_train_step(pb, params, opt, k,
                                  cosine_lr(lr, lr_end, k, steps)))
        if verbose and (k % 10 == 0 or k == steps - 1):
            print(f"step {k:4d}  loss {losses[-1]:.3e}")
        if checkpoint is not None and (
                (k + 1) % checkpoint_every == 0 or k == steps - 1):
            ckpt.save_train_checkpoint(
                checkpoint, params,
                _opt_leaves(opt, params, lr_end is not None), k + 1, meta)
    with torch.no_grad():
        mats = to_materials({n: p.detach() for n, p in params.items()})
    return mats, np.asarray(losses)


def visible_pixel_counts(camera: Camera, scene: Scene) -> np.ndarray:
    """(num_tris,) pixels whose primary ray (sample 0 of seed 1, jittered
    as the renders jitter it) hits each triangle: what a recovery can see,
    for judging it.  Intersects through the cluster set (the kernel on a
    CUDA scene)."""
    width, height = camera.res
    dev = scene.device
    w = torch.arange(width, device=dev).expand(height, width)
    h = torch.arange(height, device=dev)[:, None].expand(height, width)
    st = prng.sample_seed(w[None], h[None], height,
                          torch.zeros((1, 1, 1), dtype=torch.int64,
                                      device=dev), 1)
    st, u1 = prng.rand01(st)
    st, u2 = prng.rand01(st)
    o, d = get_rays(camera, w[None], h[None], u1, u2)
    _, tid = cluster_kernel.intersect_clusters(
        o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
        cluster_kernel.clusters_for(scene))
    tid = tid.cpu().numpy()
    return np.bincount(tid[tid >= 0], minlength=scene.num_tris)
