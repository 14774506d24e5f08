"""Material recovery steps through the program's ``inverse._train_step``.

Set-up renders the target with the plain reference (the scene's true
materials, ``target_samples`` samples, its own seed), builds one training
state (the grey start of ``reference.recover.start_params``, Adam, the
program's ``inverse._Problem``) and drives it through the first
``check.steps`` steps, keeping Adam's first moment after step 1 and the
parameters after the last.  The window goes on with the same state: each
request is one step ``k``, which traces the sample window
[k S, (k + 1) S), and ends when its loss reaches the host.  Every step's
loss is kept, and the parameters after the window's last step.

``_train_step`` is the step ``recover_materials`` loops over; that entry
builds a fresh Adam and restarts k at 0 on every call, so a window chained
through its ``params0`` would reset the optimizer and repeat sample
windows.

Check: after the window, the reference follows every step of the run,
set-up's and the window's, from the same start (``reference.recover``):
``loss_gap`` compares each step's loss, ``grad_gap`` the first gradient,
``update_gap`` the parameters' change over set-up's steps and
``window_update_gap`` their change up to the window's last step.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark.harness import single
from benchmark.reference import compare, scenes
from benchmark.reference.recover import Recovery, start_params
from benchmark.reference.render import PixelTracer

TARGET_SEED_MIX = 0x7A26E7


class RecoverCell:
    def __init__(self, ctx):
        from pathtracer_tpu_torch import diff, inverse
        from pathtracer_tpu_torch.camera import make_camera
        from pathtracer_tpu_torch.scene import Scene

        self.ctx, self.tr, self.chk = ctx, ctx.traffic, ctx.workload["check"]
        self.dev = torch.device(ctx.device)
        res = (self.tr["width"], self.tr["height"])
        self.arrays = scenes.make_scene(ctx.config)
        self.cam_ref = scenes.make_camera(ctx.config, res)
        w, h = res
        pix = torch.arange(w * h, device=self.dev)
        t0 = time.perf_counter()
        self.target = PixelTracer(self.arrays, self.cam_ref, self.dev,
                                  loop="mt").film(
            pix % w, pix // w, self.tr["target_samples"], self.tr["depth"],
            ctx.seed ^ TARGET_SEED_MIX, self.tr["target_samples"]
        ).reshape(h, w, 3)
        print(f"target rendered by the reference in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        self.params0 = start_params(self.arrays, self.dev)

        camera = make_camera(**scenes.camera_args(ctx.config, res),
                             device=ctx.device)
        scene = Scene.from_arrays(*self.arrays.as_args(), device=ctx.device)
        self.inverse = inverse
        self.params = {n: self.params0[n].clone().requires_grad_(True)
                       for n in inverse.PARAM_NAMES}
        self.opt = torch.optim.Adam(
            [self.params[n] for n in inverse.PARAM_NAMES], lr=self.tr["lr"],
            betas=inverse.ADAM_BETAS, eps=inverse.ADAM_EPS)
        optimize = tuple(self.tr["optimize"])
        self.pb = inverse._Problem(
            camera=camera, scene=scene, target=self.target,
            samples=self.tr["samples"], depth=self.tr["depth"],
            seed=ctx.seed, backend=self.tr["backend"],
            accel=diff.make_accel(scene, self.tr["backend"]), loss="paired",
            rel_eps=2e-2, masks=inverse._row_masks(scene, optimize),
            rough_spsa="roughness" in optimize and scene.has_specular)
        self.losses, self.first_grad, self.after, self.last = (
            [], None, None, None)

    def _step(self, k: int) -> float:
        return self.inverse._train_step(self.pb, self.params, self.opt, k,
                                        self.tr["lr"])

    def warmup(self):
        """The first steps, which the reference follows."""
        names = self.inverse.PARAM_NAMES
        for k in range(self.chk["steps"]):
            self.losses.append(self._step(k))
            if k == 0:
                # Adam's first moment after one step is (1 - beta1) g; an
                # optimizer that kept no state got no gradient.
                beta1 = self.inverse.ADAM_BETAS[0]
                self.first_grad = {
                    n: self.opt.state.get(self.params[n], {}).get(
                        "exp_avg", torch.zeros_like(self.params[n])
                    ).detach() / (1.0 - beta1) for n in names}
        self.after = {n: self.params[n].detach().clone() for n in names}

    def request(self, i: int):
        self.losses.append(self._step(self.chk["steps"] + i))

    def work(self, i: int) -> float:
        return 1.0

    def trace_work(self, n: int) -> dict:
        return {}

    def release(self):
        self.last = {n: self.params[n].detach().clone()
                     for n in self.inverse.PARAM_NAMES}
        del self.pb, self.opt, self.params

    def check(self, n: int) -> dict:
        ref = Recovery(self.arrays, self.cam_ref, self.target,
                       samples=self.tr["samples"], depth=self.tr["depth"],
                       seed=self.ctx.seed, lr=self.tr["lr"],
                       optimize=self.tr["optimize"], device=self.dev)
        steps = self.chk["steps"]
        t0 = time.perf_counter()
        losses, first, last, kept = ref.run(self.params0, steps + n,
                                            at=(steps,))
        print(f"the reference followed {steps + n} steps in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        counted = compare.counted_leaves(first)

        def change_gap(program, reference):
            return compare.leaf_gaps(
                {k: program[k] - self.params0[k] for k in reference},
                {k: reference[k] - self.params0[k] for k in reference},
                counted)

        return {"loss_gap": max(compare.rel_gap(p, r)
                                for p, r in zip(self.losses, losses)),
                "grad_gap": compare.leaf_gaps(self.first_grad, first,
                                              counted),
                "update_gap": change_gap(self.after, kept[steps]),
                "window_update_gap": change_gap(self.last, last)}


def run(ctx):
    cell = RecoverCell(ctx)
    return single.run(ctx, cell, time.perf_counter())
