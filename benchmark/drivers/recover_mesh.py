"""Material recovery steps on a large mesh through the program's
``inverse._train_step``: ``drivers/recover.py``'s cell, with a target and
a check that a mesh of 100k triangles can afford.

Set-up renders the target with the plain reference over the grouped
intersection (``reference.recover_mesh.tracer``: the dense test's hits bit
for bit, at a fraction of its cost), builds the program's training state
as ``RecoverCell`` does and drives it through the first ``check.steps``
steps.  The window goes on with the same state, one step a request.

``check.drawn`` window steps are drawn from the seed, before the window,
among its first ``check.drawn_within``.  Before each the request keeps a
copy of the program's parameters and Adam's two moments on the device,
and after it the parameters.

Check: after the window the reference takes set-up's steps from the grey
start (``loss_gap``, ``grad_gap`` and ``update_gap``, read as
``drivers/recover.py`` reads them) and one step from each drawn step's
kept state (``reference.recover_mesh.MeshRecovery.step_from``):
``drawn_loss_gap`` compares its loss with the program's and
``drawn_update_gap`` its change of the parameters.  A drawn step that the
window did not reach reads infinity.  The reference does not follow the
whole window: at 100k triangles a step of it takes seconds.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from benchmark.counts import beam_layout
from benchmark.counts import work as counts
from benchmark.drivers.recover import TARGET_SEED_MIX, RecoverCell
from benchmark.drivers.render import count_jobs
from benchmark.harness import single
from benchmark.harness.core import rng_for
from benchmark.reference import compare, recover_mesh, scenes
from benchmark.reference.recover import start_params

DRAW_MIX = 0xD5A7
COUNT_MIX = 0xC1C1


def live_segments(tracer, w, h, sidx, depth: int, seed: int):
    """[(o, d, t, tid)] of the live rays of each bounce of the paths
    (w, h, sidx), for the work count."""
    calls, live = [], []
    orig = tracer.intersect

    def recording(o, d):
        t, tid = orig(o, d)
        calls.append((o, d, t, tid))
        return t, tid

    tracer.intersect = recording
    try:
        with torch.no_grad():
            tracer.radiance(w, h, sidx, depth, seed, live=live)
    finally:
        tracer.intersect = orig
    return [(o[m], d[m], t[m], tid[m])
            for (o, d, t, tid), m in zip(calls, live)]


class MeshRecoverCell(RecoverCell):
    def __init__(self, ctx):
        from pathtracer_tpu_torch import diff, inverse
        from pathtracer_tpu_torch.camera import make_camera
        from pathtracer_tpu_torch.scene import Scene

        self.ctx, self.tr, self.chk = ctx, ctx.traffic, ctx.workload["check"]
        self.dev = torch.device(ctx.device)
        self.res = (self.tr["width"], self.tr["height"])
        self.arrays = scenes.make_scene(ctx.config)
        self.cam_ref = scenes.make_camera(ctx.config, self.res)
        w, h = self.res
        pix = torch.arange(w * h, device=self.dev)
        t0 = time.perf_counter()
        self.target = recover_mesh.tracer(
            self.arrays, self.cam_ref, self.dev).film(
            pix % w, pix // w, self.tr["target_samples"], self.tr["depth"],
            ctx.seed ^ TARGET_SEED_MIX, self.tr["target_samples"]
        ).reshape(h, w, 3)
        print(f"target rendered by the reference in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        self.params0 = start_params(self.arrays, self.dev)

        camera = make_camera(**scenes.camera_args(ctx.config, self.res),
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
        self.drawn = sorted(rng_for(ctx.seed, DRAW_MIX).choice(
            self.chk["drawn_within"], size=self.chk["drawn"],
            replace=False).tolist())
        self.kept = {}

    def _state(self):
        """Copies of the parameters and of Adam's two moments (zero where
        the optimizer kept none)."""
        names = self.inverse.PARAM_NAMES
        p = {n: self.params[n].detach().clone() for n in names}

        def moment(key):
            return {n: self.opt.state.get(self.params[n], {}).get(
                key, torch.zeros_like(p[n])).clone() for n in names}
        return p, moment("exp_avg"), moment("exp_avg_sq")

    def request(self, i: int):
        keep = i in self.drawn
        if keep:
            before = self._state()
        super().request(i)
        if keep:
            self.kept[i] = before + ({n: self.params[n].detach().clone()
                                      for n in self.inverse.PARAM_NAMES},)

    def trace_work(self, n: int) -> dict:
        """The cluster kernel's operations for the window's n steps: the
        live segments of a seeded sample of its paths (steps drawn, each
        step's own sample windows) by the reference, counted as an exact
        two-level traversal of the benchmark's own box layout
        (``counts.beam_work``, the rule of ``beam_kernel_roofline``),
        scaled to the window's paths."""
        n_tris = self.arrays.num_tris
        layout = beam_layout.build(self.arrays.v1[:n_tris],
                                   self.arrays.v2[:n_tris],
                                   self.arrays.v3[:n_tris])
        tracer = recover_mesh.tracer(self.arrays, self.cam_ref, self.dev)
        w, h = self.res
        spp = self.tr["samples"]
        rng = rng_for(self.ctx.seed, COUNT_MIX)
        steps = count_jobs(rng, n)
        per_step = max(1, self.chk["count_paths"] // len(steps))
        ops = 0
        for i in steps:
            k = self.chk["steps"] + i
            pw, ph, ps = (torch.from_numpy(a).to(self.dev)
                          for a in counts.sample(rng, w, h, spp, per_step))
            segs = live_segments(tracer, pw, ph, k * spp + ps,
                                 self.tr["depth"], self.ctx.seed)
            ops += counts.beam_work(segs, layout)["ops"]
        paths = n * w * h * spp
        return {"cluster_kernel": ops * paths / (len(steps) * per_step)}

    def check(self, n: int) -> dict:
        ref = recover_mesh.MeshRecovery(
            self.arrays, self.cam_ref, self.target,
            samples=self.tr["samples"], depth=self.tr["depth"],
            seed=self.ctx.seed, lr=self.tr["lr"],
            optimize=self.tr["optimize"], device=self.dev)
        steps = self.chk["steps"]
        t0 = time.perf_counter()
        losses, first, _, kept = ref.run(self.params0, steps, at=(steps,))
        counted = compare.counted_leaves(first)

        def change_gap(program, reference, base):
            return compare.leaf_gaps(
                {k: program[k] - base[k] for k in reference},
                {k: reference[k] - base[k] for k in reference}, counted)

        out = {"loss_gap": max(compare.rel_gap(p, r)
                               for p, r in zip(self.losses, losses)),
               "grad_gap": compare.leaf_gaps(self.first_grad, first,
                                             counted),
               "update_gap": change_gap(self.after, kept[steps],
                                        self.params0),
               "drawn_loss_gap": 0.0, "drawn_update_gap": 0.0}
        for i in self.drawn:
            if i not in self.kept:
                out["drawn_loss_gap"] = out["drawn_update_gap"] = math.inf
                continue
            before, m, v, after = self.kept[i]
            k = steps + i
            loss, p, _, _ = ref.step_from(before, m, v, k, k)
            out["drawn_loss_gap"] = max(out["drawn_loss_gap"],
                                        compare.rel_gap(self.losses[k], loss))
            out["drawn_update_gap"] = max(out["drawn_update_gap"],
                                          change_gap(after, p, before))
        print(f"the reference took {steps + len(self.kept)} steps in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        return out


def run(ctx):
    cell = MeshRecoverCell(ctx)
    return single.run(ctx, cell, time.perf_counter())
