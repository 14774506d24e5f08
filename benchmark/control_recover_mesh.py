"""The control and the fault of the garden recovery cell's check, the
readings its limits are set between.

    python3 benchmark/control_recover_mesh.py --seeds 1,2,3

prints one JSON line a seed with two sets of the check's numbers, each
read as ``drivers/recover_mesh.py`` reads them with something else in the
program's place: ``bfloat16``, the plain reference computed in bfloat16
(``reference/recover_mesh.py``: bfloat16 paths, the grouped test's hits of
its rays), and ``half_batch``, the float32 reference with half the film's
pixels left out of the loss, the mean taken over the rest (the recovery
counterpart of ``control.py``).  Each follows set-up's ``check.steps``
steps from the grey start, then takes one step from the float32
reference's state after them, as a drawn step of the window is taken from
the program's.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "garden_recover"


def readings(ctx, device) -> dict:
    """{"bfloat16": numbers, "half_batch": numbers} of one seed."""
    import torch
    from benchmark.drivers.recover import TARGET_SEED_MIX
    from benchmark.reference import compare, scenes
    from benchmark.reference.recover import BETAS, start_params
    from benchmark.reference.recover_mesh import MeshRecovery, tracer

    t, chk = ctx.traffic, ctx.workload["check"]
    res = (t["width"], t["height"])
    arrays = scenes.make_scene(ctx.config)
    cam = scenes.make_camera(ctx.config, res)
    pix = torch.arange(res[0] * res[1], device=device)
    target = tracer(arrays, cam, device).film(
        pix % res[0], pix // res[0], t["target_samples"], t["depth"],
        ctx.seed ^ TARGET_SEED_MIX, t["target_samples"])
    p0 = start_params(arrays, device)
    steps = chk["steps"]

    def recovery(dtype, half=False):
        rec = MeshRecovery(arrays, cam, target, samples=t["samples"],
                           depth=t["depth"], seed=ctx.seed, lr=t["lr"],
                           optimize=t["optimize"], device=device,
                           dtype=dtype)
        if half:
            n = rec.w.shape[0] // 2
            rec.w, rec.h, rec.target = rec.w[:n], rec.h[:n], rec.target[:n]
        return rec

    def setup_steps(rec):
        """Set-up's steps from the grey start: the losses, the first
        gradient and the state after them."""
        p = p0
        m = {n: torch.zeros_like(x) for n, x in p0.items()}
        v = {n: torch.zeros_like(x) for n, x in p0.items()}
        losses, first = [], None
        for k in range(steps):
            loss, p, m, v = rec.step_from(p, m, v, k, k)
            losses.append(loss)
            if k == 0:
                first = {n: x / (1.0 - BETAS[0]) for n, x in m.items()}
        return losses, first, (p, m, v)

    def next_step(rec, state):
        """The loss and the parameters of one step from ``state``."""
        return rec.step_from(*state, steps, steps)[:2]

    ref = recovery(torch.float32)
    losses, first, state = setup_steps(ref)
    ref_loss, ref_next = next_step(ref, state)
    counted = compare.counted_leaves(first)

    def change_gap(low, high, base):
        return compare.leaf_gaps({n: low[n] - base[n] for n in high},
                                 {n: high[n] - base[n] for n in high},
                                 counted)

    out = {}
    for name, rec in (("bfloat16", recovery(torch.bfloat16)),
                      ("half_batch", recovery(torch.float32, half=True))):
        low_losses, low_first, low_state = setup_steps(rec)
        low_loss, low_next = next_step(rec, state)
        out[name] = {
            "loss_gap": max(compare.rel_gap(a, b)
                            for a, b in zip(low_losses, losses)),
            "grad_gap": compare.leaf_gaps(low_first, first, counted),
            "update_gap": change_gap(low_state[0], state[0], p0),
            "drawn_loss_gap": compare.rel_gap(low_loss, ref_loss),
            "drawn_update_gap": change_gap(low_next, ref_next, state[0])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness import core

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = core.context(CELL, seed, 0.0, False, 0.0)
        out = readings(ctx, torch.device("cuda"))
        out.update(workload=CELL, seed=seed, limits=ctx.workload["limits"])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
