"""The control of each cell's check: the plain reference put in the
program's place and computed in bfloat16, the precision below the
configuration's float32, read by the same numbers as the program.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed: the control's numbers and, for render cells,
``film_gap`` of the other float32 intersection test (Möller–Trumbore
against the Plücker reference): what a change of the test's rounding
alone reads.  With ``--fault half_batch`` (recovery cells) the second
run is the float32 reference with half the film's pixels left out of the
loss, the mean taken over the rest: that fault's readings.  A recovery
control follows ``check.steps`` steps and ``--window-steps`` more, as a
run's check follows set-up's steps and the window's.
The benchmark's own runs do not run it.  ``tests/test_bench_control.py``
holds it at a small size on the CPU and at the cell's own size on a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The steps a 10-s window of cornell_recover holds (0.427 s a step).
WINDOW_STEPS = 24


def render_readings(ctx, device) -> dict:
    """The checked jobs and pixels of a run of ``ctx`` that completed
    ``check.jobs`` jobs, in bfloat16 (and by the other loop) against the
    float32 reference."""
    import torch
    from benchmark.drivers import render
    from benchmark.reference import compare, scenes

    t, chk = ctx.traffic, ctx.workload["check"]
    res = (t["width"], t["height"])
    arrays = scenes.make_scene(ctx.config)
    cam = scenes.make_camera(ctx.config, res)
    ref = render.reference_tracer(chk["tracer"], arrays, cam, device)
    low = render.reference_tracer(chk["tracer"], arrays, cam, device,
                                  torch.bfloat16)
    other = (render.reference_tracer("mt", arrays, cam, device)
             if chk["tracer"] == "plucker" else None)
    gaps, alt = [], []
    w, h = render.draw_pixels(ctx.seed, chk["pixels"], *res, device)
    for j in render.draw_jobs(ctx.seed, chk["jobs"], chk["jobs"]):
        args = (w, h, t["samples"], t["depth"], ctx.seed + j,
                chk["launch_spp"])
        base = ref.film(*args)
        gaps.append(compare.film_gap(low.film(*args), base))
        if other is not None:
            alt.append(compare.film_gap(other.film(*args), base))
    out = {"film_gap": max(gaps)}
    if alt:
        out["film_gap_other_loop"] = max(alt)
    return out


def recover_readings(ctx, device, fault=None,
                     window_steps: int = WINDOW_STEPS) -> dict:
    """A run's steps, set-up's and ``window_steps`` of the window, of the
    reference in bfloat16 (or, with ``fault`` ``"half_batch"``, in float32
    over half the pixels) against float32."""
    import torch
    from benchmark.drivers.recover import TARGET_SEED_MIX
    from benchmark.reference import compare, scenes
    from benchmark.reference.recover import Recovery, start_params
    from benchmark.reference.render import PixelTracer

    t, chk = ctx.traffic, ctx.workload["check"]
    res = (t["width"], t["height"])
    arrays = scenes.make_scene(ctx.config)
    cam = scenes.make_camera(ctx.config, res)
    pix = torch.arange(res[0] * res[1], device=device)
    target = PixelTracer(arrays, cam, device, loop="mt").film(
        pix % res[0], pix // res[0], t["target_samples"], t["depth"],
        ctx.seed ^ TARGET_SEED_MIX, t["target_samples"])
    p0 = start_params(arrays, device)
    runs = {}
    low = torch.float32 if fault == "half_batch" else torch.bfloat16
    for name, dtype in (("ref", torch.float32), ("low", low)):
        rec = Recovery(arrays, cam, target, samples=t["samples"],
                       depth=t["depth"], seed=ctx.seed, lr=t["lr"],
                       optimize=t["optimize"], device=device, dtype=dtype)
        if name == "low" and fault == "half_batch":
            n = rec.w.shape[0] // 2
            rec.w, rec.h, rec.target = rec.w[:n], rec.h[:n], rec.target[:n]
        runs[name] = rec.run(p0, chk["steps"] + window_steps,
                             at=(chk["steps"],))
    (lr, fr, zr, kr), (ll, fl, zl, kl) = runs["ref"], runs["low"]
    counted = compare.counted_leaves(fr)

    def change_gap(low, ref):
        return compare.leaf_gaps({n: low[n] - p0[n] for n in ref},
                                 {n: ref[n] - p0[n] for n in ref}, counted)

    return {"loss_gap": max(compare.rel_gap(a, b) for a, b in zip(ll, lr)),
            "grad_gap": compare.leaf_gaps(fl, fr, counted),
            "update_gap": change_gap(kl[chk["steps"]], kr[chk["steps"]]),
            "window_update_gap": change_gap(zl, zr)}


def readings(ctx, device, fault=None,
             window_steps: int = WINDOW_STEPS) -> dict:
    if ctx.workload["driver"] == "recover":
        return recover_readings(ctx, device, fault, window_steps)
    return render_readings(ctx, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=("half_batch",))
    ap.add_argument("--window-steps", type=int, default=WINDOW_STEPS)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness import core

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = core.context(args.workload, seed, 0.0, False, 0.0)
        out = readings(ctx, torch.device("cuda"), args.fault,
                       args.window_steps)
        out.update(workload=args.workload, seed=seed, fault=args.fault,
                   limits=ctx.workload["limits"])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
