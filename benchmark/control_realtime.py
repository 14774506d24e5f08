"""The control and the faults of the realtime cell's check, the readings
its ``film_gap`` limit is set between.

    python3 benchmark/control_realtime.py --seeds 1,2,3
    python3 benchmark/control_realtime.py --seeds 1,2,3 --fault half_samples

prints one JSON line a seed.  Without ``--fault``: the plain viewer in
bfloat16 put in the program's place, read against the float32 viewer on
the frames a run of ``--frames`` window frames would check (the realtime
counterpart of ``control.py``).  With ``--fault``: a whole run of the cell
(``--seconds`` of window) with the program broken underneath, as the
check reads it: ``half_samples`` renders each frame at half its samples,
``no_reset`` leaves the film uncleared when the camera changes.  The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "garden_realtime"
# About the frames a 10-s window holds.
WINDOW_FRAMES = 1800


def control_reading(ctx, device, frames: int = WINDOW_FRAMES) -> float:
    """``film_gap`` of the bfloat16 viewer against the float32 one on the
    frames the check of a window of ``frames`` draws."""
    import torch
    from benchmark.drivers.realtime import schedule
    from benchmark.drivers.render import draw_jobs, draw_pixels
    from benchmark.reference import compare, scenes
    from benchmark.reference.realtime import Viewer

    t, chk = ctx.traffic, ctx.workload["check"]
    res = (t["width"], t["height"])
    arrays = scenes.make_scene(ctx.config)
    cam = scenes.make_camera(ctx.config, res)
    w, h = draw_pixels(ctx.seed, chk["pixels"], *res, device)
    viewers = [Viewer(arrays, cam, device, w, h, t["depth"],
                      t["frame_samples"], ctx.seed, chk["launch_spp"], dtype)
               for dtype in (torch.float32, torch.bfloat16)]
    worst = 0.0
    for i in draw_jobs(ctx.seed, frames, chk["frames"]):
        keys, k = schedule(t, t["key_every"] + 1 + i)
        ref, low = (v.display(keys, k) for v in viewers)
        worst = max(worst, compare.film_gap(low, ref))
    return worst


def broken(fault: str):
    """A context in which the program has ``fault``."""
    from pathtracer_tpu_torch import realtime

    if fault == "half_samples":
        render = realtime.render_film

        def half(camera, scene, samples, *a, **k):
            return render(camera, scene, max(1, samples // 2), *a, **k)
        return _patched(realtime, "render_film", half)
    return _patched(realtime.RealtimeSession, "_reset", lambda self: None)


@contextlib.contextmanager
def _patched(owner, name, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def fault_reading(ctx, fault: str) -> dict:
    from benchmark.harness import core
    with broken(fault):
        run = core.driver(ctx.workload["driver"]).run(ctx)
    return {n: c["value"] for n, c in run.checks.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=("half_samples", "no_reset"))
    ap.add_argument("--frames", type=int, default=WINDOW_FRAMES)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from benchmark.harness import core

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = core.context(CELL, seed, args.seconds, False,
                           time.perf_counter())
        if args.fault:
            out = fault_reading(ctx, args.fault)
        else:
            out = {"film_gap": control_reading(ctx, torch.device("cuda"),
                                               args.frames)}
        out.update(workload=CELL, seed=seed, fault=args.fault,
                   limits=ctx.workload["limits"])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
