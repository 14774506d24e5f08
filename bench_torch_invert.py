#!/usr/bin/env python3
"""Material-recovery benchmark of pathtracer_tpu_torch on one NVIDIA GPU,
the port's counterpart of bench_invert.py (same workloads, same protocol).

    python3 bench_torch_invert.py [--workloads cornell,garden]
                                  [--cornell-steps N] [--garden-steps N]
                                  [--out FILE] [--profile]

Workloads:
  * cornell: recover every visible diffuse albedo and the light's emission
    of the Cornell box, 128^2, 384 spp (192 + 192 paired), depth 5,
    backend="brute", from a 32768-spp target rendered by backend="cuda";
    four warm-restart segments of steps/4 at 192, 192, 384, 384 spp, as
    bench_invert.py runs it.  Bar: visible-diffuse albedo error < 0.05.
  * garden: mesh_garden() (105,708 triangles), 64^2, 8 spp, depth 4,
    backend="cluster" (the CUDA cluster kernel on the gradient path), the
    albedos from a 8192-spp target rendered by backend="beam", cosine decay
    to 8e-3; first a one-sided gradcheck of the two largest albedo
    gradients at 2 spp, depth 3 (bar 0.05).  Bar: pixel-weighted
    visible-diffuse albedo error < 0.15.

With ``--profile`` each workload runs 3 steps under ``torch.profiler``
instead (after one warm-up step, targets at 1024 spp): the wall time, the
device time of all kernels, their share of the wall time (the device's
busy share; the rest is the host holding the card back) and the kernels
that take the most device time.

Each workload prints one JSON line: the recovery error beside
INVERT_r05.json's (the JAX package's run: the errors do not depend on the
hardware; its seconds per step are TPU times and are not repeated here),
the wall seconds per step, peak device memory, the cluster kernel's
launches per step, and the card's name and power limit.  The lines also go
to ``--out`` (default build/bench_torch_invert.json, git-ignored).
Without a CUDA device it exits with an error.
"""

import argparse
import collections
import functools
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
JAX_RUN = os.path.join(REPO, "INVERT_r05.json")


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def jax_errors():
    """{metric: the JAX package's recorded error} from INVERT_r05.json."""
    with open(JAX_RUN) as f:
        return {w["metric"]: w["value"] for w in json.load(f)["workloads"]}


def pixel_weighted_err(alb, alb_true, counts, mtype, diffuse):
    """Mean abs albedo error weighted by the primary-hit pixel counts of
    the diffuse triangles (bench_invert.py's)."""
    import numpy as np
    w = counts * (mtype == diffuse)
    e = np.abs(alb - alb_true).mean(axis=1)
    return float((e * w).sum() / max(w.sum(), 1))


def timed(fn):
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def cornell(pt, steps):
    import numpy as np
    from pathtracer_tpu_torch import inverse

    res, depth, spp = 128, 5, 384
    cam, scene = pt.cornell_box(res=(res, res))
    target = pt.render_film(cam, scene, 32768, depth, backend="cuda").data
    counts = inverse.visible_pixel_counts(cam, scene)
    mtype, alb_true, emit_true, _ = scene.host_materials()
    vis = (counts >= max(1, res * res // 1000)) & (mtype == pt.DIFFUSE)

    def run():
        # Warm restarts, Adam reset per segment, samples ramped: the JAX
        # package measured this better than one long run (0.030 vs 0.075).
        p0, losses = None, []
        seg = max(steps // 4, 1)
        for seg_spp in (spp // 2, spp // 2, spp, spp):
            mats, ls = inverse.recover_materials(
                cam, scene, target, steps=seg, samples=seg_spp, depth=depth,
                lr=0.08, backend="brute", params0=p0,
                optimize=("albedo", "emit"))
            p0 = inverse.to_unconstrained(mats)
            losses.extend(ls.tolist())
        return mats, losses

    (mats, losses), wall, peak = timed(run)
    alb = mats["albedo"].cpu().numpy()[:scene.num_tris]
    emit = mats["emit"].cpu().numpy()[:scene.num_tris]
    err = float(np.abs(alb - alb_true)[vis].mean())
    light = mtype == pt.EMIT
    return {"metric": "invert_cornell_visible_albedo_err", "value": err,
            "recovered": err < 0.05, "bar": 0.05,
            "emit_err": float(np.abs(emit[light] - emit_true[light]).mean()),
            "res": res, "spp": spp, "depth": depth,
            "steps": 4 * max(steps // 4, 1), "backend": "brute",
            "seconds_per_step": wall / len(losses), "peak_bytes": peak,
            "loss_first": losses[0], "loss_last": losses[-1],
            "visible_diffuse_tris": int(vis.sum())}


def garden(pt, steps):
    import dataclasses
    import torch
    from pathtracer_tpu_torch import diff, inverse
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck

    res, depth, spp = 64, 4, 8
    cam, sb = pt.meshes.mesh_garden()
    scene = sb.build()
    cam = dataclasses.replace(cam, res=(res, res))
    target = pt.render_film(cam, scene, 8192, depth, backend="beam").data
    counts = inverse.visible_pixel_counts(cam, scene)

    params = diff.material_params(scene)
    gc_loss = diff.make_loss(cam, scene, target, 2, 3, backend="cluster")
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    g = torch.autograd.grad(gc_loss(leaves), [leaves["albedo"]])[0]
    probe = torch.argsort(g.abs().flatten())[-2:].tolist()
    _, gc_rel = diff.gradcheck(gc_loss, params, eps=2e-2,
                               indices=[("albedo", i) for i in probe],
                               mode="one_sided")

    n0 = ck.LAUNCHES
    (mats, losses), wall, peak = timed(lambda: inverse.recover_materials(
        cam, scene, target, steps=steps, samples=spp, depth=depth, lr=0.08,
        lr_end=8e-3, backend="cluster", optimize=("albedo",)))
    launches = ck.LAUNCHES - n0
    if launches != steps * 2 * depth:
        raise RuntimeError(f"{launches} cluster launches in {steps} steps")
    mtype, alb_true, _, _ = scene.host_materials()
    err = pixel_weighted_err(mats["albedo"].cpu().numpy()[:scene.num_tris],
                             alb_true, counts, mtype, pt.DIFFUSE)
    return {"metric": "invert_garden105k_pixel_weighted_albedo_err",
            "value": err, "recovered": err < 0.15, "bar": 0.15,
            "tris": scene.num_tris, "res": res, "spp": spp, "depth": depth,
            "steps": steps, "backend": "cluster",
            "seconds_per_step": wall / steps, "peak_bytes": peak,
            "cluster_launches_per_step": launches / steps,
            "gradcheck_rel_err": gc_rel, "gradcheck_ok": gc_rel < 0.05,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1])}


PROFILE_STEPS = 3


def profile(pt, name):
    """3 recovery steps of workload ``name`` under torch.profiler, after a
    warm-up step."""
    import dataclasses
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from pathtracer_tpu_torch import inverse

    if name == "cornell":
        cam, scene = pt.cornell_box(res=(128, 128))
        kw = dict(samples=384, depth=5, lr=0.08, backend="brute",
                  optimize=("albedo", "emit"))
        target_backend = "cuda"
    else:
        cam, sb = pt.meshes.mesh_garden()
        scene = sb.build()
        cam = dataclasses.replace(cam, res=(64, 64))
        kw = dict(samples=8, depth=4, lr=0.08, lr_end=8e-3,
                  backend="cluster", optimize=("albedo",))
        target_backend = "beam"
    target = pt.render_film(cam, scene, 1024, kw["depth"],
                            backend=target_backend).data
    inverse.recover_materials(cam, scene, target, steps=1, **kw)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inverse.recover_materials(cam, scene, target, steps=PROFILE_STEPS,
                                  **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # The device's own events (kernels, copies): the host-side operators
    # carry their kernels' device time too, and would count it twice.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    # Kernel names summed by their first 80 characters: the instances of
    # one template (elementwise_kernel<...>) fall into one family.
    families = collections.Counter()
    for e in events:
        families[e.key[:80]] += e.self_device_time_total
    return {"metric": f"profile_{name}", "steps": PROFILE_STEPS,
            "seconds_per_step": wall_us / PROFILE_STEPS / 1e6,
            "device_ms_per_step": device_us / PROFILE_STEPS / 1e3,
            "device_busy_share": device_us / wall_us,
            "device_launches_per_step": sum(e.count for e in events)
            / PROFILE_STEPS,
            "top_kernels_ms_per_step": {
                k: us / PROFILE_STEPS / 1e3
                for k, us in families.most_common(8)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", default="cornell,garden")
    ap.add_argument("--cornell-steps", type=int, default=1000)
    ap.add_argument("--garden-steps", type=int, default=300)
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "bench_torch_invert.json"))
    ap.add_argument("--profile", action="store_true",
                    help="profile 3 steps of each workload instead")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_torch_invert: no CUDA device; the benchmark runs on "
                 "the card only")
    sys.path.insert(0, REPO)
    import pathtracer_tpu_torch as pt

    card = card_name()
    print(card, flush=True)
    reference = jax_errors()
    runs = {"cornell": lambda: cornell(pt, args.cornell_steps),
            "garden": lambda: garden(pt, args.garden_steps)}
    if args.profile:
        runs = {name: functools.partial(profile, pt, name) for name in runs}
    results = []
    for name in args.workloads.split(","):
        rec = runs[name]()
        rec.update(card=card, torch=torch.__version__)
        if rec["metric"] in reference:
            rec["jax_value"] = reference[rec["metric"]]
        print(json.dumps(rec), flush=True)
        results.append(rec)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workloads": results}, f, indent=1)
    if not all(r.get("recovered", True) and r.get("gradcheck_ok", True)
               for r in results):
        sys.exit("bench_torch_invert: a recovery missed its bar")


if __name__ == "__main__":
    main()
