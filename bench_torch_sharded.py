#!/usr/bin/env python3
"""Sharded-render benchmark of pathtracer_tpu_torch across the cards of one
host.

    python3 bench_torch_sharded.py [--ranks N] [--out FILE]

One process renders the reference films on cuda:0.  Then N ranks
(spawned, joined by ``parallel.distributed.initialize`` through a file
rendezvous, each on its own card, so it picks NCCL) render the same films
through the sharded entry points on every (tile, sample) split of N:

  * cornell1024: ``render_film_sharded_cuda``, the Cornell box at 1024^2,
    1024 spp, depth 5 (64 trace-kernel launches in one process);
  * garden105708: ``render_film_sharded_beam``, ``mesh_garden()`` at
    512^2, 100 spp, depth 5 (4 beam-kernel launches in one process);
  * train: ``make_sharded_train_step`` on the Cornell box at 128^2, 384
    spp, depth 5, on the (N, 1) split, against the same step on a grid of
    one rank in one process.

Checks: every rank's film is the same, bit for bit, and equals one
process's sums of the same windows added in rank order (on the (N, 1)
split, one process's ``render_film``); the train step's parameters are
the same on every rank.  Times: the median of 3 runs after a warm-up,
host clock from a barrier to the film ended by ``torch.cuda.synchronize``
on each rank, the slowest rank; one process's the same way; train steps:
the median of steps 1-3 (step 0 warms up).  Prints one JSON line (the
card's name and power limit, the backend, the times and the speed-ups
over one process) and writes it to ``--out`` (default
build/bench_torch_sharded.json, git-ignored).  Without N CUDA devices it
exits with an error.
"""

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "bench_torch_sharded")
DEPTH = 5
RUNS = 3
CORNELL_RES, CORNELL_SPP = (1024, 1024), 1024
GARDEN_RES, GARDEN_SPP = (512, 512), 100
TRAIN_RES, TRAIN_SPP, TRAIN_STEPS = (128, 128), 384, 4
TIMEOUT = 900            # seconds for all ranks, start-up included


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"bench_torch_sharded: {msg}")


def splits(n):
    return [(t, n // t) for t in range(n, 0, -1) if n % t == 0]


def scenes(pt, device):
    """{name: (camera, scene, samples, render_film backend, sharded entry
    point)}."""
    cam, cornell = pt.cornell_box(res=CORNELL_RES, device=device)
    cam_g, sb = pt.meshes.mesh_garden(device=device)
    cam_g = dataclasses.replace(cam_g, res=GARDEN_RES)
    return {"cornell1024": (cam, cornell, CORNELL_SPP, "cuda",
                            "render_film_sharded_cuda"),
            "garden105708": (cam_g, sb.build(device=device), GARDEN_SPP,
                             "beam", "render_film_sharded_beam")}


def timed_runs(fn, sync, barrier=lambda: None):
    """(last result, [seconds of each of RUNS runs]) after one warm-up."""
    fn()
    times = []
    for _ in range(RUNS):
        barrier()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.append(time.perf_counter() - t0)
    return out, times


def window_sums(pt, name, cam, scene, spp, tile, sample):
    """One process's film of the (tile, sample) split: each band's sample
    windows summed in rank order, the bands joined, over ``spp``."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as tk

    spp_l = spp // sample
    if name == "cornell1024":
        band = cam.height // tile
        parts = [[tk.render_sum_cuda(cam, scene, s * spp_l, spp_l, DEPTH,
                                     h0=t * band, band_h=band)
                  for s in range(sample)] for t in range(tile)]
        dim = 0
    else:
        wp, hp = bk._padded_res(*cam.res)
        n = wp * hp // bk.TILE_PX // tile
        parts = [[bk.render_tiles_beam(cam, scene, s * spp_l, spp_l, DEPTH,
                                       tile0=t * n, n_tiles=n)
                  for s in range(sample)] for t in range(tile)]
        dim = 1
    bands = []
    for windows in parts:
        acc = windows[0]
        for w in windows[1:]:
            acc = acc + w
        bands.append(acc)
    film = torch.cat(bands, dim=dim)
    if name != "cornell1024":
        film = bk._to_raster(film, *cam.res)
    return film / spp


def train_steps(pt, mesh, device, target):
    """(seconds of each step, losses, final parameters) of TRAIN_STEPS
    steps of the sharded train step on ``mesh``."""
    import torch
    from pathtracer_tpu_torch import inverse
    from pathtracer_tpu_torch.parallel import make_sharded_train_step

    cam, scene = pt.cornell_box(res=TRAIN_RES, device=device)
    step, init = make_sharded_train_step(
        mesh, cam, scene, target, TRAIN_SPP, DEPTH,
        param_transform=inverse.to_materials)
    params = inverse.init_params(scene)
    opt = init(params)
    times, losses = [], []
    for k in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, k)
        losses.append(float(loss))          # waits for the device
        times.append(time.perf_counter() - t0)
    return times, losses, {n: p.detach().cpu() for n, p in params.items()}


def rank_main(rank, world, device, work):
    """One rank: every split of every scene, then the train steps; saves
    films, parameters and times to ``work``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.parallel import distributed, make_mesh, shard

    dev = distributed.initialize(f"file://{os.path.join(work, 'store')}",
                                 world, rank, device=device,
                                 timeout=TIMEOUT // 2)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    out = {"backend": dist.get_backend(), "device": str(dev)}
    for name, (cam, scene, spp, _, fn) in scenes(pt, dev).items():
        for tile, sample in splits(world):
            mesh = make_mesh(tile=tile, sample=sample)
            film, times = timed_runs(
                lambda: getattr(shard, fn)(mesh, cam, scene, spp, DEPTH),
                sync, dist.barrier)
            key = f"{name} {tile}x{sample}"
            out[key] = times
            torch.save(film.data.cpu(), os.path.join(work, f"{key}.{rank}"))
    target = torch.load(os.path.join(work, "target")).to(dev)
    times, losses, params = train_steps(
        pt, make_mesh(tile=world, sample=1), dev, target)
    out["train"] = {"seconds": times, "losses": losses}
    torch.save(params, os.path.join(work, f"train.{rank}"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "bench_torch_sharded.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card per rank) or cpu (a rehearsal with "
                         "gloo ranks)")
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    sys.path.insert(0, REPO)
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.parallel import make_mesh

    if args.device == "cuda":
        check(torch.cuda.is_available()
              and torch.cuda.device_count() >= args.ranks,
              f"needs {args.ranks} CUDA devices, found "
              f"{torch.cuda.device_count()}")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        dev = torch.device("cuda", 0)
        sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
    else:
        card, dev, sync = "cpu", torch.device("cpu"), lambda: None
    print(card, flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    # One process: the reference films, window sums and times.
    result = {"card": card, "ranks": args.ranks, "depth": DEPTH}
    refs = {}
    for name, (cam, scene, spp, backend, _) in scenes(pt, dev).items():
        film, times = timed_runs(lambda: pt.render_film(
            cam, scene, spp, DEPTH, backend=backend).data, sync)
        result[name] = {"spp": spp, "res": list(cam.res),
                        "single_seconds": statistics.median(times),
                        "single_runs": times}
        refs[name] = {split: window_sums(pt, name, cam, scene, spp, *split)
                      for split in splits(args.ranks)}
        check(torch.equal(refs[name][(args.ranks, 1)], film),
              f"{name}: one process's bands differ from its render_film")
    cam, scene = pt.cornell_box(res=TRAIN_RES, device=dev)
    target = pt.render_film(cam, scene, 4096, DEPTH).data
    torch.save(target.cpu(), os.path.join(WORK, "target"))
    single_times, _, _ = train_steps(pt, make_mesh(), dev, target)
    del scene
    sync()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ctx = mp.start_processes(rank_main, args=(args.ranks, args.device, WORK),
                             nprocs=args.ranks, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=5):       # raises if a rank failed
            check(time.perf_counter() - t0 < TIMEOUT,
                  f"the ranks did not finish in {TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    ranks = []
    for r in range(args.ranks):
        with open(os.path.join(WORK, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    result["backend"] = ranks[0]["backend"]
    result["devices"] = [r["device"] for r in ranks]

    for name in refs:
        result[name]["splits"] = {}
        for split in splits(args.ranks):
            key = f"{name} {split[0]}x{split[1]}"
            films = [torch.load(os.path.join(WORK, f"{key}.{r}"))
                     for r in range(args.ranks)]
            check(all(torch.equal(f, films[0]) for f in films),
                  f"{key}: the ranks' films differ")
            check(torch.equal(films[0], refs[name][split].cpu()),
                  f"{key}: not one process's window sums, bit for bit")
            runs = [max(r[key][i] for r in ranks) for i in range(RUNS)]
            med = statistics.median(runs)
            result[name]["splits"][f"{split[0]}x{split[1]}"] = {
                "seconds": med, "runs": runs,
                "speedup": result[name]["single_seconds"] / med}
    params = [torch.load(os.path.join(WORK, f"train.{r}"))
              for r in range(args.ranks)]
    check(all(torch.equal(p[k], params[0][k]) for p in params
              for k in params[0]), "train: the ranks' parameters differ")
    steps = [max(r["train"]["seconds"][k] for r in ranks)
             for k in range(TRAIN_STEPS)]
    result["train"] = {
        "res": list(TRAIN_RES), "spp": TRAIN_SPP, "split": f"{args.ranks}x1",
        "seconds_per_step": statistics.median(steps[1:]), "steps": steps,
        "single_seconds_per_step": statistics.median(single_times[1:]),
        "single_steps": single_times, "losses": ranks[0]["train"]["losses"]}
    result["train"]["speedup"] = (result["train"]["single_seconds_per_step"]
                                  / result["train"]["seconds_per_step"])
    line = json.dumps(result)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
