"""Sharded render jobs through ``parallel.shard.render_film_sharded_cuda``,
one process a card, over ``torch.distributed`` (NCCL between cards).

The process that runs the cell is rank 0; it starts the other ranks with
the ``spawn`` method and joins them through a TCP rendezvous on a free
port of ``localhost``.  Each request starts when every rank has received
rank 0's go (a broadcast, read back on each host: a barrier) and ends when
rank 0's assembled film is on its device; each rank renders its band of
rows, and the bands are gathered on every rank.  Rank 0 keeps the checked
pixels of each film for the check, which is the offline render's
(``render.film_gap_of_jobs``: the plain reference over pixels and jobs
drawn from the seed).
"""

from __future__ import annotations

import os
import shutil
import socket
import sys
import tempfile
import time

from benchmark.drivers import render
from benchmark.harness import single
from benchmark.harness import trace as tr
from benchmark.harness.core import Run, Window
from benchmark.reference import compare, scenes

JOIN_SECONDS = 120
COLLECTIVE_SECONDS = 180


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, ctx, tmp: str):
    """One rank's run; rank 0 returns the cell's ``Run``."""
    import torch
    import torch.distributed as dist
    from torch.profiler import record_function
    from pathtracer_tpu_torch.camera import make_camera
    from pathtracer_tpu_torch.parallel import distributed, mesh, shard
    from pathtracer_tpu_torch.scene import Scene

    t_import = time.perf_counter()
    dev = distributed.initialize(f"tcp://localhost:{port}", world, rank,
                                 device=ctx.device,
                                 timeout=COLLECTIVE_SECONDS)
    t_joined = time.perf_counter()
    cuda = dev.type == "cuda"
    t = ctx.traffic
    arrays = scenes.make_scene(ctx.config)
    res = (t["width"], t["height"])
    camera = make_camera(**scenes.camera_args(ctx.config, res), device=dev)
    scene = Scene.from_arrays(*arrays.as_args(), device=dev)
    grid = mesh.make_mesh(world, tile=t["tile"], sample=world // t["tile"])

    def job(seed):
        return shard.render_film_sharded_cuda(grid, camera, scene,
                                              t["samples"], t["depth"],
                                              seed=seed).data

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    warm = ctx.workload.get("warmup_samples", t["samples"])
    shard.render_film_sharded_cuda(grid, camera, scene, warm, t["depth"],
                                   seed=ctx.seed ^ render.WARM_SEED_MIX)
    sync()
    t_warm = time.perf_counter()
    dist.barrier()
    setup_s = time.perf_counter() - ctx.t0
    if rank == 0:
        print(f"setup {setup_s:.3f} s: {t_import - ctx.t0:.3f} s to the "
              f"port's import, {t_joined - t_import:.3f} s to join the "
              f"ranks, {t_warm - t_joined:.3f} s to the warm-up's end, "
              f"{ctx.t0 + setup_s - t_warm:.3f} s in the barrier",
              file=sys.stderr)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = tr.profiler() if ctx.trace else None
    flag = torch.ones(1, device=dev)
    spans, kept = [], []
    pw, ph = render.draw_pixels(ctx.seed, ctx.workload["check"]["pixels"],
                                *res, dev)
    with record_function("bench.window"):
        start = time.perf_counter()
        while True:
            if rank == 0:
                flag.fill_(float(not spans
                                 or spans[-1][1] - start < ctx.seconds))
            dist.broadcast(flag, 0)
            if flag.item() == 0.0:
                break
            t0 = time.perf_counter()
            with record_function("bench.request"):
                film = job(ctx.seed + len(spans))
                if rank == 0:
                    kept.append(film[ph, pw])
                sync()
            spans.append((t0, time.perf_counter()))
    if prof is not None:
        prof.stop()
        tr.export(prof, tmp, rank)
    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev)
                               if cuda else 0)], device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return None

    n = len(spans)
    window = Window(setup_s, spans, [float(res[0] * res[1] * t["samples"]
                                           * t["depth"])] * n)
    del scene, camera
    cam_ref = scenes.make_camera(ctx.config, res)
    work = (render.trace_kernel_work(ctx, arrays, cam_ref, dev, n)
            if ctx.trace else {})
    if cuda:
        torch.cuda.empty_cache()
    tracer = render.reference_tracer(ctx.workload["check"]["tracer"], arrays,
                                     cam_ref, dev)
    verdict = compare.verdict(
        {"film_gap": render.film_gap_of_jobs(ctx, tracer, kept, n, pw, ph)},
        ctx.workload["limits"])
    traced = None
    if ctx.trace:
        ranks = [tr.load_chrome(os.path.join(tmp, f"trace_rank{r}.json"))
                 for r in range(world)]
        traced = tr.TraceRun(ranks, n, work,
                             single.device_info(ctx, world, 0)["kind"])
    device = single.device_info(ctx, world, int(peak.item()), traced)
    return Run(window, verdict["checks"], verdict["correct"], device,
               traced)


def _child(rank, world, port, ctx, tmp):
    rank_main(rank, world, port, ctx, tmp)


def run(ctx):
    import multiprocessing as mp
    world = int(ctx.workload["chips"])
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="bench_shard_")
    spawn = mp.get_context("spawn")
    children = [spawn.Process(target=_child,
                              args=(r, world, port, ctx, tmp), daemon=True)
                for r in range(1, world)]
    try:
        if ctx.device == "cuda":
            # Build the kernels once, before the ranks start.
            from pathtracer_tpu_torch.utils import build
            build.load_library()
        for c in children:
            c.start()
        result = rank_main(0, world, port, ctx, tmp)
        for c in children:
            c.join(JOIN_SECONDS)
        if any(c.exitcode != 0 for c in children):
            raise RuntimeError(
                f"a rank failed: exit codes {[c.exitcode for c in children]}")
        return result
    finally:
        for c in children:
            if c.is_alive():
                c.terminate()
                c.join(JOIN_SECONDS)
        shutil.rmtree(tmp, ignore_errors=True)
