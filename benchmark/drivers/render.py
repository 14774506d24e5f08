"""Offline render jobs through the program's ``render.render_film``.

Each request renders one whole film (the traffic's width, height, samples,
depth and backend) with the job's own seed, ``seed + job index``, and ends
when the film is on the device.  The values of ``check.pixels`` pixels,
drawn from the seed once, are kept from every film (one small gather on
the device); the film itself is freed, as a user who saves it would.

Check: after the window, ``check.jobs`` of the jobs, drawn from the seed,
are rendered again at those pixels by the plain reference
(``check.tracer``: ``"plucker"`` or ``"mt"`` for the trace megakernel's
route, ``"beam"`` for the coherent-beam route), each summing its samples
in launches of ``check.launch_spp``; ``film_gap`` compares them.
"""

from __future__ import annotations

import time

from benchmark.counts import beam_layout
from benchmark.counts import work as counts
from benchmark.harness import single
from benchmark.harness.core import rng_for
from benchmark.reference import compare, scenes
from benchmark.reference.beam import BeamTracer
from benchmark.reference.render import PixelTracer

WARM_SEED_MIX = 0x5EED


def reference_tracer(kind: str, sc, cam, device, dtype=None):
    import torch
    dtype = torch.float32 if dtype is None else dtype
    if kind == "beam":
        return BeamTracer(sc, cam, device, dtype)
    return PixelTracer(sc, cam, device, loop=kind, dtype=dtype)


def draw_pixels(seed: int, pixels: int, width: int, height: int, device):
    """(w, h) of the checked pixels, drawn from the seed: int64 tensors on
    ``device``."""
    import torch
    pix = torch.from_numpy(rng_for(seed, 0xC4EC).choice(
        width * height, size=pixels, replace=False)).to(device)
    return pix % width, pix // width


def draw_jobs(seed: int, n_jobs: int, jobs: int):
    """``jobs`` of the ``n_jobs`` done, drawn from the seed."""
    return sorted(rng_for(seed, 0x10B5).choice(
        n_jobs, size=min(jobs, n_jobs), replace=False).tolist())


def film_gap_of_jobs(ctx, tracer, kept, n: int, w, h) -> float:
    """The worst ``film_gap`` of the drawn jobs: the kept pixel values of
    each (``kept[j]``, (P, 3)) against the reference's."""
    t, chk = ctx.traffic, ctx.workload["check"]
    worst = 0.0
    for j in draw_jobs(ctx.seed, n, chk["jobs"]):
        ref = tracer.film(w, h, t["samples"], t["depth"], ctx.seed + j,
                          chk["launch_spp"])
        worst = max(worst, compare.film_gap(kept[j], ref))
    return worst


def trace_kernel_work(ctx, arrays, cam_ref, dev, n: int) -> dict:
    """The trace kernel's operations for n jobs of the traffic, seeds
    ``ctx.seed + j``, from ``check.count_paths`` paths drawn from the
    seed (their live segments by the plain reference, scaled)."""
    import torch
    tr, chk = ctx.traffic, ctx.workload["check"]
    rng = rng_for(ctx.seed, 0xC0C0)
    w, h, spp, depth = tr["width"], tr["height"], tr["samples"], tr["depth"]
    jobs = count_jobs(rng, n)
    per_job = max(1, chk["count_paths"] // len(jobs))
    tracer = reference_tracer(chk["tracer"], arrays, cam_ref, dev)
    segments = 0
    for j in jobs:
        pw, ph, ps = (torch.from_numpy(a).to(dev)
                      for a in counts.sample(rng, w, h, spp, per_job))
        segments += int(tracer.path_lengths(pw, ph, ps, depth,
                                            ctx.seed + j).sum())
    paths = n * w * h * spp
    return {"trace_kernel": counts.trace_ops(
        arrays.num_tris, segments * paths / (len(jobs) * per_job), paths)}


def count_jobs(rng, n: int, most: int = 8):
    """The jobs whose paths the work count samples: jobs differ only by
    their seed, so a few stand for all."""
    return sorted(rng.choice(n, size=min(n, most), replace=False).tolist())


class RenderCell:
    def __init__(self, ctx):
        import torch
        from pathtracer_tpu_torch.camera import make_camera
        from pathtracer_tpu_torch.scene import Scene

        self.ctx, self.tr, self.chk = ctx, ctx.traffic, ctx.workload["check"]
        self.res = (self.tr["width"], self.tr["height"])
        self.arrays = scenes.make_scene(ctx.config)
        self.cam_ref = scenes.make_camera(ctx.config, self.res)
        self.dev = torch.device(ctx.device)
        self.camera = make_camera(**scenes.camera_args(ctx.config, self.res),
                                  device=ctx.device)
        self.scene = Scene.from_arrays(*self.arrays.as_args(),
                                       device=ctx.device)
        self.pw, self.ph = draw_pixels(ctx.seed, self.chk["pixels"],
                                       *self.res, self.dev)
        self.kept = []

    def _render(self, seed: int, samples=None):
        from pathtracer_tpu_torch.render import render_film
        return render_film(self.camera, self.scene,
                           samples or self.tr["samples"],
                           self.tr["depth"], seed=seed,
                           backend=self.tr["backend"]).data

    def warmup(self):
        """One job of the cell's launch shape: ``warmup_samples`` of the
        workload where the job's launches all have one shape."""
        self._render(self.ctx.seed ^ WARM_SEED_MIX, self.ctx.workload.get(
            "warmup_samples", self.tr["samples"]))

    def request(self, i: int):
        self.kept.append(self._render(self.ctx.seed + i)[self.ph, self.pw])

    def work(self, i: int) -> float:
        w, h = self.res
        return float(w * h * self.tr["samples"] * self.tr["depth"])

    def trace_work(self, n: int) -> dict:
        """Operations of the window's n jobs, from a seeded sample of their
        paths."""
        if self.chk["tracer"] == "beam":
            return self._beam_work(n)
        return trace_kernel_work(self.ctx, self.arrays, self.cam_ref,
                                 self.dev, n)

    def _beam_work(self, n: int) -> dict:
        import torch
        n_tris = self.arrays.num_tris
        layout = beam_layout.build(self.arrays.v1[:n_tris],
                                   self.arrays.v2[:n_tris],
                                   self.arrays.v3[:n_tris])
        tracer = BeamTracer(self.arrays, self.cam_ref, self.dev)
        w, h = self.res
        spp, depth = self.tr["samples"], self.tr["depth"]
        rng = rng_for(self.ctx.seed, 0xC0C0)
        jobs = count_jobs(rng, n)
        samples_per_job = self.chk["count_samples"]
        pixels = max(1, self.chk["count_paths"] // len(jobs)
                     // samples_per_job)
        ops = 0
        for j in jobs:
            pix = torch.from_numpy(rng.choice(w * h, pixels,
                                              replace=False)).to(self.dev)
            for s in rng.choice(spp, samples_per_job, replace=False):
                segs = tracer.segments(pix % w, pix // w, int(s), depth,
                                       self.ctx.seed + j)
                ops += counts.beam_work(segs, layout)["ops"]
        paths = n * w * h * spp
        return {"beam_kernel": ops * paths
                / (len(jobs) * pixels * samples_per_job)}

    def release(self):
        del self.scene, self.camera

    def check(self, n: int) -> dict:
        """film_gap: the worst checked job's."""
        tracer = reference_tracer(self.chk["tracer"], self.arrays,
                                  self.cam_ref, self.dev)
        return {"film_gap": film_gap_of_jobs(self.ctx, tracer, self.kept, n,
                                             self.pw, self.ph)}


def run(ctx):
    cell = RenderCell(ctx)
    return single.run(ctx, cell, time.perf_counter())
