"""Frames of the program's realtime viewer, ``realtime.RealtimeSession``.

One session lives from set-up to the end of the window, as a viewer's
does.  Before global frame g (counted from the session's start), where
g > 0 and g is a multiple of the traffic's ``key_every``, the next key of
the traffic's ``keys`` cycle is pressed with ``RealtimeSession.key``; then
``step()`` renders the frame, blends it into the running mean and returns
the display on the host.  Warm-up runs frames 0 to ``key_every``, so the
first key and the frame after it fall in set-up; each request is the
next frame.  Every request keeps the displayed values at ``check.pixels``
pixels drawn from the seed; the keys pressed before it and its index
since the last key follow from the schedule, not from the session.

Check: after the window, ``check.frames`` of the requests, drawn from the
seed, are replayed by the plain viewer (``reference.realtime``: the key
history's camera, the beam reference's frames since the last key at seeds
``seed + k`` in launches of ``check.launch_spp``, the float32 blend, the
tone map); ``film_gap`` compares their displayed values.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark.counts import beam_layout
from benchmark.counts import work as counts
from benchmark.drivers.render import count_jobs, draw_jobs, draw_pixels
from benchmark.harness import single
from benchmark.harness.core import rng_for
from benchmark.reference import compare, scenes
from benchmark.reference.realtime import Viewer


def schedule(traffic: dict, g: int):
    """(the keys pressed before global frame g, g's index since the last
    key) under the traffic's key schedule."""
    every, cycle = traffic["key_every"], traffic["keys"]
    return (tuple(cycle[i % len(cycle)] for i in range(g // every)),
            g % every)


class RealtimeCell:
    def __init__(self, ctx):
        from pathtracer_tpu_torch.camera import make_camera
        from pathtracer_tpu_torch.realtime import RealtimeSession
        from pathtracer_tpu_torch.scene import Scene

        self.ctx, self.tr, self.chk = ctx, ctx.traffic, ctx.workload["check"]
        self.res = (self.tr["width"], self.tr["height"])
        self.arrays = scenes.make_scene(ctx.config)
        self.cam_ref = scenes.make_camera(ctx.config, self.res)
        self.dev = torch.device(ctx.device)
        camera = make_camera(**scenes.camera_args(ctx.config, self.res),
                             device=ctx.device)
        scene = Scene.from_arrays(*self.arrays.as_args(), device=ctx.device)
        self.session = RealtimeSession(
            camera, scene, self.tr["depth"], self.tr["frame_samples"],
            seed=ctx.seed, backend=self.tr["backend"])
        self.pw, self.ph = (p.numpy() for p in draw_pixels(
            ctx.seed, self.chk["pixels"], *self.res, "cpu"))
        self.first = self.tr["key_every"] + 1
        self.g = 0
        self.kept = []

    def _frame(self):
        keys, k = schedule(self.tr, self.g)
        if keys and k == 0:
            self.session.key(keys[-1])
        self.g += 1
        return self.session.step()

    def warmup(self):
        """Frames 0 to ``key_every``: the first key and the frame after
        it."""
        while self.g < self.first:
            self._frame()

    def request(self, i: int):
        shown = self._frame()
        self.kept.append(torch.from_numpy(shown[self.ph, self.pw]))

    def work(self, i: int) -> float:
        w, h = self.res
        return float(w * h * self.tr["frame_samples"] * self.tr["depth"])

    def trace_work(self, n: int) -> dict:
        """The beam kernel's operations for the window's n frames, from a
        seeded sample of their paths, each frame under its own camera and
        seed."""
        n_tris = self.arrays.num_tris
        layout = beam_layout.build(self.arrays.v1[:n_tris],
                                   self.arrays.v2[:n_tris],
                                   self.arrays.v3[:n_tris])
        w, h = self.res
        spp, depth = self.tr["frame_samples"], self.tr["depth"]
        rng = rng_for(self.ctx.seed, 0xC0C0)
        frames = count_jobs(rng, n)
        per = self.chk["count_samples"]
        pixels = max(1, self.chk["count_paths"] // len(frames) // per)
        viewer = self._viewer(None, None)
        ops = 0
        for i in frames:
            keys, k = schedule(self.tr, self.first + i)
            tracer = viewer.tracer(keys)
            pix = torch.from_numpy(rng.choice(w * h, pixels,
                                              replace=False)).to(self.dev)
            for s in rng.choice(spp, per, replace=False):
                segs = tracer.segments(pix % w, pix // w, int(s), depth,
                                       self.ctx.seed + k)
                ops += counts.beam_work(segs, layout)["ops"]
        return {"beam_kernel": ops * n * w * h * spp
                / (len(frames) * pixels * per)}

    def _viewer(self, w, h, dtype=torch.float32):
        return Viewer(self.arrays, self.cam_ref, self.dev, w, h,
                      self.tr["depth"], self.tr["frame_samples"],
                      self.ctx.seed, self.chk["launch_spp"], dtype)

    def release(self):
        del self.session

    def check(self, n: int) -> dict:
        """film_gap: the worst of the drawn frames, the kept displayed
        values against the plain viewer's."""
        viewer = self._viewer(torch.from_numpy(self.pw).to(self.dev),
                              torch.from_numpy(self.ph).to(self.dev))
        t0 = time.perf_counter()
        worst = 0.0
        for i in draw_jobs(self.ctx.seed, n, self.chk["frames"]):
            keys, k = schedule(self.tr, self.first + i)
            worst = max(worst, compare.film_gap(self.kept[i],
                                                viewer.display(keys, k)))
        print(f"the reference rendered {viewer.rendered} frames in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        return {"film_gap": worst}


def run(ctx):
    cell = RealtimeCell(ctx)
    return single.run(ctx, cell, time.perf_counter())
