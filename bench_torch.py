#!/usr/bin/env python3
"""Headline benchmark of pathtracer_tpu_torch on one NVIDIA GPU, the port's
counterpart of bench.py and bench_bvh.py: the same workloads, the same
timing protocol and the same metric names, and every cell checked for a
correct output.

    python3 bench_torch.py [--cells NAME,NAME] [--repeats N] [--out FILE]
                           [--device cuda|cpu] [size flags, see --help]

Cells, in bench.py's order (depth 5 unless noted; rays are counted as
width x height x spp x depth, the JAX package's convention):
  cornell1024            cornell_box 1024^2, 4096 spp, render_film(backend=
                         "auto"): the trace kernel;
  cornell1024_refconfig  the same at 10,000 spp, 3 runs: the reference
                         renderer's own configuration (112 s on its GPU);
  specular1024           modified_cornell(0.05) 1024^2, 4096 spp: the trace
                         kernel's specular branch (the reference: 230 s at
                         10,000 spp);
  sphere9812_beam        meshes.sphere_in_box(50, 100) at its camera's
                         512^2, 256 spp, backend="beam": the beam kernel;
  sphere9812_cluster     the same, backend="cluster": the tile driver over
                         the cluster kernel (per-pixel independent samples);
  garden105708_beam      meshes.mesh_garden() at its camera's 512^2, 64 spp,
                         backend="beam";
  wavefront512_d5, wavefront512_d16
                         cornell_box 512^2, 64 spp, depth 5 and 16,
                         backend="wavefront" beside the megakernel
                         (backend="cuda") on the same work.
The large scenes run at their cameras' own 512^2, not bench.py's 256^2,
which kept a TPU's fixed cost per call small.

Timing, bench.py's protocol: one untimed call, which builds the kernel
library and the accel and fills the caches, then --repeats runs
(--refconfig-repeats for the refconfig), each a host clock around
render_film ended by torch.cuda.synchronize (utils.timer.Timer).  The
metric is the median rays/s, beside its min, max, spread and run count.
A slow headline is flagged ("regression": true and notes), never raised.
Each line also holds the kernel launches of one run, the cell's kernel's
device ms per launch at the cell's launch shape (utils.timer.device_ms),
the peak device memory of the runs, for the large scenes the host ms of
one Scene.fingerprint() (the key of every call's accel cache), and the
card's name and power limit.

Checks, made outside the timed runs; "correct" holds when all of a
cell's checks hold (the helpers of chip_smoke.py where it has them):
  finite      the film is finite and not all zero;
  launched    (on a card) the timed runs launched the cell's kernel;
  slice       the cell's kernel against its plain version on a slice of
              the cell's own work, bit for bit: a band of 16 rows through
              the film's middle at 4 spp (trace); two bands of two tiles,
              the film's first and its centre, at the main path's samples
              a launch (beam, chip_smoke.hold_main_path_bands); 2^15 of
              the cell's camera rays, with and without the ray sort
              (cluster, chip_smoke.hold_clusters);
  light       (the Cornell cells) the brightest pixel's centre ray hits
              the light; in the specular box, one of the pixels at the
              brightest value, since the glossy walls' reflections of the
              light saturate the 8-bit film as the light does
              (chip_smoke.brightest_sees_light);
  golden      (the large scenes, at depth 5) the cell's own film on the
              pixels of the committed 2048-spp render (docs/), written as
              a PNG and read back: linear means within 2%
              (chip_smoke.golden_compare, GOLDEN_MEAN_RTOL);
  golden_converged
              the same bar on a render of those pixels through the cell's
              route at 2048 spp, for the beam at 2^21 tile-samples (its
              2048 pixels a tile share their bounces, so its noise falls
              with the tile-samples, not the pixel-samples; at 256 spp the
              sphere's beam film read -15.9% to +11.4% over seeds 1-6);
  wavefront   (the wavefront cells) at most 1% of the pixels beyond 2e-4
              of the megakernel's film, its "mt" instance (the brute
              wavefront's intersection arithmetic; the share against the
              timed default loop is recorded beside it);
  megakernel  (the wavefront cells) the timed megakernel film's band of
              16 rows bit for bit against the plain version over the
              cell's samples.

Prints one JSON line per cell, then one line in bench.py's shape: the
head metric (rays_per_sec_cornell1024) with the other cells under
"extra".  The same lines go to --out.  Exits 1 if any check failed.
Without a CUDA device it exits with an error unless --device cpu is given;
then every line says "device": "cpu" and "card": null, and the device
times and memory are null.
"""

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
from typing import NamedTuple

import chip_smoke

REPO = os.path.dirname(os.path.abspath(__file__))

BASE_CORNELL = 5.24288e10 / 112.0   # the reference's rays/s (BASELINE.md)
BASE_SPECULAR = 5.24288e10 / 230.0
REFERENCE_SECONDS = 112.0           # its Cornell 1024^2, 10,000 spp render
REGRESSION_FACTOR = 3.0             # bench.py's flag: headline below 3x it

CELLS = ("cornell1024", "cornell1024_refconfig", "specular1024",
         "sphere9812_beam", "sphere9812_cluster", "garden105708_beam",
         "wavefront512_d5", "wavefront512_d16")
WAVEFRONT_DEPTHS = {"wavefront512_d5": 5, "wavefront512_d16": 16}
GOLDENS = {"sphere9812": "docs/sphere9812_beam_2048spp.png",
           "garden105708": "docs/garden105708_beam_2048spp.png"}
# Beam golden renders: over the sphere's 32 tiles the mean's sd across
# seeds 1-6 was 10% at 256 spp and 2.35% at 2048; at 2^21 tile-samples
# (65,536 spp there) seeds 1-4 read -0.60% to +0.05%.
BEAM_GOLDEN_TILE_SAMPLES = 1 << 21
SLICE_SPP = 4
SLICE_ROWS = 16           # rows of the trace kernel's bands
DEVICE_MS_CALLS = 8       # back-to-back launches per CUDA-event run


def measure(render, rays, repeats, device, reset=lambda: None):
    """bench.py's _measure: one untimed call of ``render``, then ``reset()``
    and ``repeats`` runs, each a host clock around ``render()`` ended by a
    device synchronise.  Returns (the last run's output, the timing: the
    median, min and max rays/s, the spread (max - min) / median, the run
    count and each run's seconds)."""
    from pathtracer_tpu_torch.utils.timer import Timer

    out = render()
    reset()
    seconds = []
    for _ in range(repeats):
        timer = Timer(device)
        out = render()
        seconds.append(timer.seconds())
    rates = sorted(rays / s for s in seconds)
    median = statistics.median(rates)
    return out, {"median": median, "min": rates[0], "max": rates[-1],
                 "spread": (rates[-1] - rates[0]) / median,
                 "runs": len(rates), "seconds": seconds}


def kernel_modules():
    from pathtracer_tpu_torch.ops.cuda import (beam_kernel, cluster_kernel,
                                               trace_kernel)
    return {"trace": trace_kernel, "beam": beam_kernel,
            "cluster": cluster_kernel}


def middle_band(cam):
    """(h0, band_h) of SLICE_ROWS rows through the film's middle."""
    band_h = min(SLICE_ROWS, cam.height)
    return (cam.height - band_h) // 2, band_h


def slice_trace(cam, scene, depth, seed):
    """(bit-identical, max abs) of the trace kernel against its plain
    version on the middle band at SLICE_SPP."""
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

    h0, band_h = middle_band(cam)
    kw = dict(seed=seed, h0=h0, band_h=band_h)
    got = ttk.render_sum_cuda(cam, scene, 0, SLICE_SPP, depth, **kw)
    want = ttk.render_sum_reference(cam, scene, 0, SLICE_SPP, depth, **kw)
    return equal_and_diff(got, want)


def film_band_plain(cam, scene, film, spp, depth, seed):
    """(bit-identical, max abs) of the middle band of a render_film film
    through the trace kernel against the plain version's sums of those
    rows over the same sample windows, over ``spp``."""
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

    h0, band_h = middle_band(cam)
    want = ttk.render_sum_reference(cam, scene, 0, spp, depth, seed=seed,
                                    h0=h0, band_h=band_h) / spp
    return equal_and_diff(film[h0:h0 + band_h], want)


def equal_and_diff(got, want):
    import torch
    return torch.equal(got, want), float((got - want).abs().max())


def golden_res(pt, key):
    """(width, height) of the committed render.  It was made with the
    scene's own camera cut to its resolution, which keeps the camera's
    pixel size: the 256^2 sphere render is the corner [0, 256)^2 of the
    512^2 view."""
    h, w = pt.read_png(os.path.join(REPO, GOLDENS[key])).shape[:2]
    return w, h


def golden_record(pt, film, key, png):
    """The film's pixels of the committed render, written to ``png`` and
    held against it as phase 8 of chip_smoke.py holds its renders: {psnr,
    linear_mean, golden_mean, rel_err}; None when the film does not cover
    those pixels."""
    from pathtracer_tpu_torch.image import Film

    w, h = golden_res(pt, key)
    if film.shape[0] < h or film.shape[1] < w:
        return None
    Film((w, h), data=film[:h, :w]).gamma_correct().save_png(png)
    psnr, mean, want = chip_smoke.golden_compare(pt, png, GOLDENS[key])
    return {"psnr": psnr, "linear_mean": mean, "golden_mean": want,
            "rel_err": mean / want - 1.0}


def golden_spp(cam, backend):
    """Samples of the converged golden render at ``cam``: the committed
    render's, and for the beam kernel at least BEAM_GOLDEN_TILE_SAMPLES
    (tile, sample) pairs: its 2048 pixels a tile share their bounces, so
    its noise falls with the tile-samples, not the pixel-samples."""
    if backend != "beam":
        return chip_smoke.GOLDEN_SPP
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    wp, hp = bk._padded_res(*cam.res)
    tiles = wp * hp // bk.TILE_PX
    return max(chip_smoke.GOLDEN_SPP, BEAM_GOLDEN_TILE_SAMPLES // tiles)


def card_kernel_ms(kernel, cam, scene, spp, depth, seed, rays=None):
    """({the launch shape}, device ms a launch by CUDA events) of the
    cell's kernel at its launch shape on the cell's path: one trace or
    beam launch of the render's samples per launch, or one cluster launch
    of the tile driver's rays per pass (``rays``: camera rays of that
    count)."""
    from pathtracer_tpu_torch.utils.timer import device_ms

    mods = kernel_modules()
    if kernel == "trace":
        spp_call = mods["trace"]._default_spp_per_call(cam, spp)
        fn = lambda: mods["trace"].render_sum_cuda(  # noqa: E731
            cam, scene, 0, spp_call, depth, seed=seed)
        shape = {"res": list(cam.res), "spp": spp_call, "depth": depth}
    elif kernel == "beam":
        spp_call = mods["beam"]._default_spp_per_call(cam, spp, depth)
        fn = lambda: mods["beam"].render_tiles_beam(  # noqa: E731
            cam, scene, 0, spp_call, depth, seed=seed)
        shape = {"res": list(cam.res), "spp": spp_call, "depth": depth}
    else:
        cs = mods["cluster"].clusters_for(scene)
        fn = lambda: mods["cluster"].intersect_clusters(  # noqa: E731
            rays[0], rays[1], cs)
        shape = {"camera_rays": int(rays[0].shape[0])}
    return shape, device_ms(fn, DEVICE_MS_CALLS)[0]


class Cell(NamedTuple):
    scene: str          # "cornell", "specular" or a GOLDENS key
    res: int            # the film's side
    spp: int
    depth: int
    backend: str        # render_film's
    kernel: str         # the kernel the cell's route runs
    runs: int           # timed runs
    metric: str         # bench.py's name
    baseline: float     # the reference's rays/s


class Bench:
    """The cells of one run on ``dev``, from the parsed arguments; their
    PNGs go to ``out_dir``."""

    def __init__(self, pt, args, dev, card, out_dir=None):
        self.pt, self.args, self.dev, self.card = pt, args, dev, card
        self.out_dir = out_dir
        self.on_card = dev.type == "cuda"
        self._scenes = {}

    def scene(self, key, res):
        """(camera at ``res`` (width, height), scene) on the device, each
        scene built once.  The Cornell boxes are made at ``res``, as
        bench.py makes them; the large scenes' own cameras are cut to
        ``res`` keeping their pixel size, as bench.py and bench_bvh.py cut
        them (at their own 512^2, no cut)."""
        pt, dev = self.pt, self.dev
        if key in ("cornell", "specular"):
            if (key, res) not in self._scenes:
                self._scenes[(key, res)] = (
                    pt.cornell_box(res=res, device=dev) if key == "cornell"
                    else pt.modified_cornell(0.05, res=res, device=dev))
            return self._scenes[(key, res)]
        if key not in self._scenes:
            cam, sb = (pt.meshes.sphere_in_box(50, 100, device=dev)
                       if key == "sphere9812"
                       else pt.meshes.mesh_garden(device=dev))
            self._scenes[key] = (cam, sb.build(device=dev))
        cam, scene = self._scenes[key]
        return chip_smoke.with_res(cam, res), scene

    def spec(self, name):
        """The cell's Cell; its metric may hold {tris}."""
        a = self.args
        r, lr, d = a.res, a.large_res, a.depth
        if name in WAVEFRONT_DEPTHS:
            wd = WAVEFRONT_DEPTHS[name]
            return Cell("cornell", lr, a.wavefront_spp, wd, "wavefront",
                        "trace", a.repeats,
                        f"rays_per_sec_wavefront_{lr}_d{wd}", BASE_CORNELL)
        return {
            "cornell1024": Cell("cornell", r, a.spp, d, "auto", "trace",
                                a.repeats, f"rays_per_sec_cornell{r}",
                                BASE_CORNELL),
            "cornell1024_refconfig": Cell(
                "cornell", r, a.refconfig_spp, d, "auto", "trace",
                a.refconfig_repeats,
                f"rays_per_sec_cornell{r}_refconfig_{a.refconfig_spp}spp",
                BASE_CORNELL),
            "specular1024": Cell("specular", r, a.spp, d, "auto", "trace",
                                 a.repeats, f"rays_per_sec_specular{r}",
                                 BASE_SPECULAR),
            "sphere9812_beam": Cell("sphere9812", lr, a.large_spp, d,
                                    "beam", "beam", a.repeats,
                                    "rays_per_sec_bvh_{tris}tris_" + str(lr),
                                    BASE_CORNELL),
            "sphere9812_cluster": Cell("sphere9812", lr, a.large_spp, d,
                                       "cluster", "cluster", a.repeats,
                                       f"rays_per_sec_bvh_cluster_{lr}",
                                       BASE_CORNELL),
            "garden105708_beam": Cell("garden105708", lr, a.garden_spp, d,
                                      "beam", "beam", a.repeats,
                                      "rays_per_sec_garden_{tris}tris_"
                                      + str(lr), BASE_CORNELL),
        }[name]

    def timed(self, cam, scene, spp, depth, backend, runs):
        """(film, timing, {kernel: launches a run}, peak bytes or None) of
        render_film: the launch counters and the peak memory are reset
        after the untimed call."""
        import torch
        mods = kernel_modules()

        def reset():
            for mod in mods.values():
                mod.LAUNCHES = 0
            if self.on_card:
                torch.cuda.reset_peak_memory_stats()

        film, timing = measure(
            lambda: self.pt.render_film(cam, scene, spp, depth,
                                        seed=self.args.seed,
                                        backend=backend).data,
            cam.width * cam.height * spp * depth, runs, self.dev, reset)
        launches = {k: mod.LAUNCHES / runs for k, mod in mods.items()}
        peak = torch.cuda.max_memory_allocated() if self.on_card else None
        return film, timing, launches, peak

    def run(self, name):
        """The cell's JSON record."""
        import numpy as np
        import torch
        from pathtracer_tpu_torch.image import Film
        from pathtracer_tpu_torch.render import _plan

        key, res, spp, depth, backend, kernel, runs, metric, base = \
            self.spec(name)
        cam, scene = self.scene(key, (res, res))
        seed = self.args.seed
        film, timing, launches, peak = self.timed(cam, scene, spp, depth,
                                                  backend, runs)
        rps = timing["median"]
        rec = {"cell": name, "metric": metric.format(tris=scene.num_tris),
               "value": rps, "unit": "rays/s", "vs_baseline": rps / base,
               "timing": timing, "res": list(cam.res), "spp": spp,
               "depth": depth, "backend": backend, "tris": scene.num_tris,
               "kernel": kernel, "launches": launches, "peak_bytes": peak}
        if name == "cornell1024_refconfig":
            rec.update(seconds=statistics.median(timing["seconds"]),
                       reference_seconds=REFERENCE_SECONDS)
        checks, notes, held = {}, [], {}

        def hold(check, fn):
            # chip_smoke's helpers print what they hold and raise where
            # their own checks fail.
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    checks[check] = bool(fn())
            except chip_smoke.CheckFailed as e:
                checks[check] = False
                notes.append(f"{check}: {e}")
            if buf.getvalue():
                held[check] = buf.getvalue().splitlines()

        checks["finite"] = (bool(torch.isfinite(film).all())
                            and bool(film.abs().max() > 0))
        if backend == "wavefront":
            mega, rec["megakernel_timing"], rec["megakernel_launches"], _ = \
                self.timed(cam, scene, spp, depth, "cuda", runs)
            rec["megakernel_same_config"] = rec["megakernel_timing"][
                "median"]
            # The film bar is held against the kernel's "mt" instance, whose
            # intersection arithmetic the brute wavefront shares.  Against
            # the default loop, the near-tie hits that the bar lets flip in
            # 1% of a 4-spp film's pixels add up over the samples.
            mt = kernel_modules()["trace"].render_film_cuda(
                cam, scene, spp, depth, seed=seed, loop="mt").data

            def close():
                rec["flip_share_default_loop"] = chip_smoke.film_diff(
                    film, mega)[1]
                rec["max_abs_mt"], rec["flip_share_mt"] = \
                    chip_smoke.film_diff(film, mt)
                return rec["flip_share_mt"] <= chip_smoke.MAX_FLIP_SHARE
            hold("wavefront", close)
            checks["megakernel"], rec["megakernel_band_max_abs"] = \
                film_band_plain(cam, scene, mega, spp, depth, seed)
        if self.on_card:
            # The wavefront cells' trace kernel runs on the megakernel side.
            ran = rec.get("megakernel_launches", launches)
            checks["launched"] = ran[kernel] > 0

        rays = None
        if kernel == "cluster":
            tile_h, spp_b, _ = _plan(cam.width, cam.height, spp,
                                     scene.padded_size, "cluster")
            # On the card, the tile driver's rays a launch (for the timing
            # below); the first HELD_CLUSTER_RAYS of them are held.
            n = tile_h * cam.width * spp_b if self.on_card else 0
            rays = chip_smoke.camera_rays(
                cam, max(n, chip_smoke.HELD_CLUSTER_RAYS),
                np.random.default_rng(seed))

            def sliced():
                rec["slice_max_abs"] = chip_smoke.hold_clusters(
                    name, *rays, kernel_modules()["cluster"].clusters_for(
                        scene), chip_smoke.HELD_CLUSTER_RAYS)[0]
                return True
        elif kernel == "beam":
            def sliced():
                rec["slice_max_abs"] = chip_smoke.hold_main_path_bands(
                    self.pt, cam, scene, spp, depth, seed)[1]
                return True
        else:
            def sliced():
                ok, rec["slice_max_abs"] = slice_trace(cam, scene, depth,
                                                       seed)
                return ok
        hold("slice", sliced)
        if key in ("cornell", "specular") and backend != "wavefront":
            u8 = Film(cam.res, data=film).gamma_correct().to_u8()

            def light():
                rec["brightest"] = chip_smoke.brightest_sees_light(
                    self.pt, cam, scene, u8, ties=key == "specular")
                return True
            hold("light", light)
        if key in GOLDENS:
            rec["fingerprint_ms"] = fingerprint_ms(scene)
            if depth == chip_smoke.DEPTH:
                self.hold_golden(rec, hold, film, cam, scene, key, backend)
            else:
                notes.append(f"golden: not held at depth {depth}; the "
                             f"committed render is at depth "
                             f"{chip_smoke.DEPTH}")
        rec["kernel_launch"], rec["kernel_ms"] = (
            card_kernel_ms(kernel, cam, scene, spp, depth, seed, rays)
            if self.on_card else (None, None))
        rec.update(device=self.dev.type, card=self.card,
                   correct=all(checks.values()), checks=checks)
        if held:
            rec["held"] = held
        if notes:
            rec["notes"] = notes
        return rec

    def hold_golden(self, rec, hold, film, cam, scene, key, backend):
        """The golden checks of a large cell: its own film, then the cell's
        route at converged samples on the committed render's pixels
        (rendered outside the timed runs)."""
        name, rtol = rec["cell"], chip_smoke.GOLDEN_MEAN_RTOL
        out = self.out_dir or "."

        def own():
            rec["golden"] = golden_record(
                self.pt, film, key, os.path.join(out, f"bench_torch_{name}.png"))
            chip_smoke.check(rec["golden"] is not None,
                             f"a {cam.res} film does not cover the "
                             f"committed render's pixels")
            return abs(rec["golden"]["rel_err"]) <= rtol
        hold("golden", own)

        def converged():
            gcam = self.scene(key, golden_res(self.pt, key))[0]
            gspp = golden_spp(gcam, backend)
            gfilm = self.pt.render_film(gcam, scene, gspp, chip_smoke.DEPTH,
                                        seed=self.args.seed,
                                        backend=backend).data
            rec["golden_converged"] = dict(spp=gspp, **golden_record(
                self.pt, gfilm, key,
                os.path.join(out, f"bench_torch_{name}_{gspp}spp.png")))
            return abs(rec["golden_converged"]["rel_err"]) <= rtol
        hold("golden_converged", converged)


def fingerprint_ms(scene):
    """Host ms of one Scene.fingerprint(), the median of three."""
    import time
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        scene.fingerprint()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", help="comma-separated subset of "
                    + ", ".join(CELLS) + " (default: all, in that order)")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed runs a cell (BENCH_REPEATS)")
    ap.add_argument("--depth", type=int, default=5,
                    help="depth of every cell but the wavefront's "
                         "(BENCH_DEPTH)")
    ap.add_argument("--spp", type=int, default=4096,
                    help="cornell1024 and specular1024 (BENCH_SPP)")
    ap.add_argument("--refconfig-repeats", type=int, default=3,
                    help="timed runs of the refconfig "
                         "(BENCH_REFCONFIG_REPEATS)")
    ap.add_argument("--refconfig-spp", type=int, default=10000,
                    help="the refconfig's samples (the reference's own)")
    ap.add_argument("--large-spp", type=int, default=256,
                    help="the sphere9812 cells (BENCH_BVH_SPP)")
    ap.add_argument("--garden-spp", type=int, default=64,
                    help="garden105708_beam (BENCH_GARDEN_SPP)")
    ap.add_argument("--res", type=int, default=1024,
                    help="side of the 1024^2 Cornell cells")
    ap.add_argument("--large-res", type=int, default=512,
                    help="side of the 512^2 cells: the large scenes and "
                         "the wavefront")
    ap.add_argument("--wavefront-spp", type=int, default=64,
                    help="the wavefront cells (bench.py's 64)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the kernels' plain versions; there is "
                         "no fallback from cuda")
    ap.add_argument("--seed", type=int, default=1,
                    help="the renders' seed (the package's default) and "
                         "the cluster check's rays")
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "bench_torch.json"),
                    help="file for the JSON lines")
    args = ap.parse_args(argv)
    if args.cells is None:
        args.cells = CELLS
    else:
        picked = args.cells.split(",")
        if not set(picked) <= set(CELLS):
            ap.error(f"--cells takes names of {', '.join(CELLS)}")
        args.cells = tuple(c for c in CELLS if c in picked)
    return args


def main(argv=None):
    """Run the cells; returns the exit code (1 if any check failed)."""
    args = parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("bench_torch: torch.cuda.is_available() is false; this "
                 "benchmark measures a GPU (--device cpu runs the plain "
                 "versions at test sizes)")
    sys.path.insert(0, REPO)
    import pathtracer_tpu_torch as pt

    card = None
    if args.device == "cuda":
        from bench_torch_invert import card_name
        card = card_name()
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    bench = Bench(pt, args, torch.device(args.device), card, out_dir)
    results, notes = [], []
    with open(args.out, "w") as out:
        for name in args.cells:
            rec = bench.run(name)
            results.append(rec)
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
        head = dict(results[0])
        if (head["cell"] == "cornell1024"
                and head["vs_baseline"] < REGRESSION_FACTOR):
            notes.append(f"cornell headline {head['value']:.4e} rays/s is "
                         f"below {REGRESSION_FACTOR}x the reference "
                         f"(spread {head['timing']['spread']:.1%})")
        head.update(extra=results[1:], regression=bool(notes),
                    all_correct=all(r["correct"] for r in results))
        if notes:
            head["regression_notes"] = notes
        print(json.dumps(head), flush=True)
        out.write(json.dumps(head) + "\n")
    return 0 if head["all_correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
