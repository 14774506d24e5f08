#!/usr/bin/env python3
"""Smoke run of pathtracer_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and the exit code is
not 0:
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit;
  2. build: compiles csrc/*.cu with nvcc for sm_90a and prints the time;
  3. the megakernel against its plain PyTorch version on the card (corner,
     Cornell and specular scenes, 64^2, 4 spp, depth 5), a band launch
     against the same rows of a full launch (bit for bit), a window split
     over two calls against one call (atol 1e-6), and the emission check;
  4. the main path: pathtracer_tpu_torch.render on the 1024^2 Cornell box
     through backend="auto", which must launch the kernel; the film must be
     finite, lit, brightest on the light panel, and equal to the brute
     backend's film on the card at 4 spp;
  5. timing at 1024^2, 16 spp, depth 5: median over 3 runs of the device
     time per call of the kernel and of the plain version, CUDA events;
then one JSON line on the kernels and, last, the device line.  The render
and a JSON record of the run go to build/chip_smoke/ (git-ignored).
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")

# Film bar, as in the CPU tests (tests/_torch_parity.py): the JAX package's
# own bar for its kernel against its oracle is atol 2e-4, and at most 1% of
# the pixels may differ by more (a one-ulp difference can flip a near-tie
# hit and move that path's radiance by O(1 / spp)).
FILM_ATOL = 2e-4
MAX_FLIP_SHARE = 0.01
WINDOW_ATOL = 1e-6       # float sums of two windows against one
MAIN_RES = (1024, 1024)
MAIN_SPP = 256
DEPTH = 5
CHECK_SPP = 4            # main-path film against the brute backend
TIME_SPP = 16            # one launch of 2^24 ray segments at 1024^2
TIME_RUNS = 3
KERNEL_CALLS = 16        # back-to-back kernel calls per timed run


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def film_diff(got, want):
    """(max abs difference, share of pixels beyond FILM_ATOL)."""
    import torch
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "non-finite film")
    return (float(diff.max()),
            float((diff.amax(dim=-1) > FILM_ATOL).float().mean()))


def timed_ms(fn, calls, runs=TIME_RUNS):
    """Median device time in ms per call of ``fn``, after one warm-up call.
    Each run is ``calls`` back-to-back calls between two CUDA events, so
    the host's preparation of a call overlaps the device work of the one
    before, as in a render; a single call would also count the idle device
    while the host prepares it."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), times


def main():
    import torch

    print("== 1 device", flush=True)
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    sys.path.insert(0, REPO)
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.camera import get_rays
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
    from pathtracer_tpu_torch.ops.intersect import intersect_brute
    from pathtracer_tpu_torch.utils import build

    record = {"card": card}

    print("== 2 build", flush=True)
    built = build.build_library()
    build.load_library()
    print(f"built {os.path.relpath(built.path, REPO)} in "
          f"{built.seconds:.2f} s", flush=True)
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip(), flush=True)
    record["build_s"] = built.seconds

    print("== 3 kernel against its plain version (64^2, 4 spp, depth 5)",
          flush=True)
    record["parity"] = {}
    scenes = {"corner": lambda: pt.corner_scene(res=(64, 64)),
              "cornell": lambda: pt.cornell_box(res=(64, 64)),
              "specular": lambda: pt.modified_cornell(0.3, res=(64, 64))}
    for name, make in scenes.items():
        cam, scene = make()
        cam, scene = cam.to(dev), scene.to(dev)
        got = ttk.render_sum_cuda(cam, scene, 0, 4, DEPTH) / 4
        want = ttk.render_sum_reference(cam, scene, 0, 4, DEPTH) / 4
        torch.cuda.synchronize()
        max_abs, share = film_diff(got, want)
        equal = float((got == want).float().mean())
        print(f"{name}: max abs diff {max_abs:.3e}, pixels beyond "
              f"{FILM_ATOL}: {share:.4%}, bit-equal values {equal:.4%}, "
              f"mean {float(got.mean()):.5f}", flush=True)
        check(float(got.mean()) > 0.0, f"{name}: black film")
        check(share <= MAX_FLIP_SHARE,
              f"{name}: {share:.4%} of pixels beyond {FILM_ATOL}")
        record["parity"][name] = {"max_abs": max_abs, "share": share,
                                  "bit_equal": equal}

    cam, scene = pt.modified_cornell(0.3, res=(64, 48))
    cam, scene = cam.to(dev), scene.to(dev)
    full = ttk.render_sum_cuda(cam, scene, 0, 4, DEPTH)
    band = ttk.render_sum_cuda(cam, scene, 0, 4, DEPTH, h0=17, band_h=13)
    split = (ttk.render_sum_cuda(cam, scene, 0, 1, DEPTH)
             + ttk.render_sum_cuda(cam, scene, 1, 3, DEPTH))
    torch.cuda.synchronize()
    check(torch.equal(band, full[17:30]),
          "band launch differs from the same rows of the full launch")
    window = float((split - full).abs().max())
    check(window <= WINDOW_ATOL, f"two windows differ from one by {window}")
    print(f"band rows [17, 30) bit-identical; window split max diff "
          f"{window:.3e}", flush=True)
    sb = pt.SceneBuilder()
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                    pt.HostMaterial(pt.DIFFUSE, color=(1, 1, 1),
                                    emit=(1, 0, 0)))
    try:
        ttk.render_sum_cuda(cam, sb.build().to(dev), 0, 1, 1)
    except ValueError as e:
        print(f"emission check raised: {e}", flush=True)
    else:
        raise RuntimeError("chip_smoke: emissive non-EMIT scene accepted")

    print(f"== 4 main path: render(cornell_box {MAIN_RES[0]}x{MAIN_RES[1]}, "
          f"{MAIN_SPP} spp, depth {DEPTH}, backend='auto')", flush=True)
    cam, scene = pt.cornell_box(res=MAIN_RES)
    cam, scene = cam.to(dev), scene.to(dev)
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, "chip_smoke_cornell1024.png")
    ttk.LAUNCHES = 0
    t0 = time.perf_counter()
    film = pt.render(cam, scene, samples=MAIN_SPP, depth=DEPTH, filename=png)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = ttk.LAUNCHES
    check(launches > 0, "the main path launched no kernel")
    img = film.data
    check(tuple(img.shape) == (MAIN_RES[1], MAIN_RES[0], 3),
          f"film shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "non-finite film")
    mean = float(img.mean())
    check(mean > 0.01, f"film is black (gamma-space mean {mean})")
    # A pixel whose every sample hits the light (emission 1) averages
    # exactly 1.0; lit walls stay far below that.  The first brightest pixel
    # must see an EMIT triangle through its centre.
    lum = img.mean(dim=-1)
    bh, bw = divmod(int(torch.argmax(lum)), MAIN_RES[0])
    check(float(lum[bh, bw]) >= 0.99,
          f"brightest pixel is {float(lum[bh, bw])}, not the light's 1.0")
    half = torch.full((1,), 0.5, device=dev)
    ray_o, ray_d = get_rays(cam, torch.tensor([bw], device=dev),
                            torch.tensor([bh], device=dev), half, half)
    _, tid = intersect_brute(ray_o, ray_d, scene.v1, scene.v2, scene.v3)
    tid = int(tid[0])
    check(tid >= 0 and int(scene.mat_type[tid]) == pt.EMIT,
          f"brightest pixel ({bw}, {bh}) sees triangle {tid}, not the light")
    print(f"{launches} launches, {main_s:.3f} s wall for the render call, "
          f"gamma-space mean {mean:.4f}, brightest pixel "
          f"({bw}, {bh}) sees the light (triangle {tid})", flush=True)
    kern = pt.render_film(cam, scene, CHECK_SPP, DEPTH, backend="cuda").data
    brute = pt.render_film(cam, scene, CHECK_SPP, DEPTH, backend="brute").data
    torch.cuda.synchronize()
    main_err, main_share = film_diff(kern, brute)
    print(f"against backend='brute' at {CHECK_SPP} spp: max abs diff "
          f"{main_err:.3e}, pixels beyond {FILM_ATOL}: {main_share:.4%}",
          flush=True)
    check(main_share <= MAX_FLIP_SHARE,
          f"main path: {main_share:.4%} of pixels beyond {FILM_ATOL}")
    record["main"] = {"launches": launches, "seconds": main_s,
                      "gamma_mean": mean, "brightest": [bw, bh],
                      "brute_max_abs": main_err, "brute_share": main_share}

    print(f"== 5 timing at {MAIN_RES[0]}x{MAIN_RES[1]}, {TIME_SPP} spp, "
          f"depth {DEPTH}", flush=True)
    segments = MAIN_RES[0] * MAIN_RES[1] * TIME_SPP * DEPTH
    out = {}

    def kernel():
        out["k"] = ttk.render_sum_cuda(cam, scene, 0, TIME_SPP, DEPTH)

    def plain():
        out["p"] = ttk.render_sum_reference(cam, scene, 0, TIME_SPP, DEPTH)

    plain_ms, plain_all = timed_ms(plain, calls=1)       # ~1 s per call
    ms, kernel_all = timed_ms(kernel, calls=KERNEL_CALLS)
    max_abs, share = film_diff(out["k"] / TIME_SPP, out["p"] / TIME_SPP)
    check(share <= MAX_FLIP_SHARE,
          f"timing shape: {share:.4%} of pixels beyond {FILM_ATOL}")
    print(f"{card}: kernel {ms:.3f} ms (runs {kernel_all}), "
          f"{segments / ms * 1e3:.4e} ray segments/s; plain version "
          f"{plain_ms:.3f} ms (runs {plain_all}), "
          f"{segments / plain_ms * 1e3:.4e} ray segments/s; "
          f"max abs diff {max_abs:.3e}", flush=True)
    record["timing"] = {"spp": TIME_SPP, "kernel_ms": ms,
                        "kernel_runs_ms": kernel_all, "plain_ms": plain_ms,
                        "plain_runs_ms": plain_all, "max_abs": max_abs,
                        "share": share, "segments": segments}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)

    print(json.dumps({"kernels": [{
        "name": "trace_kernel",
        "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/trace_kernel.cu",
        "replaces": "pathtracer_tpu/ops/pallas/trace_kernel.py:96",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
