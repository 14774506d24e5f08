#!/usr/bin/env python3
"""Measurements of the port's trace megakernel (csrc/trace_kernel.cu).

    python3 bench_torch_trace.py predict [--device cpu]
    python3 bench_torch_trace.py ab PARENT_CSRC_DIR
    python3 bench_torch_trace.py loopcost

``predict`` works out, from the plain version's path lengths, what path
regeneration can save at 1024^2, 16 spp, depth 5 on cornell_box and
modified_cornell(0.05): the lane utilisation of the triangle loop when
each warp of 32 neighbouring pixels pays the longest path of its lanes for
every sample (one sample loop around one bounce loop), and when it pays
the longest per-lane total over the launch's samples (regeneration).  It
samples every ROW_STEP-th row of the film; any device will do.

``ab`` times, in one process on one card, the trace kernel of an older
checkout (PARENT_CSRC_DIR/trace_kernel.cu, built into build/ with the same
nvcc flags; its ``"mt"`` rows are (T, 9)) against this checkout's kernel,
both loops, at 1024^2, 16 spp, depth 5 on both scenes, in the order parent,
mt, plucker, plucker, mt, parent; checks that the parent's film and this
kernel's "mt" film are bit-identical; and prints one JSON line.

``loopcost`` times both loops on each scene with its triangles repeated
(1 to 15 copies, the same film): between one and two copies the time per
launch grows by what the added rows cost, and the line through those two
points meets zero rows at what the kernel spends outside its triangle
loop.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import pathtracer_tpu_torch as pt  # noqa: E402
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk  # noqa: E402
from pathtracer_tpu_torch.rng import MASK, SEED, SEED_MIX  # noqa: E402
from pathtracer_tpu_torch.utils import build  # noqa: E402
from pathtracer_tpu_torch.utils.timer import device_ms  # noqa: E402

RES = 1024
SPP = 16
DEPTH = 5
ROW_STEP = 32
WARP = 32
KERNEL_CALLS = 16

SCENES = {"cornell1024": lambda dev: pt.cornell_box(res=(RES, RES),
                                                     device=dev),
          "specular1024": lambda dev: pt.modified_cornell(
              0.05, res=(RES, RES), device=dev)}


def warp_utilisation(lengths: torch.Tensor) -> dict:
    """Lane utilisation of (samples, rows, width) path lengths, warps of
    WARP neighbouring pixels of a row: without and with regeneration."""
    s, r, w = lengths.shape
    lanes = lengths.to(torch.float64).reshape(s, r, w // WARP, WARP)
    useful = float(lanes.sum())
    per_sample = float(lanes.amax(dim=-1).sum()) * WARP
    per_launch = float(lanes.sum(dim=0).amax(dim=-1).sum()) * WARP
    return {"paths": s * r * w, "mean_length": useful / (s * r * w),
            "live_share": useful / (s * r * w * DEPTH),
            "utilisation_per_sample": useful / per_sample,
            "utilisation_regeneration": useful / per_launch,
            "predicted_loop_speedup": per_sample / per_launch}


def predict(device: str) -> dict:
    out = {}
    for name, make in SCENES.items():
        cam, scene = make(device)
        rows = [ttk.path_lengths(cam, scene, 0, SPP, DEPTH, h0=h, band_h=1,
                                 loop="mt")
                for h in range(0, RES, ROW_STEP)]
        out[name] = warp_utilisation(torch.cat(rows, dim=1).cpu())
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    return out


def parent_library(src_dir: str) -> ctypes.CDLL:
    """The parent checkout's trace_kernel.cu, built with this checkout's
    flags into build/parent_trace/."""
    out_dir = os.path.join(REPO, "build", "parent_trace")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libparent_trace.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib,
           os.path.join(src_dir, "trace_kernel.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"parent build failed: {proc.stdout}"
                           f"{proc.stderr}")
    print("parent build:", " ".join(
        line.strip() for line in (proc.stdout + proc.stderr).splitlines()
        if "registers" in line or "spill" in line), flush=True)
    so = ctypes.CDLL(lib)
    so.pt_trace_render.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                   + [ctypes.c_uint32, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_uint32,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p])
    so.pt_trace_render.restype = ctypes.c_int
    return so


def parent_render(so, cam, scene) -> torch.Tensor:
    """One 16-spp launch of the parent kernel over the whole film."""
    dev = scene.device
    tri = ttk._triangle_params(scene)
    tab = ttk._packed_table(scene)
    cp = ttk._camera_params(cam)
    film = torch.zeros((cam.height, cam.width, 3), device=dev)
    err = so.pt_trace_render(
        tri.data_ptr(), tab.data_ptr(), cp.data_ptr(), film.data_ptr(),
        scene.num_tris, cam.width, cam.height, cam.height, 0, 0, SPP, DEPTH,
        (SEED * SEED_MIX) & MASK, int(scene.has_specular), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"parent kernel launch failed: cudaError {err}")
    return film


def ab(src_dir: str) -> dict:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    so = parent_library(src_dir)
    out = {"card": card}
    for name, make in SCENES.items():
        cam, scene = make("cuda")
        films = {}
        fns = {"parent": lambda: films.__setitem__(
                   "parent", parent_render(so, cam, scene)),
               "mt": lambda: films.__setitem__("mt", ttk.render_sum_cuda(
                   cam, scene, 0, SPP, DEPTH, loop="mt")),
               "plucker": lambda: films.__setitem__(
                   "plucker", ttk.render_sum_cuda(cam, scene, 0, SPP, DEPTH,
                                                  loop="plucker"))}
        runs = {k: [] for k in fns}
        for key in ("parent", "mt", "plucker", "plucker", "mt", "parent"):
            runs[key].append(device_ms(fns[key], calls=KERNEL_CALLS)[0])
        torch.cuda.synchronize()
        same = bool(torch.equal(films["parent"], films["mt"]))
        if not same:
            raise RuntimeError(f"{name}: the parent's film and the 'mt' "
                               f"film differ")
        out[name] = {"ms": runs, "parent_equals_mt": same}
        print(f"{card}: {name} ms per 16-spp launch, parent/mt/plucker, "
              f"each run in the order p, mt, pl, pl, mt, p: "
              f"{json.dumps(runs)}; parent film == mt film: {same}",
              flush=True)
    return out


def repeated(scene, copies: int):
    """The scene with its triangles repeated ``copies`` times in row
    order: the first copy wins every tie (strict t < best_t), so the film
    is the scene's own while every segment tests copies x T rows."""
    hv, hm = scene.host_verts(), scene.host_materials()
    arrays = [np.concatenate([a] * copies) for a in (*hv, *hm)]
    n = scene.num_tris * copies
    pad = -(-n // 8) * 8 - n
    arrays = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
              for a in arrays]
    return pt.scene_from_arrays(*arrays, n, device=scene.device)


def loopcost() -> dict:
    """Time per 16-spp launch against the triangle count, from the scenes
    repeated 1, 2, 4, 8 and 15 times (the same film): the slope between one
    and two copies is the triangle loop's cost per row, the intercept the
    time outside it; the larger counts show the shared-memory cliff."""
    out = {}
    for name, make in SCENES.items():
        cam, scene = make("cuda")
        live = ttk.count_live_segments(cam, scene, 0, SPP, DEPTH, loop="mt")
        out[name] = {"live_segments": live}
        for loop in ttk.LOOPS:
            ref, pts = None, []
            for copies in (1, 2, 4, 8, 15):
                big = repeated(scene, copies)
                film = {}
                ms = device_ms(lambda: film.__setitem__(
                    "f", ttk.render_sum_cuda(cam, big, 0, SPP, DEPTH,
                                             loop=loop)),
                    calls=KERNEL_CALLS)[0]
                torch.cuda.synchronize()
                ref = film["f"] if ref is None else ref
                if not torch.equal(ref, film["f"]):
                    raise RuntimeError(f"{name} {loop} x{copies}: the film "
                                       f"changed")
                pts.append((big.num_tris, ms))
            # One and two copies only: from three on, the rows' shared
            # memory cuts the blocks an SM holds, and the slope with them.
            (t1, y1), (t2, y2) = pts[:2]
            slope = (y2 - y1) / (t2 - t1)
            intercept = y1 - slope * t1
            out[name][loop] = {
                "points": pts, "ms_per_row": slope, "intercept_ms": intercept,
                "ps_per_test": slope * 1e9 / live}
            print(f"{name} {loop}: (rows, ms) {pts}; {slope:.5f} ms a row "
                  f"({slope * 1e9 / live:.4f} ps a test), "
                  f"{intercept:.4f} ms outside the loop", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("predict")
    p.add_argument("--device", default="cuda")
    a = sub.add_parser("ab")
    a.add_argument("parent_csrc")
    sub.add_parser("loopcost")
    args = ap.parse_args()
    if args.cmd == "predict":
        result = predict(args.device)
    elif args.cmd == "loopcost":
        result = loopcost()
    else:
        if not torch.cuda.is_available():
            raise SystemExit("ab needs a CUDA device")
        result = ab(args.parent_csrc)
    print(json.dumps({args.cmd: result}), flush=True)


if __name__ == "__main__":
    main()
