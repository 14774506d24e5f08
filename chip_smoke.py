#!/usr/bin/env python3
"""Smoke run of pathtracer_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--parent-csrc DIR] [--phases 11,15]

Phases, each printed as it runs; any failure raises and the exit code is
not 0:
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit;
  2. build: compiles csrc/*.cu with nvcc for sm_90a, and at the same time
     the bounds-checked library from the same sources (-DPTK_CHECKED, for
     phase 15) and, with --parent-csrc, an older checkout's beam_kernel.cu
     and cluster_kernel.cu; prints the times and, read from the built
     library with cuobjdump, the registers, stack and local-memory stores
     of every kernel instance, and, from cuobjdump's SASS, the
     instructions of each trace-kernel instance's triangle loop per test
     and of each beam and cluster instance's tree-walk loop per node;
  3. the megakernel against its plain PyTorch version on the card, both
     loops ("mt" and "plucker"): bit-identical (max abs 0) on the corner,
     Cornell and specular scenes at 64^2, 4 spp, depth 5; per loop a band
     launch against the same rows of a full launch (bit for bit) and a
     window split over two calls against one call (atol 1e-6); the
     emission check;
  4. the main path: pathtracer_tpu_torch.render on the 1024^2 Cornell box
     through backend="auto", which must launch the kernel's default loop;
     the film must be finite, lit, brightest on the light panel, and equal
     to the brute backend's film on the card at 4 spp;
  5. the trace kernel at 1024^2, 16 spp, depth 5 on cornell_box and
     modified_cornell(0.05), both loops: median over 3 runs of the device
     time per call of the kernel and of its plain version (CUDA events),
     bit-identical films, the live ray segments, the bound and the share of
     it reached, the issue-slot figure; then one render() each of the 10k
     spp reference configurations (bars 112 s and 230 s);
  6. the cluster kernel against its plain version on sphere_in_box(50, 100)
     (9,812 triangles): 65,536 camera rays of the 512^2 film and 65,536
     random rays, t and tid bit-identical, with and without the ray sort;
     a triangle duplicated into two clusters, where the kernel must return
     the lower packed row as the plain argmin does; backend="cluster"
     against backend="bvh" at 64^2;
  7. the beam kernel against its plain version, bit for bit, on the lit
     sphere scene, the Cornell box, the specular Cornell box and two
     70-material (inline) scenes, one with specular quads (all four kernel
     instances), at 64^2 and 200x72, depth 1 and 5, and on the duplicated
     triangle; a band of tiles against the same tiles of a full launch
     (bit for bit), a window split over two calls (atol 1e-6), and the
     emission check;
  8. the large-scene main path: render() through backend="auto" on
     sphere_in_box(50, 100) and mesh_garden() (105,708 triangles) at 512^2,
     which must launch the beam kernel; both films against the JAX
     package's converged renders in docs/; for each, the kernel at the main
     path's launch shape against its plain version on two bands of tiles,
     bit for bit; one backend="cluster" render;
  9. timing: the beam kernel at the main path's launch shape (the 512^2
     padded film, 25 spp, depth 5: one launch) on both scenes, with its
     bound from the boxes and rows these rays need (count_work at 512^2
     over 2 spp on the sphere and 1 on the garden, scaled to the launch's
     samples), and its plain version at 128^2, 4 spp; the cluster kernel
     per 2^20 camera rays of both scenes (a slice held against the plain
     version) with its bound; the ray segments/s of the beam and cluster
     renders at 512^2, depth 5, and the cluster render without the ray
     sort (the default) and with it, off/on/on/off.  With --parent-csrc
     DIR, the older kernels (DIR/beam_kernel.cu, DIR/cluster_kernel.cu,
     built beside this checkout's, driven by copies of their wrappers) are
     timed beside these in the order older, new, new, older: the beam
     launch, the cluster call and both renders of each scene.  The
     default backend="cluster" render is timed after a first call, which
     builds the cluster set (clusters_for caches it) and is printed apart;
 10. differentiable rendering and material recovery: (a) recover_materials
     on the 128^2 Cornell box, 384 spp (192 + 192 paired), depth 5,
     backend="brute", albedo and emission, 5 steps: finite losses, median
     seconds a step and peak device memory, the brute path launching no
     kernel; 3 more steps with the index_select gather in place of the
     one-hot matmul, and one gradient computed twice with each form (bit
     for bit or not); (b) on sphere_in_box(50, 100) at 64^2, 8 spp, depth
     4, backend="cluster": a film and a make_loss value and gradient
     through the kernel against the same with the plain intersection
     (films bit-identical, gradients within relative L2 1e-4), one kernel
     launch a bounce, 2 x depth a paired recovery step; (c) on
     mesh_garden() (105,708 triangles) at 64^2, 8 spp, depth 4: 3 recovery
     steps through the kernel (launches counted from 0) and a one-sided
     gradcheck of two albedo coordinates at 2 spp, depth 3 (bar 0.05);
     (d) tests/test_inverse.py's recovery on the card: 32^2, 250 steps, 64
     spp, depth 4, the target rendered by backend="cuda", visible-diffuse
     albedo and emission errors under 0.15;
 11. sharded renders and training: two ranks spawned with
     torch.multiprocessing, joined by parallel.distributed.initialize
     through a file rendezvous, both on the one card (gloo: NCCL refuses
     two ranks on one GPU).  render_film_sharded_cuda on the 1024^2
     Cornell box at 256 spp, depth 5, and render_film_sharded_beam on
     mesh_garden() at 512^2 (25 spp; 24 for the sample split, which needs
     an even count): the tile split (2, 1) bit-identical to one process's
     render_film, the sample split (1, 2) bit-identical to one process's
     sum of the same two windows and within a relative 1e-5 of its film;
     every rank's launches counted from 0 and non-zero; 3 steps of
     make_sharded_train_step on the 128^2 Cornell box at 384 spp, depth
     5, with the parameters bit-identical on both ranks after each step;
     the wall times beside one process's (two ranks on one card cannot
     show a speed-up), the seconds a step and the peak memory per rank;
 12. the realtime session (Cornell and garden at 256^2, 15 spp a frame,
     4 frames): backends "cuda" and "beam", the accumulated film equal to
     the running mean of the same frames rendered by render_film, 'w'
     resetting to frame 0, ms a frame; the CLI: render cornell at 256^2,
     64 spp, backend cuda, whose PNG's brightest pixel must see the
     light, and bench at 1024^2, 512 spp, whose JSON line is echoed;
 13. the wavefront pipeline (ops/wavefront.py): (a) cornell_box and
     modified_cornell(0.05) at 64^2, 4 spp, depth 5, brute: against
     render_film's brute backend within atol 1e-5, against the megakernel
     within the film bar, two runs and compact_every=1 against 0 bit for
     bit; (b) sphere_in_box(50, 100) at 128^2, 4 spp, depth 5, backend
     "auto", which must take the cluster kernel: its launches, counted
     from 0, equal the live bounces (printed on the "wavefront main path"
     line), the film bit-identical to the plain intersector's and within
     the film bar of render_film's cluster backend; (c) the median wall of
     3 runs (after an untimed one, which records the share of rays alive
     after each bounce of block 0), ray segments/s, launches, any-alive
     syncs and peak memory of Cornell 512^2, 64 spp at depth 5 and 16:
     the wavefront (auto, cluster, cluster with compaction) against the
     megakernel; sphere_in_box(50, 100) at 512^2, 16 spp: the cluster
     wavefront against render_film's beam and cluster backends;
 14. the benchmark: bench_torch.py over every cell with one timed run
     each (--repeats 1 --refconfig-repeats 1), in a process of its own,
     its JSON lines read from build/chip_smoke/bench_torch.json; every
     check of every cell must hold, but a beam cell's golden bar on its
     own film, which is reported while its converged render holds the
     bar (bench_verdict);
 15. the randomized sweep (tests/test_fuzz.py's scenes, fuzz_scene, at
     launch shapes the main paths never send: fuzz_trace_cases,
     fuzz_cluster_cases, fuzz_beam_cases): every launch of each kernel bit
     for bit against its plain version, every buffer of its wrapper and
     every accel input between NaN guard margins that must come back
     untouched, a second launch bit for bit against the first; in a child
     process with CUDA_LAUNCH_BLOCKING=1, first on the checked library
     (an index out of range traps, naming the kernel, the array and the
     index; with it, FUZZ_REPLAYS rounds of phase 3's corner-scene
     sequence) and then on the normal one; then the replay again here, on
     the normal library, launches asynchronous as in phase 3;
then one JSON line on the kernels (each with its launches on its main
path, its error against its plain version, its time, the plain version's,
its bound: the operations these inputs need over the card's published
fp32 rate) and, last, the device line.  The renders and a JSON record of
the run go to build/chip_smoke/ (git-ignored).  With --phases, only
phases 1, 2 and the listed ones of 11 to 15 run, and neither JSON line
is printed.
"""

import contextlib
import functools
import json
import os
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
TIME_SPP = 16            # one launch of 2^24 paths at 1024^2
KERNEL_CALLS = 16        # back-to-back kernel calls per timed run
REF_SPP = 10000          # the reference configurations' samples
REF_BARS = {"refconfig": 112.0, "specular1024": 230.0}   # BASELINE.md, s
# Published fp32 rate of one H100 SXM outside the tensor cores, at the
# 700 W power limit (NVIDIA's data sheet); every bound below divides an
# operation count by it.
FP32_OPS_PER_S = 67e12

# Large scenes (phases 6-9).
CLUSTER_RAYS = 1 << 16   # camera rays, and as many random rays, in phase 6
LARGE_RES = (512, 512)
SPHERE_SPP = 64          # main-path renders of phase 8
GARDEN_SPP = 2048        # as the committed render
GOLDEN_SPP = 2048        # the 256^2 sphere render held against docs/
CLUSTER_SPP = 4
# The phase-8 films against the committed 2048-spp JAX renders (8-bit,
# gamma 2.2), bars set from the first chip runs (NVIDIA H100 80GB HBM3,
# 700 W): linear means +0.27% (sphere9812) and +0.98% (garden105708)
# apart.  PSNR: the garden render at 2048 spp reads 50.43 dB, the same
# image up to near-tie hits (the committed render drew the same streams);
# the sphere render 34.45 dB, a noise floor: the committed one was drawn
# with other streams, so the two carry independent noise.
GOLDEN_MEAN_RTOL = 0.02
GOLDEN_MIN_PSNR = {"sphere9812": 30.0, "garden105708": 45.0}
BAND_TILES = 2            # tiles per main-path band held in phase 8
TIME_CLUSTER_RAYS = 1 << 20
HELD_CLUSTER_RAYS = 1 << 15  # of those, held against the plain version
TIME_BEAM_RES = (128, 128)   # the plain beam version takes about 1 s here
TIME_BEAM_SPP = 4
TIME_RENDER_SPP = {"sphere9812": (16, 4), "garden105708": (8, 2)}
# The beam bound at the main launch shape is counted over these samples at
# 512^2 (the plain version tests every row: ~1 min on the garden a sample)
# and scaled to the launch's.
COUNT_SPP = {"sphere9812": 2, "garden105708": 1}
BEAM_LAUNCH_CALLS = 2        # back-to-back launches per timed run
# The older kernels of an A/B (--parent-csrc): the sources built, and the
# argument types of their entry points.
PARENT_SOURCES = ("beam_kernel.cu", "cluster_kernel.cu")

# The differentiable path (phase 10).  (a) The Cornell recovery at the width
# of the JAX package's benchmark (bench_invert.py workload 1): 128^2, 384
# spp (192 + 192 paired), depth 5, brute.
DIFF_RES = (128, 128)
DIFF_SPP = 384
DIFF_STEPS = 5
DIFF_TARGET_SPP = 4096       # target film, backend="cuda"
GATHER_STEPS = 3             # steps timed with the index_select gather
REPRO_SPP = 16               # the gradient computed twice, each gather form
# (b) The cluster kernel on the gradient path, sphere9812 at 64^2, 8 spp,
# depth 4; gradients against the plain intersection within DIFF_GRAD_RTOL:
# the hits are bit-identical, and above ONEHOT_GATHER_MAX_ROWS rows the
# table's gradient sums ~10^5 per-ray terms with float atomics in a varying
# order, relative L2 1e-4 covers any order of float32 sums of that size.
KERNEL_DIFF_RES = (64, 64)
KERNEL_DIFF_SPP = 8
KERNEL_DIFF_DEPTH = 4
DIFF_GRAD_RTOL = 1e-4
# (c) The garden (bench_invert.py workload 5): 64^2, 8 spp, depth 4, 3
# steps; a one-sided gradcheck of the two largest albedo gradients at 2
# spp, depth 3, eps 2e-2, bar 0.05 (the JAX package's own run read 1.03e-2,
# INVERT_r05.json; its bench's bar is 0.05).
GARDEN_DIFF_STEPS = 3
GARDEN_TARGET_SPP = 1024     # target film, backend="beam"
GRADCHECK_BAR = 0.05
# (d) tests/test_inverse.py's CI-sized Cornell recovery on the card.
CI_RES = (32, 32)
CI_STEPS = 250
CI_SPP = 64
CI_DEPTH = 4
CI_TARGET_SPP = 2048
CI_BAR = 0.15

# Sharded renders and training (phase 11): two gloo ranks on the one card
# (NCCL refuses two ranks on one GPU).  The 1024^2 Cornell box at the main
# path's 256 spp; the garden at the beam kernel's main-path launch (512^2,
# 25 spp), and at 24 spp for the sample split, which needs an even count;
# the Cornell recovery's width (128^2, 384 spp, depth 5) for the train step.
SHARD_RANKS = 2
SHARD_SPLITS = ((2, 1), (1, 2))      # (tile, sample)
SHARD_GARDEN_SPP = 25
SHARD_GARDEN_SAMPLE_SPP = 24
SHARD_TRAIN_STEPS = 3
SHARD_RTOL = 1e-5        # sample split against one process: sums reordered
SHARD_TIMEOUT = 600      # seconds for both ranks, start-up included
# The realtime session and the CLI (phase 12), at the JAX CLI's realtime
# defaults (256^2, 15 spp a frame) and its bench defaults (1024^2, 512 spp).
REALTIME_RES = (256, 256)
REALTIME_SPP = 15
REALTIME_FRAMES = 4
CLI_RES = 256
CLI_SPP = 64
BENCH_RES = 1024
BENCH_SPP = 512
# The wavefront pipeline (phase 13).  (a) Parity at 64^2, 4 spp, depth 5
# against render_film's brute backend at the JAX test's bar
# (tests/test_wavefront.py: atol 1e-5); (b) sphere9812 at 128^2, 4 spp:
# the cluster kernel on this path; (c) the JAX bench's wavefront cells
# (bench.py:238-244: Cornell 512^2, 64 spp, depth 5 and 16) and
# sphere9812 at 512^2, 16 spp.
WF_RES = (64, 64)
WF_SPP = 4
WF_ATOL = 1e-5
WF_CLUSTER_RES = (128, 128)
WF_TIME_RES = (512, 512)
WF_TIME_SPP = 64
WF_DEPTHS = (5, 16)
WF_SPHERE_SPP = 16
WF_RUNS = 3              # timed runs of each render, after one untimed


class CheckFailed(RuntimeError):
    """A check of this script failed (bench_torch.py counts it against the
    cell that called the helper)."""


def check(cond, msg):
    if not cond:
        raise CheckFailed(f"chip_smoke: {msg}")


def film_diff(got, want):
    """(max abs difference, share of pixels beyond FILM_ATOL)."""
    import torch
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "non-finite film")
    return (float(diff.max()),
            float((diff.amax(dim=-1) > FILM_ATOL).float().mean()))


def bound_ms(ops):
    """The least time for ``ops`` fp32 operations at FP32_OPS_PER_S."""
    return ops / FP32_OPS_PER_S * 1e3


def resource_table(usage, sass):
    """{mangled kernel name: (registers, stack bytes, local-memory stores)}
    of a built library: registers and stack frame from ``cuobjdump
    --dump-resource-usage`` (``usage``), and the STL instructions of each
    function in its SASS (``sass``): spills are stored there, so 0 means
    no spill.  Read from the library itself, the table does not depend on
    which process built it."""
    import re
    stores = {name: sum(bool(re.search(r"\bSTL", o)) for _, o in code)
              for name, code in _sass_functions(sass)}
    out = {}
    for name, regs, stack in re.findall(
            r"Function\s+([\w$.]+)\s*:\s*\n\s*REG:(\d+)\s+STACK:(\d+)",
            usage):
        out[name] = (int(regs), int(stack), stores.get(name))
    return out


def trace_instance(name):
    """'plucker/specular' for a mangled trace_kernel<kHasSpecular, kLoop>
    name, else None."""
    import re
    m = re.search(r"trace_kernelILb([01])ELi([01])E", name)
    if not m:
        return None
    return (("mt", "plucker")[int(m.group(2))] + "/"
            + ("diffuse", "specular")[int(m.group(1))])


def instance_label(name):
    """'plucker/specular', 'beam/specular/inline' or 'cluster/shared' for a
    mangled kernel instance name, else the name."""
    import re
    trace = trace_instance(name)
    if trace:
        return trace
    m = re.search(r"beam_kernelILb([01])ELb([01])E", name)
    if m:
        return ("beam/" + ("diffuse", "specular")[int(m.group(1))] + "/"
                + ("table", "inline")[int(m.group(2))])
    m = re.search(r"cluster_kernelILb([01])E", name)
    if m:
        return "cluster/" + ("global", "shared")[int(m.group(1))]
    return name


LARGE_INSTANCES = ("beam/diffuse/table", "beam/diffuse/inline",
                   "beam/specular/table", "beam/specular/inline",
                   "cluster/global", "cluster/shared")


def _sass_functions(text):
    """[(mangled name, [(address, instruction)])] of cuobjdump's SASS."""
    import re
    out = []
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        code = [(int(a, 16), op.strip()) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
        out.append((chunk.split("\n", 1)[0].strip(), code))
    return out


def _loops(code):
    """The bodies of the backward branches of a function's SASS."""
    import re
    index = {a: i for i, (a, _) in enumerate(code)}
    for i, (a, op) in enumerate(code):
        m = re.search(r"\bBRA 0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in index:
            yield [o for _, o in code[index[int(m.group(1), 16)]:i + 1]]


def sass_walk_loops(text):
    """{instance: {...}} for each beam and cluster instance in cuobjdump's
    SASS ``text``: the tree walk's node loop is the smallest loop with the
    node's three 128-bit loads (its children's indices take one 64-bit
    load), the slab tests' min/max and no reciprocal; its instructions test
    two boxes.  Also the function's local-memory instructions."""
    import re
    out = {}
    for name, code in _sass_functions(text):
        inst = instance_label(name)
        if inst not in LARGE_INSTANCES:
            continue
        walks = [len(body) for body in _loops(code)
                 if sum(bool(re.search(r"\bLD[SG]\S*\.128", o))
                        for o in body) >= 3
                 and sum("FMNMX" in o for o in body) >= 12
                 and not any("MUFU.RCP" in o for o in body)]
        out[inst] = {
            "node_loop_instructions": min(walks) if walks else None,
            "function_instructions": len(code),
            "local_memory": sum(bool(re.search(r"\b(STL|LDL)", o))
                                for _, o in code)}
    return out


def sass_triangle_loops(text):
    """{instance: {...}} for each trace-kernel instance in cuobjdump's SASS
    ``text``: the innermost loop that holds row loads (LDS.128) and
    reciprocals (MUFU.RCP) is the triangle loop; its instructions over the
    rows it tests per trip, and the MUFU, CALL and local-memory
    instructions of the whole function."""
    import re
    out = {}
    for name, code in _sass_functions(text):
        inst = trace_instance(name)
        if inst is None:
            continue
        loops = []
        for body in _loops(code):
            loads = sum("LDS.128" in o for o in body)
            if loads and any("MUFU.RCP" in o for o in body):
                loops.append((len(body), loads, body))
        n, loads, body = min(loops)
        per_row = 3 if inst.startswith("mt") else 5
        rows = loads // per_row
        out[inst] = {
            "loop_instructions": n, "rows_per_trip": rows,
            "instructions_per_test": n / rows,
            "loop_calls": sum("CALL" in o for o in body),
            "function_instructions": len(code),
            "local_memory": sum(bool(re.search(r"\b(STL|LDL)", o))
                                for _, o in code),
            "mufu": sum("MUFU" in o for _, o in code)}
    return out


def lit_sphere_camera(pt, res):
    """sphere_in_box's camera tilted up so the ceiling light is on screen
    (tests/test_beam.py): small films of the stock view can be black."""
    return pt.make_camera((250, 250, -420), (0, 0.35, 1), (0, 1, 0), res,
                          60 * pt.DEG2RAD, 1.0)


def inline_scene(pt, specular=False):
    """70 quads of distinct albedo under one light: more than 64 materials,
    so the beam accel inlines them (tests/test_beam.py).  All diffuse, or
    with ``specular`` every third one specular."""
    sb = pt.SceneBuilder()
    s = 100.0
    sb.add_quad(((s, s - 1, 30), (s, s - 1, 70), (0, s - 1, 70),
                 (0, s - 1, 30)), pt.Emit(1))
    for i in range(70):
        x = (i % 10) * 10.0
        z = (i // 10) * 12.0 + 5.0
        m = (pt.Specular(0.05 * (i % 4), 0.1 + 0.012 * i, 0.5, 0.9)
             if specular and i % 3 == 0
             else pt.Diffuse(0.1 + 0.012 * i, 0.5, 0.9))
        sb.add_quad(((x, 0, z), (x + 9, 0, z), (x + 9, 0, z + 10),
                     (x, 0, z + 10)), m)
    # Level, not tilted down as in the test: the light must be in view, or
    # the depth-1 films are black.
    cam = pt.make_camera((50, 60, -60), (0, 0, 1), (0, 1, 0), (64, 64),
                         70 * pt.DEG2RAD, 1.0)
    return cam, sb.build()


def with_res(cam, res):
    import dataclasses
    return dataclasses.replace(cam, res=tuple(res))


def fuzz_scene(pkg, seed, n_tris, res=(32, 32), specular=True, **device):
    """tests/test_fuzz.py's random scene with exactly ``n_tris`` triangles:
    an emitter quad (two triangles), n_tris - 3 random ones (centres in
    [-8, 8]^3, scales from 10^-2 to 10^0.8, so slivers and overlaps; Emit,
    Diffuse or Specular), then an axis-aligned triangle (axis-parallel
    rays meet d == 0 slab planes); below 3 the first n_tris of the quad and
    that triangle.  The camera, at a random point, looks at the centroid of
    the triangles' first vertices.  Without ``specular`` the specular
    draws make diffuse triangles of the same colour, on the same geometry.
    ``pkg`` is pathtracer_tpu_torch, with
    ``device=`` for its builders, or any package with the same
    SceneBuilder, materials and make_camera (the JAX one, in the tests).
    Returns (camera, scene)."""
    import numpy as np

    r = np.random.default_rng(seed)
    light = pkg.Emit(1.0, 0.9, 0.8)
    a, b, c, d = (4, 9.5, 2), (4, 9.5, 6), (-4, 9.5, 6), (-4, 9.5, 2)
    tris = [(a, b, c, light), (d, c, a, light)]
    for _ in range(max(n_tris - 3, 0)):
        centre = r.uniform(-8, 8, 3)
        scale = 10.0 ** r.uniform(-2, 0.8)
        v = centre + r.normal(size=(3, 3)) * scale
        kind = r.integers(0, 4)
        if kind == 0:
            m = pkg.Emit(*r.uniform(0.2, 1.5, 3))
        elif kind == 3:
            rough, color = float(r.uniform(0, 0.6)), r.uniform(0.1, 0.9, 3)
            m = (pkg.Specular(rough, *color) if specular
                 else pkg.Diffuse(*color))
        else:
            m = pkg.Diffuse(*r.uniform(0.05, 0.95, 3))
        tris.append((*(tuple(x) for x in v), m))
    tris.append(((0, -2, 0), (3, -2, 0), (0, -2, 3),
                 pkg.Diffuse(0.5, 0.5, 0.5)))
    tris = tris[:n_tris]
    sb = pkg.SceneBuilder()
    for tri in tris:
        sb.add_triangle(*tri)
    scene = sb.build(**device)
    pos = r.uniform(-14, 14, 3)
    centroid = np.asarray([t[0] for t in tris], np.float32).mean(axis=0)
    cam = pkg.make_camera(tuple(pos), tuple(centroid - pos), (0, 1, 0),
                          tuple(res), 70 * pkg.DEG2RAD, 1.0, **device)
    return cam, scene


def tie_scene(pt, dev, res=(64, 64)):
    """One triangle twice, red (scene triangle 0) and green (2), under a
    light, in the two leaves of a hand-made BVH: leaf 0 holds the red copy
    and the light, leaf 1 the green copy and a small triangle in front of
    it, so a walk enters leaf 1 first.  Every ray that hits the triangle
    ties exactly (the same row bits); the plain versions' argmin takes the
    lower packed row, the red copy's.  Returns (camera, scene, bvh); cut
    with max_tris=1 (clusters) or sc_tris=1 (beam), each leaf is a cluster
    or a supercluster of its own."""
    import numpy as np
    import torch
    tri = ((-5, -5, 10), (5, -5, 10), (0, 5, 10))
    sb = pt.SceneBuilder()
    sb.add_triangle(*tri, pt.Diffuse(0.8, 0.1, 0.1))
    sb.add_triangle((-10, 8, 8), (10, 8, 8), (0, 8, 12), pt.Emit(4))
    sb.add_triangle(*tri, pt.Diffuse(0.1, 0.8, 0.1))
    sb.add_triangle((6, -2, 3), (8, -2, 3), (7, 0, 3),
                    pt.Diffuse(0.5, 0.5, 0.5))
    scene = sb.build(device=dev)
    v = np.stack([a[:4] for a in scene.host_verts()], 1)
    lo, hi = v.min(1), v.max(1)
    nodes = ([0, 1, 2, 3], [0, 1], [2, 3])    # the root, then its leaves

    def ints(a):
        return torch.tensor(a, dtype=torch.int32)

    bvh = pt.FlatBVH(
        lb=torch.from_numpy(np.stack([lo[n].min(0) for n in nodes])),
        rt=torch.from_numpy(np.stack([hi[n].max(0) for n in nodes])),
        left=ints([1, -1, -1]), right=ints([2, -1, -1]),
        tri_start=ints([0, 0, 2]), tri_end=ints([3, 1, 3]),
        tri_idx=ints([0, 1, 2, 3]), max_leaf=2, depth=2)
    cam = pt.make_camera((0, 0, -10), (0, 0, 1), (0, 1, 0), res, 0.9,
                         device=dev)
    return cam, scene, bvh


def sync(x):
    """Waits for the card when ``x`` lies on it (the helpers below also
    run on CPU tensors, where the wrappers take their plain versions)."""
    import torch
    if x.is_cuda:
        torch.cuda.synchronize()


def camera_rays(cam, n, gen):
    """(origins, directions) of ``n`` camera rays of ``cam`` through
    random pixels with random jitter, drawn from the numpy generator
    ``gen``, on the camera's device."""
    import numpy as np
    import torch
    from pathtracer_tpu_torch.camera import get_rays

    dev = cam.device
    w = torch.from_numpy(gen.integers(0, cam.width, n)).to(dev)
    h = torch.from_numpy(gen.integers(0, cam.height, n)).to(dev)
    u = torch.from_numpy(gen.random((2, n), np.float32)).to(dev)
    o, d = get_rays(cam, w, h, u[0], u[1])
    return o.contiguous(), d.contiguous()


def hold_clusters(name, o, d, cs_d, n_ref):
    """The cluster kernel on the whole ray batch, without (the default) and
    with the ray sort, held against the plain version on its first
    ``n_ref`` rays: t and tid bit for bit; the sorted launch must give the
    unsorted one's t and tid on every ray.  Returns (largest |t|
    difference on hits, record)."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck

    t_k, tid_k = ck.intersect_clusters(o, d, cs_d)
    t_u, tid_u = ck.intersect_clusters(o, d, cs_d, sort_rays=True)
    t_p, tid_p = ck.intersect_clusters_reference(o[:n_ref], d[:n_ref], cs_d)
    sync(t_k)
    check(bool(torch.isfinite(t_k).all()), f"{name}: non-finite t")
    hit = tid_p >= 0
    t_s, tid_s = t_k[:n_ref], tid_k[:n_ref]
    max_err = float((t_s - t_p)[hit].abs().max()) if hit.any() else 0.0
    t_equal = float((t_s == t_p).float().mean())
    tid_equal = float((tid_s == tid_p).float().mean())
    print(f"{name} rays: {int(hit.sum())} of {n_ref} held against the plain "
          f"version hit, t bit-equal {t_equal:.4%}, tid equal "
          f"{tid_equal:.4%}, max abs t diff {max_err:.3e}; with the ray "
          f"sort, on all {o.shape[0]} rays: t equal "
          f"{bool(torch.equal(t_u, t_k))}, tid equal "
          f"{bool(torch.equal(tid_u, tid_k))}", flush=True)
    check(torch.equal(t_s, t_p) and torch.equal(tid_s, tid_p),
          f"{name}: t or tid differ from the plain version")
    check(torch.equal(t_u, t_k) and torch.equal(tid_u, tid_k),
          f"{name}: the ray sort changed a hit")
    return max_err, {"rays": o.shape[0], "held": n_ref,
                     "hits": int(hit.sum()), "t_bit_equal": t_equal,
                     "tid_equal": tid_equal}


def hold_cluster_tie(pt, dev):
    """The tie scene's camera rays through the cluster kernel: the rays
    that hit the duplicated triangle must return the red copy, the lower
    packed row, as the plain version does.  Returns the record."""
    import torch
    from pathtracer_tpu_torch.camera import get_rays
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck

    cam, scene, bvh = tie_scene(pt, dev)
    cs = pt.build_clusters(scene, bvh=bvh, max_tris=1).to(dev)
    check(cs.num_clusters == 2, f"tie scene: {cs.num_clusters} clusters")
    n = cam.width * cam.height
    idx = torch.arange(n, device=dev)
    half = torch.full((n,), 0.5, device=dev)
    o, d = get_rays(cam, idx % cam.width, idx // cam.width, half, half)
    err, rec = hold_clusters("tie", o.contiguous(), d.contiguous(), cs, n)
    _, tid = ck.intersect_clusters(o, d, cs)
    red, green = int((tid == 0).sum()), int((tid == 2).sum())
    print(f"tie: {red} rays return the red copy (the lower row), {green} "
          f"the green one", flush=True)
    check(red > 0 and green == 0, "tie: not the lower packed row")
    rec.update(red=red, green=green)
    return err, rec


def phase_cluster(pt, dev, record):
    """Phase 6; returns the largest |t| difference on hits."""
    import numpy as np
    import torch

    print("== 6 cluster kernel against its plain version "
          "(sphere_in_box(50, 100))", flush=True)
    cam, sb = pt.meshes.sphere_in_box(50, 100)
    scene = sb.build()
    t0 = time.perf_counter()
    bvh = pt.build_bvh(scene)
    bvh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs = pt.build_clusters(scene, bvh=bvh)
    cl_s = time.perf_counter() - t0
    print(f"{scene.num_tris} triangles: BVH {bvh_s:.3f} s, "
          f"{cs.num_clusters} clusters {cl_s:.3f} s on the host", flush=True)
    cs_d = cs.to(dev)
    gen = np.random.default_rng(6)
    n = CLUSTER_RAYS
    check(tuple(cam.res) == LARGE_RES, f"sphere camera at {cam.res}")
    cam_o, cam_d = camera_rays(cam, n, gen)
    rnd_o = torch.from_numpy(gen.uniform(1, 499, (n, 3)).astype(np.float32))
    rnd_d = gen.normal(size=(n, 3)).astype(np.float32)
    rnd_d /= np.linalg.norm(rnd_d, axis=-1, keepdims=True)
    rays = {"camera": (cam_o, cam_d),
            "random": (rnd_o.to(dev), torch.from_numpy(rnd_d).to(dev))}
    max_err = 0.0
    out = {}
    for name, (o, d) in rays.items():
        err, out[name] = hold_clusters(name, o, d, cs_d, n)
        max_err = max(max_err, err)
    err, out["tie"] = hold_cluster_tie(pt, dev)
    max_err = max(max_err, err)

    cam64 = lit_sphere_camera(pt, (64, 64))
    f_cl = pt.render_film(cam64, scene, 2, 3, bvh=cs, backend="cluster")
    f_bvh = pt.render_film(cam64, scene, 2, 3, bvh=bvh, backend="bvh")
    torch.cuda.synchronize()
    film_max, share = film_diff(f_cl.data, f_bvh.data)
    check(float(f_cl.data.max()) > 0.0, "cluster film is black")
    check(share <= MAX_FLIP_SHARE,
          f"cluster vs bvh: {share:.4%} of pixels beyond {FILM_ATOL}")
    print(f"render_film cluster vs bvh (64^2, 2 spp, depth 3): max abs diff "
          f"{film_max:.3e}, pixels beyond {FILM_ATOL}: {share:.4%}",
          flush=True)
    out["film"] = {"max_abs": film_max, "share": share}
    record["cluster"] = out
    return max_err


def hold_beam(key, cam, scene, spp, depth, accel=None):
    """The beam kernel's film against its plain version's, bit for bit.
    Returns the record."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk

    got = bk.render_sum_beam(cam, scene, 0, spp, depth, accel=accel) / spp
    want = bk.render_sum_beam_reference(cam, scene, 0, spp, depth,
                                        accel=accel) / spp
    torch.cuda.synchronize()
    diff, share = film_diff(got, want)
    equal = float((got == want).float().mean())
    print(f"{key}: max abs diff {diff:.3e}, bit-equal values {equal:.4%}, "
          f"mean {float(got.mean()):.5f}", flush=True)
    check(float(got.mean()) > 0.0, f"{key}: black film")
    check(torch.equal(got, want), f"{key}: not bit-identical to the plain "
          f"version")
    return {"max_abs": diff, "share": share, "bit_equal": equal}


def phase_beam(pt, dev, record):
    """Phase 7; returns the largest film difference per sample."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk

    print("== 7 beam kernel against its plain version", flush=True)
    _, sb = pt.meshes.sphere_in_box(50, 100)
    sphere = sb.build()
    inline_cam, inline = inline_scene(pt)
    inline_spec = inline_scene(pt, specular=True)[1]
    # The four kernel instances: table materials (sphere9812, cornell;
    # specular: modified_cornell) and inline ones (inline70, and
    # inline70spec with specular quads), each with and without the
    # specular branch.
    scenes = {"sphere9812": lambda r: (lit_sphere_camera(pt, r), sphere),
              "cornell": lambda r: pt.cornell_box(res=r),
              "specular": lambda r: pt.modified_cornell(0.05, res=r),
              "inline70": lambda r: (with_res(inline_cam, r), inline),
              "inline70spec": lambda r: (with_res(inline_cam, r),
                                         inline_spec)}
    out = {}
    max_abs = 0.0
    spp = 4
    for name, make in scenes.items():
        # The Cornell boxes' light is out of a 200x72 view, so their
        # depth-1 films would be black: they take the transposed shape.
        for res in ((64, 64), (72, 200) if name in ("cornell", "specular")
                    else (200, 72)):
            cam, scene = make(res)
            accel = bk._accel_for(scene)
            check(scene.has_specular == (name in ("specular",
                                                  "inline70spec"))
                  and accel.mats_inline == name.startswith("inline"),
                  f"{name}: not the kernel instance it stands for")
            for depth in (1, DEPTH):
                key = f"{name} {res[0]}x{res[1]} depth {depth}"
                out[key] = hold_beam(key, cam, scene, spp, depth)
                max_abs = max(max_abs, out[key]["max_abs"])

    cam, scene, bvh = tie_scene(pt, dev)
    accel = pt.build_beam_accel(scene, bvh=bvh, sc_tris=1)
    check(accel.num_superclusters == 2, "tie scene: not two superclusters")
    key = f"tie 64x64 depth {DEPTH}"
    out[key] = hold_beam(key, cam, scene, spp, DEPTH, accel=accel)
    max_abs = max(max_abs, out[key]["max_abs"])
    rgb = bk.render_sum_beam(cam, scene, 0, spp, DEPTH,
                             accel=accel).mean(dim=(0, 1))
    print(f"tie: mean rgb {[round(float(c), 5) for c in rgb]}: the red copy "
          f"(the lower row) is the one seen", flush=True)
    check(float(rgb[0]) > float(rgb[1]), "tie: not the red copy")

    cam, scene = scenes["sphere9812"]((200, 72))
    full = bk.render_tiles_beam(cam, scene, 0, 4, DEPTH)
    band = bk.render_tiles_beam(cam, scene, 0, 4, DEPTH, tile0=5, n_tiles=3)
    split = (bk.render_tiles_beam(cam, scene, 0, 1, DEPTH)
             + bk.render_tiles_beam(cam, scene, 1, 3, DEPTH))
    torch.cuda.synchronize()
    tile = bk.TILE_PX
    check(torch.equal(band, full[:, 5 * tile:8 * tile]),
          "band launch differs from the same tiles of the full launch")
    window = float((split - full).abs().max())
    check(window <= WINDOW_ATOL, f"two windows differ from one by {window}")
    print(f"band tiles [5, 8) of 16 bit-identical; window split max diff "
          f"{window:.3e}", flush=True)
    sb = pt.SceneBuilder()
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                    pt.HostMaterial(pt.DIFFUSE, color=(1, 1, 1),
                                    emit=(1, 0, 0)))
    try:
        bk.render_sum_beam(cam, sb.build(), 0, 1, 1)
    except ValueError as e:
        print(f"emission check raised: {e}", flush=True)
    else:
        raise RuntimeError("chip_smoke: emissive non-EMIT scene accepted")
    out["band_window_max"] = window
    record["beam"] = out
    return max_abs


def golden_compare(pt, png, golden):
    """(PSNR in gamma space, linear mean of the render, of the golden)."""
    import numpy as np
    got = pt.read_png(png).astype(np.float64) / 255.0
    ref = pt.read_png(os.path.join(REPO, golden)).astype(np.float64) / 255.0
    check(got.shape == ref.shape, f"{png}: shape {got.shape} vs {ref.shape}")
    return (pt.psnr(got, ref), float((got ** 2.2).mean()),
            float((ref ** 2.2).mean()))


def hold_main_path_bands(pt, cam, scene, spp, depth=DEPTH, seed=None):
    """The beam kernel at the main path's launch shape (its padded film, its
    accel and its samples per launch) held against the plain version on two
    bands of BAND_TILES tiles: the film's first tiles and the tiles at its
    centre, the first launch's sample window (``seed``: the render's, None
    for the package's).  Returns (record, largest per-sample
    difference)."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk

    spp_call = bk._default_spp_per_call(cam, spp, depth)
    wp, hp = bk._padded_res(*cam.res)
    centre_sq = (hp // 2 // 64) * (wp // 64) + wp // 2 // 64
    out, worst, lit = {}, 0.0, 0.0
    for tile0 in (0, centre_sq * (64 * 64 // bk.TILE_PX)):
        kw = dict(tile0=tile0, n_tiles=BAND_TILES)
        if seed is not None:
            kw["seed"] = seed
        got = bk.render_tiles_beam(cam, scene, 0, spp_call, depth, **kw)
        want = bk.render_tiles_beam_reference(cam, scene, 0, spp_call, depth,
                                              **kw)
        sync(got)
        diff, share = film_diff(got.T / spp_call, want.T / spp_call)
        equal = float((got == want).float().mean())
        lit = max(lit, float(got.mean()))
        key = f"tiles [{tile0}, {tile0 + BAND_TILES})"
        print(f"  {key}, {spp_call} spp (one main-path launch), kernel vs "
              f"plain: max abs diff {diff:.3e}, bit-equal values "
              f"{equal:.4%}", flush=True)
        check(torch.equal(got, want), f"{key}: not bit-identical")
        worst = max(worst, diff)
        out[key] = {"spp": spp_call, "max_abs": diff, "share": share,
                    "bit_equal": equal}
    check(lit > 0.0, "the main path's bands are black")
    return out, worst


def phase_large(pt, dev, record):
    """Phase 8; returns (beam launches, cluster launches) of the main
    path's renders and the largest per-sample difference of its bands."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

    print(f"== 8 large-scene main path at {LARGE_RES[0]}x{LARGE_RES[1]}, "
          f"depth {DEPTH}, backend='auto'", flush=True)
    out = {}
    beam_launches = 0
    band_err = 0.0
    scenes = {
        "sphere9812": (pt.meshes.sphere_in_box(50, 100), SPHERE_SPP,
                       "docs/sphere9812_beam_2048spp.png"),
        "garden105708": (pt.meshes.mesh_garden(), GARDEN_SPP,
                         "docs/garden105708_beam_2048spp.png"),
    }
    for name, ((cam_d, sb), spp, golden) in scenes.items():
        scene = scene_d = sb.build()
        t0 = time.perf_counter()
        pt.build_bvh(scene)
        bvh_s = time.perf_counter() - t0
        bk._ACCEL_CACHE.clear()     # time the host build, not the cache
        t0 = time.perf_counter()
        accel = bk._accel_for(scene_d)
        accel_s = time.perf_counter() - t0
        print(f"{name}: {scene.num_tris} triangles; host build: BVH "
              f"{bvh_s:.3f} s, beam accel (BVH included, and the copy to "
              f"the card) {accel_s:.3f} s, "
              f"{accel.num_superclusters} superclusters, "
              f"{accel.num_clusters} clusters", flush=True)
        png = os.path.join(OUT_DIR, f"chip_smoke_{name}_512.png")
        ttk.LAUNCHES = ck.LAUNCHES = bk.LAUNCHES = 0
        t0 = time.perf_counter()
        film = pt.render(cam_d, scene_d, samples=spp, depth=DEPTH,
                         filename=png)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = bk.LAUNCHES
        check(launches > 0, f"{name}: the main path launched no beam kernel")
        check(ttk.LAUNCHES == 0 and ck.LAUNCHES == 0,
              f"{name}: the main path launched another kernel")
        beam_launches += launches
        img = film.data
        check(tuple(img.shape) == (LARGE_RES[1], LARGE_RES[0], 3),
              f"{name}: film shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite film")
        check(float(img.mean()) > 0.01, f"{name}: black film")
        entry = {"spp": spp, "seconds": seconds, "launches": launches,
                 "bvh_s": bvh_s, "accel_s": accel_s,
                 "gamma_mean": float(img.mean())}
        if name == "sphere9812":
            # The committed render is the 256^2 crop of this view.
            png = os.path.join(OUT_DIR, f"chip_smoke_{name}_256.png")
            pt.render(with_res(cam_d, (256, 256)), scene_d,
                      samples=GOLDEN_SPP, depth=DEPTH, filename=png,
                      verbose=False)
            entry["golden_spp"] = GOLDEN_SPP
        psnr, mean, ref_mean = golden_compare(pt, png, golden)
        print(f"{name}: {launches} beam launches, {seconds:.3f} s wall, "
              f"against {golden}: PSNR {psnr:.2f} dB, linear mean "
              f"{mean:.5f} vs {ref_mean:.5f}", flush=True)
        check(abs(mean - ref_mean) <= GOLDEN_MEAN_RTOL * ref_mean,
              f"{name}: linear mean {mean} vs the golden's {ref_mean}")
        check(psnr >= GOLDEN_MIN_PSNR[name], f"{name}: PSNR {psnr:.2f} dB")
        entry.update(psnr=psnr, linear_mean=mean, golden_mean=ref_mean)
        entry["bands"], err = hold_main_path_bands(pt, cam_d, scene_d, spp)
        band_err = max(band_err, err)
        out[name] = entry

    cam_d, sb = pt.meshes.sphere_in_box(50, 100)
    scene_d = sb.build()
    ttk.LAUNCHES = ck.LAUNCHES = bk.LAUNCHES = 0
    t0 = time.perf_counter()
    film = pt.render(cam_d, scene_d, samples=CLUSTER_SPP, depth=DEPTH,
                     backend="cluster", filename=os.path.join(
                         OUT_DIR, "chip_smoke_sphere9812_cluster.png"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cluster_launches = ck.LAUNCHES
    check(cluster_launches > 0, "backend='cluster' launched no kernel")
    check(bool(torch.isfinite(film.data).all())
          and float(film.data.mean()) > 0.01, "cluster film black or bad")
    print(f"sphere9812 backend='cluster': {cluster_launches} launches, "
          f"{seconds:.3f} s wall at {CLUSTER_SPP} spp", flush=True)
    out["cluster"] = {"spp": CLUSTER_SPP, "seconds": seconds,
                      "launches": cluster_launches}
    record["large"] = out
    return beam_launches, cluster_launches, band_err


@contextlib.contextmanager
def swapped(module, name, fn):
    """``module.name`` is ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def parent_library(csrc):
    """The older checkout's beam and cluster kernels (``csrc``/
    PARENT_SOURCES, with its own common.cuh), built as this checkout's are,
    with the argument types of their entry points."""
    import ctypes
    from pathtracer_tpu_torch.utils import build

    lib = build.load_library(csrc, "libparent_large", PARENT_SOURCES)
    lib.pt_beam_render.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.pt_beam_render.restype = ctypes.c_int
    lib.pt_cluster_intersect.argtypes = ([ctypes.c_void_p] * 8
                                         + [ctypes.c_int] * 3
                                         + [ctypes.c_void_p])
    lib.pt_cluster_intersect.restype = ctypes.c_int
    return lib


def parent_tiles_beam(lib, camera, scene, sample0, samples, depth=DEPTH, *,
                      seed=None, accel=None, spp_per_call=None, tile0=0,
                      n_tiles=None):
    """``render_tiles_beam`` as the older wrapper drove the older kernel,
    which loops over every supercluster box in its per-octant ``sc_order``.
    """
    import torch
    from pathtracer_tpu_torch import rng as prng
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk

    seed = prng.SEED if seed is None else seed
    tile0, n_tiles = bk._band(camera, tile0, n_tiles)
    if spp_per_call is None:
        spp_per_call = bk._default_spp_per_call(camera, samples, depth)
    dev = scene.device
    accel = bk._accel_for(scene) if accel is None else accel.to(dev)
    cam = bk._camera_params(camera)
    film = torch.zeros((3, n_tiles * bk.TILE_PX), dtype=torch.float32,
                       device=dev)
    wp, _ = bk._padded_res(*camera.res)
    stream = torch.cuda.current_stream(dev).cuda_stream
    s = 0
    while s < samples:
        spp = min(spp_per_call, samples - s)
        err = lib.pt_beam_render(
            cam.data_ptr(), accel.sc_bounds.data_ptr(),
            accel.sc_first.data_ptr(), accel.sc_ncl.data_ptr(),
            accel.sc_order.data_ptr(), accel.mats.data_ptr(),
            accel.cl_bounds.data_ptr(), accel.tri_cols.data_ptr(),
            film.data_ptr(), None, accel.num_superclusters, accel.ctris,
            n_tiles, camera.height, wp // 64, tile0,
            (sample0 + s) & prng.MASK, spp, depth,
            (int(seed) * prng.SEED_MIX) & prng.MASK, int(scene.has_specular),
            int(accel.mats_inline), dev.index or 0, stream)
        check(err == 0, f"older beam kernel: cudaError {err}")
        s += spp
    return film


def parent_intersect_clusters(lib, ray_o, ray_d, cs):
    """``intersect_clusters`` as the older wrapper drove the older kernel
    (without the optional ray sort): each block of 256 rays tests every
    cluster box, in its order by distance from the block's mean origin,
    which the wrapper sorts on every call."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck

    dev = ray_o.device
    R = ray_o.shape[0]
    Rp = -(-R // ck.BLOCK_RAYS) * ck.BLOCK_RAYS
    if Rp != R:
        pad_o = (cs.scene_bounds[1] + 1.0).expand(Rp - R, 3)
        pad_d = torch.zeros((Rp - R, 3), dtype=torch.float32, device=dev)
        pad_d[:, 0] = 1.0
        ray_o = torch.cat([ray_o, pad_o])
        ray_d = torch.cat([ray_d, pad_d])
    origin = ray_o.reshape(-1, ck.BLOCK_RAYS, 3).mean(dim=1)
    centers = cs.centers
    d2 = ((origin * origin).sum(-1)[:, None] - 2.0 * (origin @ centers.T)
          + (centers * centers).sum(-1)[None, :])
    order = torch.argsort(d2, dim=1).to(torch.int32).contiguous()
    planes = torch.cat([ray_o.T, ray_d.T]).contiguous()
    t = torch.empty(Rp, dtype=torch.float32, device=dev)
    slot = torch.empty(Rp, dtype=torch.int32, device=dev)
    err = lib.pt_cluster_intersect(
        planes.data_ptr(), cs.tri_data.data_ptr(), cs.bounds.data_ptr(),
        cs.start.data_ptr(), cs.count.data_ptr(), order.data_ptr(),
        t.data_ptr(), slot.data_ptr(), Rp, cs.num_clusters, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err == 0, f"older cluster kernel: cudaError {err}")
    tid = torch.where(slot >= 0, cs.tid_map[slot.clamp_min(0).long()], -1)
    return t[:R], tid[:R].to(torch.int32)


def alternate(fns, calls, parent):
    """{key: [ms, ...]} of device_ms over ``fns`` {"new": fn[, "older":
    fn]}: with an older version, in the order older, new, new, older."""
    from pathtracer_tpu_torch.utils.timer import device_ms
    order = ("older", "new", "new", "older") if parent else ("new",)
    runs = {k: [] for k in order}
    for key in order:
        runs[key].extend(device_ms(fns[key], calls=calls)[1])
    return runs


def time_beam_launch(pt, name, cam, scene, card, parent):
    """The beam kernel at the main path's launch shape: the whole padded
    512^2 film, one launch of the first window's samples (25 at depth 5);
    with ``parent``, beside the older kernel, older/new/new/older.  Its
    bound counts the work at 512^2 over COUNT_SPP[name] samples, scaled to
    the launch's.  Returns the record."""
    import statistics
    import torch
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk

    spp = bk._default_spp_per_call(cam, GARDEN_SPP, DEPTH)
    # The accel is passed in, so that its host build and the per-call hash
    # of the scene's bytes stay out of the kernel's time.
    accel = bk._accel_for(scene)
    films = {}
    fns = {"new": lambda: films.__setitem__(
        "new", bk.render_tiles_beam(cam, scene, 0, spp, DEPTH, accel=accel))}
    if parent:
        fns["older"] = lambda: films.__setitem__(
            "older", parent_tiles_beam(parent, cam, scene, 0, spp, DEPTH,
                                       accel=accel))
    runs = alternate(fns, BEAM_LAUNCH_CALLS, parent)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(films["new"]).all())
          and float(films["new"].mean()) > 0.0, f"{name}: bad launch film")
    ms = statistics.median(runs["new"])
    count_spp = COUNT_SPP[name]
    work = bk.count_work(cam, scene, 0, count_spp, DEPTH)
    bound = bound_ms(work["ops"] * spp / count_spp)
    live = work["live_segments"]
    rec = {"spp": spp, "ms": ms, "runs": runs, "work": work,
           "count_spp": count_spp, "bound_ms": bound, "share": bound / ms}
    older = ""
    if parent:
        rec["older_ms"] = statistics.median(runs["older"])
        rec["older_equal_values"] = float(
            (films["older"] == films["new"]).float().mean())
        older = (f"; older kernel {rec['older_ms']:.3f} ms, "
                 f"{rec['older_ms'] / ms:.2f}x (bit-equal film values "
                 f"{rec['older_equal_values']:.4%})")
    print(f"{card}: {name} beam kernel, {cam.width}x{cam.height}, {spp} spp, "
          f"depth {DEPTH}, one launch: {ms:.3f} ms (runs {runs}){older}; "
          f"bound from {count_spp} spp x {spp / count_spp:g}: {live} live "
          f"segments open {work['sc_box_tests'] / live:.3f} supercluster and "
          f"{work['cluster_box_tests'] / live:.3f} cluster boxes and test "
          f"{work['rows'] / live:.3f} rows each, {work['ops']:.4e} "
          f"operations, {bound:.4f} ms, {bound / ms:.2%} of it reached",
          flush=True)
    return rec


def phase_timing(pt, dev, card, record, parent=None):
    """Phase 9; returns {kernel: (ms, plain_ms, bound_ms)} and, under
    "cluster_err", the largest |t| difference of the garden's and the
    sphere's held rays.  ``parent``: the older kernels' library, timed
    beside the new ones."""
    import numpy as np
    import torch
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck
    from pathtracer_tpu_torch.utils.timer import device_ms

    print("== 9 timing" + (", beside the older kernels" if parent else ""),
          flush=True)
    out = {"beam": {}, "cluster": {}, "renders": {}}
    scenes = {}
    for name, (cam, sb) in (("sphere9812", pt.meshes.sphere_in_box(50, 100)),
                            ("garden105708", pt.meshes.mesh_garden())):
        scenes[name] = (cam, sb.build())
        out["beam"][name] = time_beam_launch(pt, name, *scenes[name], card,
                                             parent)

    cam, scene = scenes["sphere9812"]
    cam_t = with_res(cam, TIME_BEAM_RES)
    res = {}
    plain_ms, plain_all = device_ms(lambda: res.__setitem__(
        "p", bk.render_sum_beam_reference(cam_t, scene, 0, TIME_BEAM_SPP,
                                          DEPTH)), calls=1)
    small_ms, small_all = device_ms(lambda: res.__setitem__(
        "k", bk.render_sum_beam(cam_t, scene, 0, TIME_BEAM_SPP, DEPTH)),
        calls=KERNEL_CALLS)
    check(torch.equal(res["k"], res["p"]), "beam at 128^2: not bit-identical")
    print(f"{card}: sphere9812 beam at {TIME_BEAM_RES[0]}x{TIME_BEAM_RES[1]}, "
          f"{TIME_BEAM_SPP} spp, depth {DEPTH} (8 tiles, 64 blocks): plain "
          f"version {plain_ms:.3f} ms (runs {plain_all}), kernel "
          f"{small_ms:.3f} ms (runs {small_all}), bit-identical", flush=True)
    out["beam"]["sphere9812 128^2"] = {
        "spp": TIME_BEAM_SPP, "ms": small_ms, "runs": small_all,
        "plain_ms": plain_ms, "plain_runs": plain_all}
    main = out["beam"]["sphere9812"]
    beam_times = (main["ms"], plain_ms, main["bound_ms"])

    gen = np.random.default_rng(9)
    n = TIME_CLUSTER_RAYS
    cluster_err = 0.0
    for name, (c, s) in scenes.items():
        check(tuple(c.res) == LARGE_RES, f"{name} camera at {c.res}")
        o, d = camera_rays(c, n, gen)
        cs = pt.build_clusters(s).to(dev)
        err, held = hold_clusters(f"{name} ({cs.num_clusters} clusters, "
                                  f"tree depth {cs.tree_depth}) camera", o,
                                  d, cs, HELD_CLUSTER_RAYS)
        cluster_err = max(cluster_err, err)
        work = ck.count_work(o, d, cs, *ck.intersect_clusters(o, d, cs))
        bound = bound_ms(work["ops"])
        fns = {"new": lambda: ck.intersect_clusters(o, d, cs)}
        if parent:
            fns["older"] = lambda: parent_intersect_clusters(parent, o, d, cs)
        cl = alternate(fns, 4, parent)
        cl["sorted"] = device_ms(lambda: ck.intersect_clusters(
            o, d, cs, sort_rays=True), calls=4)[1]
        if name == "sphere9812":    # the garden's would take about 30 s
            cl["plain"] = device_ms(
                lambda: ck.intersect_clusters_reference(o, d, cs),
                calls=1)[1]
        med = {k: float(np.median(v)) for k, v in cl.items()}
        extra = "".join(f", {k} {v:.3f} ms" for k, v in med.items()
                        if k != "new")
        print(f"{card}: cluster kernel per 2^20 camera rays of {name}: "
              f"{med['new']:.3f} ms (runs {cl['new']}){extra}; bound: "
              f"{work['box_tests'] / n:.3f} boxes and {work['rows'] / n:.3f} "
              f"rows a ray, {work['ops']:.4e} operations, {bound:.4f} ms, "
              f"{bound / med['new']:.2%} of it reached", flush=True)
        out["cluster"][name] = {"runs": cl, "ms": med, "held": held,
                                "work": work, "bound_ms": bound}
        if name == "sphere9812":
            cluster_times = (med["new"], med["plain"], bound)

    unsorted = ck.intersect_clusters
    for name, (c, s) in scenes.items():
        beam_spp, cluster_spp = TIME_RENDER_SPP[name]
        segs = {"beam": LARGE_RES[0] * LARGE_RES[1] * beam_spp * DEPTH,
                "cluster": LARGE_RES[0] * LARGE_RES[1] * cluster_spp * DEPTH}
        for backend, spp in (("beam", beam_spp), ("cluster", cluster_spp)):
            first = ""
            if backend == "cluster":
                # The first call builds the cluster set on the host; the
                # timed ones find it in clusters_for's cache.
                ck._CLUSTER_CACHE.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pt.render_film(c, s, spp, DEPTH, backend=backend)
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
                first = f", the first call (builds the set) {first_ms:.3f} ms"
            ms, runs = device_ms(lambda: pt.render_film(
                c, s, spp, DEPTH, backend=backend), calls=1)
            rate = segs[backend] / ms * 1e3
            print(f"{card}: {name} {backend} 512^2, {spp} spp, depth "
                  f"{DEPTH}: {ms:.3f} ms per render (runs {runs}), "
                  f"{rate:.4e} ray segments/s{first}", flush=True)
            out["renders"][f"{name} {backend}"] = {
                "spp": spp, "ms": ms, "runs": runs, "segments_per_s": rate}
            if first:
                out["renders"][f"{name} {backend}"]["first_ms"] = first_ms
        # With the cluster set built once, so that the host build's noise
        # stays out of the comparisons: the older kernels against the new
        # ones, then the cluster render without the kernel's ray sort (the
        # default) and with it, off/on/on/off.
        cs = pt.build_clusters(s).to(dev)

        def beam_render():
            pt.render_film(c, s, beam_spp, DEPTH, backend="beam")

        def cluster_render():
            pt.render_film(c, s, cluster_spp, DEPTH, backend="cluster",
                           bvh=cs)

        if parent:
            for backend, spp, fn, module, attr, older in (
                    ("beam", beam_spp, beam_render, bk, "render_tiles_beam",
                     functools.partial(parent_tiles_beam, parent)),
                    ("cluster", cluster_spp, cluster_render, ck,
                     "intersect_clusters",
                     functools.partial(parent_intersect_clusters, parent))):
                runs = {"older": [], "new": []}
                for key in ("older", "new", "new", "older"):
                    with swapped(module, attr, older if key == "older"
                                 else getattr(module, attr)):
                        runs[key].append(device_ms(fn, calls=1)[0])
                rates = {k: [segs[backend] / ms * 1e3 for ms in v]
                         for k, v in runs.items()}
                print(f"{card}: {name} {backend} render 512^2, {spp} spp, "
                      f"depth {DEPTH}, older/new ms per render {runs}, ray "
                      f"segments/s {rates}", flush=True)
                out["renders"][f"{name} {backend} older/new"] = {
                    "ms": runs, "segments_per_s": rates}
        ab = []
        for sort in (False, True, True, False):
            with swapped(ck, "intersect_clusters", functools.partial(
                    unsorted, sort_rays=True) if sort else unsorted):
                ab.append(device_ms(cluster_render, calls=1)[0])
        print(f"{card}: {name} cluster 512^2, {cluster_spp} spp, depth "
              f"{DEPTH}, cluster set built once, ms per render without/with/"
              f"with/without the ray sort: {ab}", flush=True)
        out["renders"][f"{name} cluster sort off/on/on/off"] = ab
    tests = bk.count_tri_tests(cam, scene, samples=8, depth=DEPTH)
    print(f"sphere9812 512^2: {tests:.2f} triangle rows tested per ray "
          f"segment (beam kernel, per ray)", flush=True)
    out["sphere9812_tri_tests_per_segment"] = tests
    record["large_timing"] = out
    return {"beam_kernel": beam_times, "cluster_kernel": cluster_times,
            "cluster_err": cluster_err}


@contextlib.contextmanager
def timed_steps(times):
    """Appends the seconds of every ``inverse._train_step`` inside the
    block to ``times`` (a step ends in ``float(loss)``, which waits for the
    device)."""
    from pathtracer_tpu_torch import inverse
    real = inverse._train_step

    def step(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        times.append(time.perf_counter() - t0)
        return out

    with swapped(inverse, "_train_step", step):
        yield


def loss_and_grad(loss, params):
    """(value, {name: gradient}) of ``loss`` at ``params``."""
    import torch
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    value = loss(leaves)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


def rel_l2(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def recovery_run(pt, card, name, cam, scene, target, **kw):
    """recover_materials with its steps timed; prints and returns the
    record (median seconds per step, peak device memory)."""
    import statistics
    import numpy as np
    import torch
    from pathtracer_tpu_torch import inverse

    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with timed_steps(times):
        mats, losses = inverse.recover_materials(cam, scene, target, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(np.isfinite(losses).all() and len(losses) == kw["steps"],
          f"{name}: losses {losses}")
    med = statistics.median(times)
    spread = (f"steps {[round(t, 4) for t in times]}" if len(times) <= 10
              else f"fastest {min(times):.4f}, slowest {max(times):.4f}")
    print(f"{card}: {name}: {kw['steps']} steps, median {med:.4f} s a step "
          f"({spread}), peak device memory "
          f"{peak / 2**30:.3f} GiB, losses {losses[0]:.4e} -> "
          f"{losses[-1]:.4e}", flush=True)
    return mats, {"steps": kw["steps"], "seconds_per_step": med,
                  "step_seconds": times, "peak_bytes": peak,
                  "loss_first": float(losses[0]),
                  "loss_last": float(losses[-1])}


def phase_diff(pt, dev, card, record):
    """Phase 10 (see the module docstring)."""
    import numpy as np
    import torch
    from pathtracer_tpu_torch import diff, inverse
    from pathtracer_tpu_torch.ops import trace as trace_ops
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

    print("== 10 differentiable rendering and material recovery "
          f"(allow_tf32 {torch.backends.cuda.matmul.allow_tf32})", flush=True)
    out = {}

    # (a) The Cornell recovery at full width; both gather forms.
    cam, scene = pt.cornell_box(res=DIFF_RES)
    target = pt.render_film(cam, scene, DIFF_TARGET_SPP, DEPTH,
                            backend="cuda").data
    kw = dict(samples=DIFF_SPP, depth=DEPTH, lr=0.08, backend="brute",
              optimize=("albedo", "emit"))
    name = (f"cornell {DIFF_RES[0]}^2, {DIFF_SPP} spp paired, depth "
            f"{DEPTH}, brute")
    ttk.LAUNCHES = ck.LAUNCHES = bk.LAUNCHES = 0
    _, out["cornell"] = recovery_run(pt, card, name + ", one-hot gather",
                                     cam, scene, target, steps=DIFF_STEPS,
                                     **kw)
    check(ttk.LAUNCHES == ck.LAUNCHES == bk.LAUNCHES == 0,
          "the brute recovery launched a kernel")
    with swapped(trace_ops, "ONEHOT_GATHER_MAX_ROWS", 0):
        _, out["cornell index_select"] = recovery_run(
            pt, card, name + ", index_select gather", cam, scene, target,
            steps=GATHER_STEPS, **kw)
    loss = diff.make_loss(cam, scene, target, REPRO_SPP, DEPTH)
    params = diff.material_params(scene)
    repro = {}
    for form, rows in (("onehot", trace_ops.ONEHOT_GATHER_MAX_ROWS),
                       ("index_select", 0)):
        with swapped(trace_ops, "ONEHOT_GATHER_MAX_ROWS", rows):
            _, g1 = loss_and_grad(loss, params)
            _, g2 = loss_and_grad(loss, params)
        repro[form] = {k: {"bit_equal": bool(torch.equal(g1[k], g2[k])),
                           "rel_l2": rel_l2(g1[k], g2[k])} for k in g1}
    print(f"the same gradient twice ({REPRO_SPP} spp): {repro}", flush=True)
    out["reproducible"] = repro

    # (b) The cluster kernel on the gradient path against the plain
    # intersection.
    cam_s, sb = pt.meshes.sphere_in_box(50, 100)
    scene_s = sb.build()
    cam_s = with_res(cam_s, KERNEL_DIFF_RES)
    target_s = pt.render_film(cam_s, scene_s, 64, KERNEL_DIFF_DEPTH,
                              backend="beam").data
    params = diff.material_params(scene_s)
    loss = diff.make_loss(cam_s, scene_s, target_s, KERNEL_DIFF_SPP,
                          KERNEL_DIFF_DEPTH, backend="cluster")
    n0 = ck.LAUNCHES
    film_k = diff.render_film_diff(cam_s, scene_s, params, KERNEL_DIFF_SPP,
                                   KERNEL_DIFF_DEPTH, backend="cluster")
    value_k, grads_k = loss_and_grad(loss, params)
    torch.cuda.synchronize()
    launches = ck.LAUNCHES - n0
    with swapped(ck, "intersect_clusters",
                 lambda o, d, cs, **_: ck.intersect_clusters_reference(
                     o, d, cs)):
        film_p = diff.render_film_diff(cam_s, scene_s, params,
                                       KERNEL_DIFF_SPP, KERNEL_DIFF_DEPTH,
                                       backend="cluster")
        value_p, grads_p = loss_and_grad(loss, params)
    torch.cuda.synchronize()
    errs = {k: rel_l2(grads_k[k], grads_p[k]) for k in grads_k}
    grad_err = max(errs.values())
    print(f"sphere9812 {KERNEL_DIFF_RES[0]}^2, {KERNEL_DIFF_SPP} spp, depth "
          f"{KERNEL_DIFF_DEPTH}, backend='cluster': {launches} kernel "
          f"launches for a film and a loss with its gradient; film "
          f"bit-identical to the plain intersection's "
          f"{bool(torch.equal(film_k, film_p))}, loss {float(value_k):.6e} "
          f"vs {float(value_p):.6e}, gradients' relative L2 difference "
          f"{errs} (bar {DIFF_GRAD_RTOL})", flush=True)
    check(launches == 2 * KERNEL_DIFF_DEPTH,
          f"{launches} cluster launches, not one a bounce")
    check(float(film_k.mean()) > 0.0 and torch.equal(film_k, film_p),
          "the kernel's differentiable film differs from the plain one")
    check(all(bool(torch.isfinite(g).all()) for g in grads_k.values()),
          "non-finite gradient")
    check(grad_err <= DIFF_GRAD_RTOL, f"gradients differ by {errs}")
    n0 = ck.LAUNCHES
    inverse.recover_materials(cam_s, scene_s, target_s, steps=1,
                              samples=KERNEL_DIFF_SPP,
                              depth=KERNEL_DIFF_DEPTH, backend="cluster",
                              optimize=("albedo",))
    paired = ck.LAUNCHES - n0
    print(f"one paired recovery step: {paired} cluster launches", flush=True)
    check(paired == 2 * KERNEL_DIFF_DEPTH,
          f"{paired} launches for a paired step, not 2 x depth")
    out["kernel"] = {"launches_film_and_loss": launches,
                     "launches_paired_step": paired, "grad_rel_l2": errs,
                     "loss": float(value_k), "plain_loss": float(value_p)}

    # (c) The garden: recovery steps and a gradcheck through the kernel.
    cam_g, sb = pt.meshes.mesh_garden()
    scene_g = sb.build()
    cam_g = with_res(cam_g, KERNEL_DIFF_RES)
    target_g = pt.render_film(cam_g, scene_g, GARDEN_TARGET_SPP,
                              KERNEL_DIFF_DEPTH, backend="beam").data
    t0 = time.perf_counter()
    diff.make_accel(scene_g, "cluster")
    accel_s = time.perf_counter() - t0
    ttk.LAUNCHES = ck.LAUNCHES = bk.LAUNCHES = 0
    _, out["garden"] = recovery_run(
        pt, card, f"garden105708 {KERNEL_DIFF_RES[0]}^2, {KERNEL_DIFF_SPP} "
        f"spp paired, depth {KERNEL_DIFF_DEPTH}, cluster", cam_g, scene_g,
        target_g, steps=GARDEN_DIFF_STEPS, samples=KERNEL_DIFF_SPP,
        depth=KERNEL_DIFF_DEPTH, lr=0.08, lr_end=8e-3, backend="cluster",
        optimize=("albedo",))
    per_step = ck.LAUNCHES / GARDEN_DIFF_STEPS
    check(ck.LAUNCHES == GARDEN_DIFF_STEPS * 2 * KERNEL_DIFF_DEPTH
          and ttk.LAUNCHES == bk.LAUNCHES == 0,
          f"garden recovery launched cluster {ck.LAUNCHES}, trace "
          f"{ttk.LAUNCHES}, beam {bk.LAUNCHES}")
    gc_loss = diff.make_loss(cam_g, scene_g, target_g, 2, 3,
                             backend="cluster")
    params = diff.material_params(scene_g)
    _, g = loss_and_grad(gc_loss, params)
    top = torch.argsort(g["albedo"].abs().flatten())[-2:].tolist()
    gc_abs, gc_rel = diff.gradcheck(gc_loss, params, eps=2e-2,
                                    indices=[("albedo", i) for i in top],
                                    mode="one_sided")
    print(f"garden: cluster set (cached) {accel_s:.3f} s, {per_step:g} "
          f"cluster launches a step; gradcheck of albedo {top} at 2 spp, "
          f"depth 3: abs {gc_abs:.4e}, rel {gc_rel:.4e} (bar "
          f"{GRADCHECK_BAR})", flush=True)
    check(gc_rel < GRADCHECK_BAR, f"garden gradcheck {gc_rel}")
    out["garden"].update(launches_per_step=per_step, gradcheck_rel=gc_rel,
                         gradcheck_abs=gc_abs, probes=top)

    # (d) The CI-sized Cornell recovery under its bars.
    cam, scene = pt.cornell_box(res=CI_RES)
    target = pt.render_film(cam, scene, CI_TARGET_SPP, CI_DEPTH,
                            backend="cuda").data
    mats, out["ci"] = recovery_run(
        pt, card, f"cornell {CI_RES[0]}^2, {CI_SPP} spp, depth {CI_DEPTH}",
        cam, scene, target, steps=CI_STEPS, samples=CI_SPP, depth=CI_DEPTH,
        lr=0.08, lr_end=4e-3, optimize=("albedo", "emit"))
    mtype, alb_true, emit_true, _ = scene.host_materials()
    vis = (inverse.visible_pixel_counts(cam, scene) >= 8) & (
        mtype == pt.DIFFUSE)
    check(vis.sum() >= 10, f"{vis.sum()} visible diffuse triangles")
    alb = mats["albedo"].cpu().numpy()[:scene.num_tris]
    emit = mats["emit"].cpu().numpy()[:scene.num_tris]
    alb_err = float(np.abs(alb - alb_true)[vis].mean())
    light = mtype == pt.EMIT
    emit_err = float(np.abs(emit[light] - emit_true[light]).mean())
    print(f"cornell {CI_RES[0]}^2 recovery: visible-diffuse albedo error "
          f"{alb_err:.4f}, emission error {emit_err:.4f} (bars {CI_BAR})",
          flush=True)
    check(alb_err < CI_BAR and emit_err < CI_BAR,
          f"recovery errors {alb_err}, {emit_err}")
    out["ci"].update(albedo_err=alb_err, emit_err=emit_err,
                     visible=int(vis.sum()))
    record["diff"] = out


def phase_build(record, parent_csrc=None):
    """Phase 2; returns {trace instance: (registers, stack, local stores)},
    the SASS figures of the trace kernel's triangle loops and, with
    ``parent_csrc``, the older kernels' library (built at the same time)."""
    from concurrent.futures import ThreadPoolExecutor
    from pathtracer_tpu_torch.utils import build

    print("== 2 build", flush=True)
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(build.build_library),
                pool.submit(build.build_library, checked=True)]
        if parent_csrc:
            jobs.append(pool.submit(build.build_library, parent_csrc,
                                    "libparent_large", PARENT_SOURCES))
        builds = [job.result() for job in jobs]
    built, checked = builds[0], builds.pop(1)
    build.load_library()
    print(f"built {os.path.relpath(built.path, REPO)} in "
          f"{built.seconds:.2f} s, and the checked library (phase 15) "
          f"{os.path.relpath(checked.path, REPO)} in {checked.seconds:.2f} s "
          f"beside it", flush=True)
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")

    def dump(flag, path):
        return subprocess.run([cuobjdump, flag, str(path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout

    text = dump("-sass", built.path)
    table = resource_table(dump("--dump-resource-usage", built.path), text)
    labels = {instance_label(k): v for k, v in table.items()}
    check(all(k in labels for k in LARGE_INSTANCES) and len(table) >= 10,
          f"cuobjdump reported the instances {sorted(labels)}")
    for label, (regs, stack, stl) in sorted(labels.items()):
        print(f"  {label}: {regs} registers, {stack} bytes stack frame, "
              f"{stl} local-memory stores", flush=True)
    sass = sass_triangle_loops(text)
    check(len(sass) == 4, f"SASS of {len(sass)} trace kernel instances")
    for inst, fig in sorted(sass.items()):
        print(f"  {inst} SASS: triangle loop {fig['loop_instructions']} "
              f"instructions for {fig['rows_per_trip']} rows, "
              f"{fig['instructions_per_test']:.2f} per test, "
              f"{fig['loop_calls']} calls in it; the function: "
              f"{fig['mufu']} MUFU, {fig['local_memory']} local-memory "
              f"instructions", flush=True)
    walks = sass_walk_loops(text)
    for inst, fig in sorted(walks.items()):
        print(f"  {inst} SASS: tree-walk node loop "
              f"{fig['node_loop_instructions']} instructions (two box "
              f"tests); the function: {fig['function_instructions']} "
              f"instructions, {fig['local_memory']} local-memory", flush=True)
    record["build"] = {"seconds": built.seconds, "resources": labels,
                       "sass": sass, "walk_sass": walks,
                       "checked_seconds": checked.seconds}
    parent = None
    if parent_csrc:
        older = {instance_label(k): v for k, v in resource_table(
            dump("--dump-resource-usage", builds[1].path),
            dump("-sass", builds[1].path)).items()}
        print(f"older kernels ({parent_csrc}) built in "
              f"{builds[1].seconds:.2f} s: " + "; ".join(
                  f"{k}: {r} registers, {st} bytes stack, {sp} local stores"
                  for k, (r, st, sp) in sorted(older.items())), flush=True)
        record["build"]["older_resources"] = older
        parent = parent_library(parent_csrc)
    regs = {trace_instance(k): v for k, v in table.items()
            if trace_instance(k)}
    return regs, sass, parent


def phase_parity(pt, dev, record):
    """Phase 3: both loops bit-identical to their plain versions."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

    print("== 3 kernel against its plain version (64^2, 4 spp, depth 5), "
          "both loops", flush=True)
    record["parity"] = {}
    scenes = {"corner": lambda: pt.corner_scene(res=(64, 64)),
              "cornell": lambda: pt.cornell_box(res=(64, 64)),
              "specular": lambda: pt.modified_cornell(0.3, res=(64, 64))}
    for name, make in scenes.items():
        cam, scene = make()
        for loop in ttk.LOOPS:
            got = ttk.render_sum_cuda(cam, scene, 0, 4, DEPTH, loop=loop)
            want = ttk.render_sum_reference(cam, scene, 0, 4, DEPTH,
                                            loop=loop)
            torch.cuda.synchronize()
            max_abs, _ = film_diff(got / 4, want / 4)
            print(f"{name} {loop}: max abs diff {max_abs:.3e}, mean "
                  f"{float(got.mean()) / 4:.5f}", flush=True)
            check(float(got.mean()) > 0.0, f"{name} {loop}: black film")
            check(torch.equal(got, want),
                  f"{name} {loop}: not bit-identical to the plain version")
            record["parity"][f"{name} {loop}"] = {"max_abs": max_abs}

    cam, scene = pt.modified_cornell(0.3, res=(64, 48))
    for loop in ttk.LOOPS:
        full = ttk.render_sum_cuda(cam, scene, 0, 4, DEPTH, loop=loop)
        band = ttk.render_sum_cuda(cam, scene, 0, 4, DEPTH, h0=17, band_h=13,
                                   loop=loop)
        split = (ttk.render_sum_cuda(cam, scene, 0, 1, DEPTH, loop=loop)
                 + ttk.render_sum_cuda(cam, scene, 1, 3, DEPTH, loop=loop))
        torch.cuda.synchronize()
        check(torch.equal(band, full[17:30]),
              f"{loop}: band launch differs from the same rows of the full "
              f"launch")
        window = float((split - full).abs().max())
        check(window <= WINDOW_ATOL,
              f"{loop}: two windows differ from one by {window}")
        print(f"{loop}: band rows [17, 30) bit-identical; window split max "
              f"diff {window:.3e}", flush=True)
    sb = pt.SceneBuilder()
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                    pt.HostMaterial(pt.DIFFUSE, color=(1, 1, 1),
                                    emit=(1, 0, 0)))
    try:
        ttk.render_sum_cuda(cam, sb.build(), 0, 1, 1)
    except ValueError as e:
        print(f"emission check raised: {e}", flush=True)
    else:
        raise RuntimeError("chip_smoke: emissive non-EMIT scene accepted")


def phase_main(pt, dev, record):
    """Phase 4; returns the default loop's launches on the main path."""
    import torch
    from pathtracer_tpu_torch.camera import get_rays
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
    from pathtracer_tpu_torch.ops.intersect import intersect_brute

    print(f"== 4 main path: render(cornell_box {MAIN_RES[0]}x{MAIN_RES[1]}, "
          f"{MAIN_SPP} spp, depth {DEPTH}, backend='auto')", flush=True)
    cam, scene = pt.cornell_box(res=MAIN_RES)
    png = os.path.join(OUT_DIR, "chip_smoke_cornell1024.png")
    ttk.LAUNCHES = 0
    ttk.LOOP_LAUNCHES.update({loop: 0 for loop in ttk.LOOPS})
    t0 = time.perf_counter()
    film = pt.render(cam, scene, samples=MAIN_SPP, depth=DEPTH, filename=png)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = ttk.LOOP_LAUNCHES[ttk.DEFAULT_LOOP]
    check(launches > 0 and launches == ttk.LAUNCHES,
          f"the main path launched {dict(ttk.LOOP_LAUNCHES)}, not the "
          f"default loop {ttk.DEFAULT_LOOP!r}")
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
    print(f"{launches} launches of the {ttk.DEFAULT_LOOP!r} loop, "
          f"{main_s:.3f} s wall for the render call, gamma-space mean "
          f"{mean:.4f}, brightest pixel ({bw}, {bh}) sees the light "
          f"(triangle {tid})", flush=True)
    kern = pt.render_film(cam, scene, CHECK_SPP, DEPTH, backend="cuda").data
    brute = pt.render_film(cam, scene, CHECK_SPP, DEPTH, backend="brute").data
    torch.cuda.synchronize()
    main_err, main_share = film_diff(kern, brute)
    print(f"against backend='brute' at {CHECK_SPP} spp: max abs diff "
          f"{main_err:.3e}, pixels beyond {FILM_ATOL}: {main_share:.4%}",
          flush=True)
    check(main_share <= MAX_FLIP_SHARE,
          f"main path: {main_share:.4%} of pixels beyond {FILM_ATOL}")
    record["main"] = {"launches": launches, "loop": ttk.DEFAULT_LOOP,
                      "seconds": main_s, "gamma_mean": mean,
                      "brightest": [bw, bh], "brute_max_abs": main_err,
                      "brute_share": main_share}
    return launches


def issue_rate():
    """Thread-instructions the card can issue per second: SMs x 4
    schedulers x 32 lanes x the maximum SM clock (nvidia-smi)."""
    import torch
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 4 * 32 * float(mhz) * 1e6, sms, float(mhz)


def phase_trace_timing(pt, card, regs, sass, record):
    """Phase 5; returns {"ms", "plain_ms", "bound_ms", "max_abs"} of the
    default loop on cornell1024, the main path's launch shape."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
    from pathtracer_tpu_torch.ops import intersect as tisect
    from pathtracer_tpu_torch.utils.timer import device_ms

    print(f"== 5 trace kernel at {MAIN_RES[0]}x{MAIN_RES[1]}, {TIME_SPP} "
          f"spp, depth {DEPTH}, both loops", flush=True)
    rate, sms, mhz = issue_rate()
    print(f"issue rate {rate:.4e} thread-instructions/s ({sms} SMs x 4 x 32 "
          f"x {mhz:.0f} MHz)", flush=True)
    scenes = {"cornell1024": lambda: pt.cornell_box(res=MAIN_RES),
              "specular1024": lambda: pt.modified_cornell(0.05,
                                                          res=MAIN_RES)}
    out, main = {}, None
    for name, make in scenes.items():
        cam, scene = make()
        paths = MAIN_RES[0] * MAIN_RES[1] * TIME_SPP
        live = ttk.count_live_segments(cam, scene, 0, TIME_SPP, DEPTH)
        ops = ttk.count_ops(scene, live, paths)
        bound = bound_ms(ops)
        print(f"{name}: {scene.num_tris} triangles, {live} live ray "
              f"segments of {paths * DEPTH} nominal ({live / paths:.4f} per "
              f"path, {ttk.DEFAULT_LOOP!r} loop), {ops:.4e} operations "
              f"(Plucker: {tisect.PLUCKER_PRIMARY_OPS} per test at bounce 0, "
              f"{tisect.PLUCKER_OPS} later, {tisect.MOMENT_OPS} a segment "
              f"for o x d), bound {bound:.4f} ms at {FP32_OPS_PER_S:.3g} "
              f"op/s", flush=True)
        out[name] = {"triangles": scene.num_tris, "live_segments": live,
                     "paths": paths, "ops": ops, "bound_ms": bound}
        for loop in ttk.LOOPS:
            res = {}
            plain_ms, plain_all = device_ms(lambda: res.__setitem__(
                "p", ttk.render_sum_reference(cam, scene, 0, TIME_SPP, DEPTH,
                                              loop=loop)), calls=1)
            ms, runs = device_ms(lambda: res.__setitem__(
                "k", ttk.render_sum_cuda(cam, scene, 0, TIME_SPP, DEPTH,
                                         loop=loop)), calls=KERNEL_CALLS)
            max_abs, _ = film_diff(res["k"] / TIME_SPP, res["p"] / TIME_SPP)
            check(torch.equal(res["k"], res["p"]),
                  f"{name} {loop}: not bit-identical at the timing shape")
            inst = f"{loop}/{'specular' if scene.has_specular else 'diffuse'}"
            per_test = sass[inst]["instructions_per_test"]
            issue_ms = live * scene.num_tris * per_test / rate * 1e3
            r, stack, stl = regs[inst]
            print(f"{card}: {name} {loop}: kernel {ms:.4f} ms (runs "
                  f"{runs}), plain version {plain_ms:.3f} ms (runs "
                  f"{plain_all}), bit-identical; {bound / ms:.2%} of the "
                  f"bound; the triangle loop's issue slots alone "
                  f"{issue_ms:.4f} ms ({per_test:.2f} instructions per "
                  f"test); {r} registers, {stack} bytes stack, {stl} "
                  f"local stores", flush=True)
            out[name][loop] = {"ms": ms, "runs": runs, "plain_ms": plain_ms,
                               "plain_runs": plain_all, "max_abs": max_abs,
                               "share_of_bound": bound / ms,
                               "issue_ms": issue_ms,
                               "instructions_per_test": per_test,
                               "registers": r, "stack": stack,
                               "local_stores": stl}
            if name == "cornell1024" and loop == ttk.DEFAULT_LOOP:
                main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "max_abs": max_abs}

    for name, make, png in (
            ("refconfig", lambda: pt.cornell_box(res=MAIN_RES),
             "chip_smoke_refconfig.png"),
            ("specular1024", lambda: pt.modified_cornell(0.05, res=MAIN_RES),
             "chip_smoke_specular1024.png")):
        cam, scene = make()
        t0 = time.perf_counter()
        film = pt.render(cam, scene, samples=REF_SPP, depth=DEPTH,
                         filename=os.path.join(OUT_DIR, png), verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(bool(torch.isfinite(film.data).all())
              and float(film.data.mean()) > 0.01, f"{name}: bad film")
        print(f"{card}: {name} render(): {REF_SPP} spp, depth {DEPTH}, "
              f"{seconds:.3f} s wall (the reference: {REF_BARS[name]:.0f} s)",
              flush=True)
        out[f"{name} render"] = {"spp": REF_SPP, "seconds": seconds,
                                 "reference_s": REF_BARS[name]}
    record["trace_timing"] = out
    return main


def shard_worker(rank, world, store, work):
    """One rank of phase 11 (spawned; joins the group through ``file://``).
    Drives the sharded entry points with the launch counts set to 0 just
    before each render and read just after, and saves its films,
    parameters and times to ``work`` for the parent to check."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch import inverse
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
    from pathtracer_tpu_torch.parallel import (
        distributed, make_mesh, make_sharded_train_step,
        render_film_sharded_beam, render_film_sharded_cuda)

    dev = distributed.initialize(f"file://{store}", world, rank,
                                 timeout=SHARD_TIMEOUT // 2)
    out = {"rank": rank, "backend": dist.get_backend(), "device": str(dev)}
    meshes = {split: make_mesh(tile=split[0], sample=split[1])
              for split in SHARD_SPLITS}

    def drive(name, render, module):
        module.LAUNCHES = 0
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = render()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        torch.save(film.data.cpu(), os.path.join(work, f"{name}_{rank}.pt"))
        out[name] = {"seconds": seconds, "launches": module.LAUNCHES}

    cam, scene = pt.cornell_box(res=MAIN_RES)
    render_film_sharded_cuda(meshes[(2, 1)], cam, scene, TIME_SPP, DEPTH)
    for split, mesh in meshes.items():
        drive(f"cornell_{split[0]}x{split[1]}", lambda: (
            render_film_sharded_cuda(mesh, cam, scene, MAIN_SPP, DEPTH)), ttk)

    cam_g, sb = pt.meshes.mesh_garden()
    cam_g, garden = with_res(cam_g, LARGE_RES), sb.build()
    t0 = time.perf_counter()
    bk._accel_for(garden)
    out["garden_accel_seconds"] = time.perf_counter() - t0
    render_film_sharded_beam(meshes[(2, 1)], cam_g, garden, 2, DEPTH)
    for split, mesh in meshes.items():
        spp = SHARD_GARDEN_SPP if split[1] == 1 else SHARD_GARDEN_SAMPLE_SPP
        drive(f"garden_{split[0]}x{split[1]}", lambda: (
            render_film_sharded_beam(mesh, cam_g, garden, spp, DEPTH)), bk)

    cam_t, scene_t = pt.cornell_box(res=DIFF_RES)
    target = torch.load(os.path.join(work, "target.pt")).to(dev)
    step, init = make_sharded_train_step(
        meshes[(2, 1)], cam_t, scene_t, target, DIFF_SPP, DEPTH,
        param_transform=inverse.to_materials)
    params = inverse.init_params(scene_t)
    opt = init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for k in range(SHARD_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, k)
        losses.append(float(loss))          # waits for the device
        times.append(time.perf_counter() - t0)
        torch.save({n: p.detach().cpu() for n, p in params.items()},
                   os.path.join(work, f"train{k}_{rank}.pt"))
    out["train"] = {"step_seconds": times, "losses": losses,
                    "peak_bytes": torch.cuda.max_memory_allocated()}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def max_rel(got, want):
    """Largest |got - want| / |want| over the film; a pixel where ``want``
    is 0 must be 0."""
    import torch
    zero = want == 0
    check(bool((got[zero] == 0).all()), "nonzero where the reference is 0")
    return float(((got - want).abs()[~zero] / want.abs()[~zero]).max())


def phase_sharded(pt, dev, card, record):
    """Phase 11: the sharded entry points on two gloo ranks sharing the
    card, against one process."""
    import shutil
    import torch
    import torch.multiprocessing as mp
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    import numpy as np
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

    print(f"== 11 sharded renders and training: {SHARD_RANKS} gloo ranks "
          f"on one card (tile x sample splits {SHARD_SPLITS})", flush=True)
    work = os.path.join(OUT_DIR, "sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = fn()
        torch.cuda.synchronize()
        return film, time.perf_counter() - t0

    # One process: the films and window sums the ranks must reproduce.
    cam, scene = pt.cornell_box(res=MAIN_RES)
    pt.render_film(cam, scene, TIME_SPP, DEPTH, backend="cuda")
    half = MAIN_SPP // 2
    ref, single_s = {}, {}
    ref["cornell_2x1"], single_s["cornell"] = timed(lambda: pt.render_film(
        cam, scene, MAIN_SPP, DEPTH, backend="cuda").data)
    ref["cornell_1x2"] = (ttk.render_sum_cuda(cam, scene, 0, half, DEPTH)
                          + ttk.render_sum_cuda(cam, scene, half, half,
                                                DEPTH)) / MAIN_SPP
    cam_g, sb = pt.meshes.mesh_garden()
    cam_g, garden = with_res(cam_g, LARGE_RES), sb.build()
    pt.render_film(cam_g, garden, 2, DEPTH, backend="beam")
    ref["garden_2x1"], single_s["garden"] = timed(lambda: pt.render_film(
        cam_g, garden, SHARD_GARDEN_SPP, DEPTH, backend="beam").data)
    spp_g, half_g = SHARD_GARDEN_SAMPLE_SPP, SHARD_GARDEN_SAMPLE_SPP // 2
    ref["garden_24"], single_s["garden_24"] = timed(lambda: pt.render_film(
        cam_g, garden, spp_g, DEPTH, backend="beam").data)
    ref["garden_1x2"] = bk._to_raster(
        bk.render_tiles_beam(cam_g, garden, 0, half_g, DEPTH)
        + bk.render_tiles_beam(cam_g, garden, half_g, half_g, DEPTH),
        *LARGE_RES) / spp_g
    cam_t, scene_t = pt.cornell_box(res=DIFF_RES)
    torch.save(pt.render_film(cam_t, scene_t, DIFF_TARGET_SPP, DEPTH,
                              backend="cuda").data.cpu(),
               os.path.join(work, "target.pt"))
    del cam, scene, garden, sb
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ctx = mp.start_processes(
        shard_worker, args=(SHARD_RANKS, os.path.join(work, "rendezvous"),
                            work),
        nprocs=SHARD_RANKS, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):      # raises if a rank failed
            check(time.perf_counter() - t0 < SHARD_TIMEOUT,
                  f"the ranks did not finish in {SHARD_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"{SHARD_RANKS} ranks ran in {ranks_s:.1f} s (spawn, start-up "
          f"and garden accel build of {ranks[0]['garden_accel_seconds']:.1f}"
          f" s included); initialize chose backend "
          f"{[r['backend'] for r in ranks]} on {[r['device'] for r in ranks]}"
          f"; the ranks share one card, so no speed-up can show: the phase "
          f"checks the collectives and the window arithmetic", flush=True)
    check(all(r["backend"] == "gloo" for r in ranks),
          "initialize must choose gloo for two ranks on one card")
    out = {"ranks_seconds": ranks_s, "single_seconds": single_s,
           "ranks": ranks}

    def load(name, r):
        return torch.load(os.path.join(work, f"{name}_{r}.pt")).to(dev)

    for scene_name, module, key in (("cornell", ttk, "trace"),
                                    ("garden", bk, "beam")):
        for tile, sample in SHARD_SPLITS:
            name = f"{scene_name}_{tile}x{sample}"
            films = [load(name, r) for r in range(SHARD_RANKS)]
            check(all(torch.equal(f, films[0]) for f in films),
                  f"{name}: the ranks' films differ")
            check(bool(torch.isfinite(films[0]).all())
                  and float(films[0].mean()) > 0, f"{name}: bad film")
            check(torch.equal(films[0], ref[name]),
                  f"{name}: not bit-identical to one process")
            launches = [r[name]["launches"] for r in ranks]
            check(all(n > 0 for n in launches),
                  f"{name}: a rank launched no {key} kernel ({launches})")
            line = {"seconds": [r[name]["seconds"] for r in ranks],
                    f"{key}_launches": launches}
            if sample == 1:
                what = "bit-identical to one process's render_film"
                single = single_s[scene_name]
            else:
                full = (ref["cornell_2x1"] if scene_name == "cornell"
                        else ref["garden_24"])
                rel = max_rel(films[0], full)
                check(rel <= SHARD_RTOL, f"{name}: relative difference "
                      f"{rel} from one process's film")
                line["max_rel"] = rel
                what = (f"bit-identical to one process's two windows, "
                        f"max relative difference {rel:.3e} from its film")
                single = single_s[scene_name if scene_name == "cornell"
                                  else "garden_24"]
            print(f"{card}: {name}: {what}; wall {max(line['seconds']):.4f}"
                  f" s (ranks {[round(t, 4) for t in line['seconds']]}) "
                  f"against one process's {single:.4f} s; {key} launches "
                  f"per rank {launches}", flush=True)
            out[name] = line

    losses = [r["train"]["losses"] for r in ranks]
    check(all(np.isfinite(x).all() for x in losses)
          and all(x == losses[0] for x in losses),
          f"train step losses {losses}")
    for k in range(SHARD_TRAIN_STEPS):
        params = [torch.load(os.path.join(work, f"train{k}_{r}.pt"))
                  for r in range(SHARD_RANKS)]
        for name in params[0]:
            check(all(torch.equal(p[name], params[0][name]) for p in params),
                  f"train step {k}: {name} differs between the ranks")
    for r in ranks:
        t = r["train"]
        print(f"{card}: train step (cornell {DIFF_RES[0]}^2, {DIFF_SPP} "
              f"spp, depth {DEPTH}, tile split) rank {r['rank']}: seconds "
              f"a step {[round(x, 4) for x in t['step_seconds']]}, peak "
              f"device memory {t['peak_bytes'] / 2**30:.3f} GiB, losses "
              f"{[f'{x:.4e}' for x in t['losses']]}", flush=True)
    print(f"train step: parameters bit-identical on the {SHARD_RANKS} ranks "
          f"after each of {SHARD_TRAIN_STEPS} steps", flush=True)
    record["sharded"] = out


def brightest_sees_light(pt, cam, scene, img_u8, ties=False):
    """(w, h) of the first brightest pixel of a PNG read back (rows top
    first); raises unless its centre ray hits an EMIT triangle.  With
    ``ties``, every pixel at the brightest value is a candidate and one
    of them must see the light: in a box of glossy walls the light's
    reflections saturate as the light does."""
    import numpy as np
    import torch
    from pathtracer_tpu_torch.camera import get_rays
    from pathtracer_tpu_torch.ops.intersect import intersect_brute

    lum = img_u8.astype(np.float32).mean(axis=-1)[::-1]    # film rows
    if ties:
        hs, ws = np.nonzero(lum == lum.max())
    else:
        hs, ws = np.divmod([int(np.argmax(lum))], lum.shape[1])
    dev = scene.device
    tids = []
    for k in range(0, len(hs), 1 << 16):
        w = torch.from_numpy(ws[k:k + (1 << 16)]).to(dev)
        h = torch.from_numpy(hs[k:k + (1 << 16)]).to(dev)
        half = torch.full(w.shape, 0.5, device=dev)
        o, d = get_rays(cam, w, h, half, half)
        tids.append(intersect_brute(o, d, scene.v1, scene.v2, scene.v3)[1])
    tid = torch.cat(tids).long()
    sees = (tid >= 0) & (scene.mat_type[tid.clamp_min(0)] == pt.EMIT)
    first = int(sees.int().argmax()) if bool(sees.any()) else 0
    bw, bh = int(ws[first]), int(hs[first])
    check(bool(sees[first]),
          f"brightest pixel ({bw}, {bh}) sees triangle {int(tid[0])}, not "
          f"the light" + (f" (nor does any of the {len(hs)} as bright)"
                          if ties else ""))
    return bw, bh, float(lum[bh, bw])


def phase_realtime_cli(pt, dev, card, record):
    """Phase 12: the realtime session and the CLI through the kernels."""
    import io
    import statistics
    import numpy as np
    import torch
    from pathtracer_tpu_torch import cli
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
    from pathtracer_tpu_torch.realtime import RealtimeSession

    print(f"== 12 realtime session ({REALTIME_RES[0]}^2, {REALTIME_SPP} spp "
          f"a frame, {REALTIME_FRAMES} frames) and CLI", flush=True)
    out = {}
    cam_c, cornell = pt.cornell_box(res=REALTIME_RES)
    cam_g, sb = pt.meshes.mesh_garden()
    sessions = {"cornell": (cam_c, cornell, "cuda", ttk),
                "garden105708": (with_res(cam_g, REALTIME_RES), sb.build(),
                                 "beam", bk)}
    for name, (cam, scene, backend, module) in sessions.items():
        sess = RealtimeSession(cam, scene, depth=DEPTH,
                               frame_samples=REALTIME_SPP)
        check(sess.backend == backend,
              f"{name}: session backend {sess.backend!r}, not {backend!r}")
        module.LAUNCHES = 0
        times = []
        for _ in range(REALTIME_FRAMES):
            t0 = time.perf_counter()
            img = sess.step()                  # ends in a host copy
            times.append(time.perf_counter() - t0)
        launches = module.LAUNCHES
        check(launches > 0, f"{name}: the session launched no kernel")
        check(img.shape == (REALTIME_RES[1], REALTIME_RES[0], 3)
              and np.isfinite(img).all() and img.mean() > 0,
              f"{name}: bad frame")
        want = torch.zeros_like(sess._accum)
        for k in range(REALTIME_FRAMES):
            cur = pt.render_film(cam, scene, REALTIME_SPP, DEPTH, seed=1 + k,
                                 backend=backend).data
            t = 1.0 / (k + 1)
            want = want * (1.0 - t) + cur * t
        check(torch.equal(sess._accum, want),
              f"{name}: the accumulated film is not the running mean")
        sess.key("w")
        check(sess.frame == 0 and not bool(sess._accum.any()),
              f"{name}: 'w' did not reset the accumulation")
        med = statistics.median(times)
        # Each render_film call keys its kernel inputs by the scene's byte
        # fingerprint (a SHA-1 over the host arrays): its share of a frame.
        hashes = []
        for _ in range(3):
            t0 = time.perf_counter()
            scene.fingerprint()
            hashes.append(time.perf_counter() - t0)
        print(f"{card}: realtime {name}: backend {backend!r}, {launches} "
              f"launches in {REALTIME_FRAMES} frames, ms a frame "
              f"{[round(t * 1e3, 3) for t in times]} (median "
              f"{med * 1e3:.3f}); film = running mean of the frames, bit "
              f"for bit; 'w' resets to frame 0; one fingerprint of the "
              f"scene {statistics.median(hashes) * 1e3:.3f} ms (host)",
              flush=True)
        out[f"realtime {name}"] = {"backend": backend, "launches": launches,
                                   "frame_seconds": times,
                                   "fingerprint_seconds": hashes}

    png = os.path.join(OUT_DIR, "chip_smoke_cli_cornell256.png")
    ttk.LAUNCHES = 0
    cli.main(["render", "cornell", png, "--res", str(CLI_RES), "--spp",
              str(CLI_SPP), "--backend", "cuda"])
    launches = ttk.LAUNCHES
    check(launches > 0, "cli render launched no trace kernel")
    img = pt.read_png(png)
    check(img.shape == (CLI_RES, CLI_RES, 3), f"cli png {img.shape}")
    cam, scene = pt.cornell_box(res=(CLI_RES, CLI_RES))
    bw, bh, lum = brightest_sees_light(pt, cam, scene, img)
    print(f"cli render: {png} ({launches} trace launches), brightest pixel "
          f"({bw}, {bh}) at {lum:.1f} sees the light", flush=True)

    buf = io.StringIO()
    ttk.LAUNCHES = 0
    with contextlib.redirect_stdout(buf):
        cli.main(["bench", "--res", str(BENCH_RES), "--spp",
                  str(BENCH_SPP)])
    line = buf.getvalue().strip().splitlines()[-1]
    bench = json.loads(line)
    check(bench["backend"] == "cuda" and bench["rays_per_sec"] > 0
          and bench["card"] == torch.cuda.get_device_name(0)
          and ttk.LAUNCHES > 0, f"cli bench line {line}")
    print(f"{card}: cli bench: {line}", flush=True)
    out["cli"] = {"render_launches": launches, "brightest": [bw, bh],
                  "bench": bench, "bench_launches": ttk.LAUNCHES}
    record["realtime_cli"] = out


def wavefront_counts(wf, ck, bk, ttk, reset=False):
    """{counter: value} of the wavefront's and the kernels' counters;
    ``reset`` sets them all to 0 first."""
    mods = {"cluster_launches": (ck, "LAUNCHES"),
            "beam_launches": (bk, "LAUNCHES"),
            "trace_launches": (ttk, "LAUNCHES"),
            "syncs": (wf, "SYNCS"), "live_bounces": (wf, "LIVE_BOUNCES"),
            "skipped": (wf, "SKIPPED")}
    if reset:
        for mod, name in mods.values():
            setattr(mod, name, 0)
    return {k: getattr(mod, name) for k, (mod, name) in mods.items()}


def time_wavefront_cell(card, label, fn, segments, depth, record_shares):
    """One untimed run of ``fn`` (recording the share of rays alive after
    each bounce stage of block 0), then WF_RUNS host-clock runs ended by
    torch.cuda.synchronize: the median wall, the ray segments/s, the
    counters of one run and the peak device memory."""
    import statistics
    import torch
    from pathtracer_tpu_torch.ops import wavefront as wf
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

    shares = []
    if record_shares:
        stage = wf.bounce_stage

        def recorded(*args, **kw):
            contrib, queue = stage(*args, **kw)
            shares.append(queue["alive"].float().mean())
            return contrib, queue

        with swapped(wf, "bounce_stage", recorded):
            first = fn()
    else:
        first = fn()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(first).all()) and float(first.mean()) > 0,
          f"{label}: non-finite or black film")
    # Block 0's stages: the first ``depth``, or up to its emptied queue.
    block0 = []
    for x in shares:
        block0.append(round(float(x), 4))
        if len(block0) == depth or block0[-1] == 0.0:
            break
    wavefront_counts(wf, ck, bk, ttk, reset=True)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(WF_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = {k: v / WF_RUNS for k, v in wavefront_counts(
        wf, ck, bk, ttk).items()}
    peak = torch.cuda.max_memory_allocated()
    wall = statistics.median(walls)
    out = {"wall_s": wall, "runs_s": walls, "segments_per_s":
           segments / wall, "counts_per_run": counts, "peak_bytes": peak,
           "alive_after_bounce_block0": block0}
    nonzero = ", ".join(f"{k} {v:g}" for k, v in counts.items() if v)
    print(f"{card}: {label}: {wall * 1e3:.2f} ms wall (runs "
          f"{[round(x * 1e3, 2) for x in walls]} ms), "
          f"{segments / wall:.4e} ray segments/s; a run: {nonzero or 'none'}; "
          f"peak {peak / 2**30:.3f} GiB"
          + (f"; alive after each bounce of block 0: {block0}"
             if block0 else ""),
          flush=True)
    return out


def profile_render(card, label, fn):
    """One run of ``fn`` under torch.profiler: the wall, the device busy
    share, the device launches and the device time of the kernel
    families (names cut to 60 characters: the instances of one template
    fall into one family)."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # The device's own events: the host-side operators carry their
    # kernels' device time too, and would count it twice.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    families = collections.Counter()
    for e in events:
        families[e.key[:60]] += e.self_device_time_total
    out = {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
           "device_busy_share": device_us / wall_us,
           "device_launches": sum(e.count for e in events),
           "top_ms": {k: us / 1e3 for k, us in families.most_common(6)}}
    top = "; ".join(f"{k} {v:.2f}" for k, v in out["top_ms"].items())
    print(f"{card}: {label} under torch.profiler: {out['wall_ms']:.2f} ms "
          f"wall, device busy {out['device_ms']:.2f} ms "
          f"({out['device_busy_share']:.2%}), {out['device_launches']} "
          f"device launches; top kernel families (ms): {top}", flush=True)
    return out


def phase_wavefront(pt, dev, card, record):
    """Phase 13: the wavefront pipeline (ops/wavefront.py) on the card."""
    import torch
    from pathtracer_tpu_torch.ops import wavefront as wf
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

    print("== 13 wavefront pipeline", flush=True)
    out = {"parity": {}}
    # (a) Parity on the card.
    for name, make in (("cornell", lambda: pt.cornell_box(res=WF_RES)),
                       ("specular", lambda: pt.modified_cornell(
                           0.05, res=WF_RES))):
        cam, scene = make()
        film = pt.render_film(cam, scene, WF_SPP, DEPTH,
                              backend="wavefront").data
        again = wf.render_wavefront(cam, scene, WF_SPP, DEPTH,
                                    backend="brute")
        compacted = wf.render_wavefront(cam, scene, WF_SPP, DEPTH,
                                        backend="brute", compact_every=1)
        brute = pt.render_film(cam, scene, WF_SPP, DEPTH,
                               backend="brute").data
        kern = pt.render_film(cam, scene, WF_SPP, DEPTH,
                              backend="cuda").data
        torch.cuda.synchronize()
        brute_err = float((film - brute).abs().max())
        kern_err, kern_share = film_diff(film, kern)
        print(f"{name} {WF_RES[0]}^2, {WF_SPP} spp, depth {DEPTH}, brute: "
              f"against render_film brute max abs {brute_err:.3e} (bar "
              f"{WF_ATOL}); against backend='cuda' max abs {kern_err:.3e}, "
              f"pixels beyond {FILM_ATOL}: {kern_share:.4%}; two runs "
              f"bit-identical: {torch.equal(film, again)}; compact_every=1 "
              f"bit-identical: {torch.equal(film, compacted)}", flush=True)
        check(float(film.mean()) > 0, f"wavefront {name}: black film")
        check(brute_err <= WF_ATOL,
              f"wavefront {name}: {brute_err} from render_film brute")
        check(kern_share <= MAX_FLIP_SHARE,
              f"wavefront {name}: {kern_share:.4%} of pixels from the "
              f"kernel's film")
        check(torch.equal(film, again), f"wavefront {name}: two runs differ")
        check(torch.equal(film, compacted),
              f"wavefront {name}: compact_every=1 differs from 0")
        out["parity"][name] = {"brute_max_abs": brute_err,
                               "cuda_max_abs": kern_err,
                               "cuda_share": kern_share}

    # (b) The cluster kernel on this path, counted from 0.
    _, sb = pt.meshes.sphere_in_box(50, 100)
    sphere = sb.build()
    cam = lit_sphere_camera(pt, WF_CLUSTER_RES)
    counts = wavefront_counts(wf, ck, bk, ttk, reset=True)
    film = wf.render_wavefront(cam, sphere, WF_SPP, DEPTH)
    torch.cuda.synchronize()
    counts = wavefront_counts(wf, ck, bk, ttk)
    check(counts["cluster_launches"] > 0
          and counts["cluster_launches"] == counts["live_bounces"],
          f"wavefront sphere9812 (auto): {counts}, not one cluster launch "
          f"a live bounce")
    with swapped(ck, "intersect_clusters",
                 lambda o, d, cs: ck.intersect_clusters_reference(o, d, cs)):
        plain = wf.render_wavefront(cam, sphere, WF_SPP, DEPTH,
                                    backend="cluster")
    tile = pt.render_film(cam, sphere, WF_SPP, DEPTH,
                          backend="cluster").data
    torch.cuda.synchronize()
    tile_err, tile_share = film_diff(film, tile)
    print(f"wavefront main path: sphere9812 ({sphere.num_tris} triangles) "
          f"{WF_CLUSTER_RES[0]}^2, {WF_SPP} spp, depth {DEPTH}, "
          f"backend='auto': {counts['cluster_launches']} cluster launches, "
          f"{counts['live_bounces']} live bounces, {counts['syncs']} syncs, "
          f"{counts['skipped']} skipped; bit-identical to the plain "
          f"intersector: {torch.equal(film, plain)}; against render_film "
          f"cluster max abs {tile_err:.3e}, pixels beyond {FILM_ATOL}: "
          f"{tile_share:.4%}", flush=True)
    check(float(film.mean()) > 0, "wavefront sphere9812: black film")
    check(torch.equal(film, plain),
          "wavefront sphere9812: kernel film differs from the plain one")
    check(tile_share <= MAX_FLIP_SHARE,
          f"wavefront sphere9812: {tile_share:.4%} of pixels from "
          f"render_film cluster")
    out["main"] = {"counts": counts, "tile_max_abs": tile_err,
                   "tile_share": tile_share}

    # (c) Timing against the megakernel and the large-scene backends.
    cells = {}
    cam, cornell = pt.cornell_box(res=WF_TIME_RES)
    npix = WF_TIME_RES[0] * WF_TIME_RES[1]
    for depth in WF_DEPTHS:
        segs = npix * WF_TIME_SPP * depth
        runs = (
            ("wavefront auto (brute)", True, lambda d=depth: pt.render_film(
                cam, cornell, WF_TIME_SPP, d, backend="wavefront").data),
            ("wavefront cluster", True, lambda d=depth: wf.render_wavefront(
                cam, cornell, WF_TIME_SPP, d, backend="cluster")),
            ("wavefront cluster, compact_every=1", True,
             lambda d=depth: wf.render_wavefront(
                 cam, cornell, WF_TIME_SPP, d, backend="cluster",
                 compact_every=1)),
            ("megakernel (render_film cuda)", False,
             lambda d=depth: pt.render_film(cam, cornell, WF_TIME_SPP, d,
                                            backend="cuda").data))
        for label, shares, fn in runs:
            key = f"cornell512 {WF_TIME_SPP} spp depth {depth}: {label}"
            cells[key] = time_wavefront_cell(card, key, fn, segs, depth,
                                             shares)
        key = f"cornell512 {WF_TIME_SPP} spp depth {depth}: wavefront cluster"
        cells[key]["profile"] = profile_render(card, key, runs[1][2])
    cam = with_res(pt.meshes.sphere_in_box(50, 100)[0], WF_TIME_RES)
    segs = npix * WF_SPHERE_SPP * DEPTH
    for label, shares, fn in (
            ("wavefront cluster", True, lambda: wf.render_wavefront(
                cam, sphere, WF_SPHERE_SPP, DEPTH, backend="cluster")),
            ("render_film beam", False, lambda: pt.render_film(
                cam, sphere, WF_SPHERE_SPP, DEPTH, backend="beam").data),
            ("render_film cluster", False, lambda: pt.render_film(
                cam, sphere, WF_SPHERE_SPP, DEPTH, backend="cluster").data)):
        key = f"sphere9812 {WF_SPHERE_SPP} spp depth {DEPTH}: {label}"
        cells[key] = time_wavefront_cell(card, key, fn, segs, DEPTH,
                                         shares)
    out["cells"] = cells
    record["wavefront"] = out


def bench_verdict(cells):
    """(cells with a failed check that is held: [(cell, sorted failed
    checks)], beam cells whose golden bar on their own film is reported,
    not held) of bench_torch.py's cell lines.  Every check is held but
    that one, and only while the cell's converged golden check holds:
    the beam's tiles share their bounces, so at the cell's samples its
    film's mean moves by more than the 2% bar from seed to seed."""
    failed, reported = [], []
    for c in cells:
        bad = {k for k, ok in c["checks"].items() if not ok}
        if (c["backend"] == "beam" and bad == {"golden"}
                and c["checks"].get("golden_converged")):
            reported.append(c["cell"])
        elif bad:
            failed.append((c["cell"], sorted(bad)))
    return failed, reported


def phase_bench(pt, dev, card, record):
    """Phase 14: bench_torch.py over every cell, one timed run each, in a
    process of its own; its --out lines are parsed and every check of
    every cell must hold but a beam cell's golden bar on its own film,
    which is reported (bench_verdict); bench_torch.py leaves that cell
    failing and exits 1 for it."""
    path = os.path.join(OUT_DIR, "bench_torch.json")
    if os.path.exists(path):
        os.unlink(path)
    print("== 14 bench_torch.py, every cell, one timed run each",
          flush=True)
    rc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--repeats",
         "1", "--refconfig-repeats", "1", "--out", path],
        stdout=subprocess.DEVNULL, timeout=900).returncode
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    cells = lines[:-1]
    for c in cells:
        print(f"{card}: {c['cell']}: {c['metric']} {c['value']:.4e} "
              f"rays/s, {c['timing']['seconds'][0]:.3f} s, kernel "
              f"{c['kernel_ms']} ms a launch, launches a run "
              f"{c['launches'][c['kernel']]:g}; correct {c['correct']} "
              f"{c['checks']}", flush=True)
        for g in ("golden", "golden_converged"):
            if c.get(g):
                print(f"  {g}: {c[g].get('spp', c['spp'])} spp, linear "
                      f"mean {c[g]['linear_mean']:.6f} vs the committed "
                      f"{c[g]['golden_mean']:.6f} ({c[g]['rel_err']:+.2%}, "
                      f"bar {GOLDEN_MEAN_RTOL:.0%})", flush=True)
    failed, reported = bench_verdict(cells)
    for name in reported:
        print(f"  {name}: the golden bar on the cell's own film fails and "
              f"is reported; its converged render holds it", flush=True)
    check(len(cells) == 8 and len({c["cell"] for c in cells}) == 8,
          f"bench cells {[c['cell'] for c in cells]}: not bench.py's eight")
    check(not failed, f"benchmark checks failed: {failed}; notes: "
          + "; ".join(f"{c['cell']} {c.get('notes')}" for c in cells
                      if not c["correct"]))
    check(rc == (1 if reported else 0), f"bench_torch.py exited {rc}")
    record["bench"] = lines[-1]
    record["bench_golden_reported"] = reported


# The randomized sweep (phase 15): fuzz_scene's random scenes at launch
# shapes the main paths never send (films that are no power of two, short
# last warps, sample counts off the 16-sample pool, row counts at and around
# the row multiple and the 512-row ceiling, bands one row high at h0 > 0,
# windows at s0 > 0, a one-cluster set, cluster tables too large for shared
# memory, films off the 64-pixel squares, the last tile alone), each kernel
# against its plain version.  It runs in a child process with
# CUDA_LAUNCH_BLOCKING=1, first on the bounds-checked library, then on the
# normal one; then phase 3's sequence is replayed in this process.
FUZZ_TRACE_TRIS = (1, 3, 4, 5, 8, 63, 64, 65, 200, 511, 512)
FUZZ_TRACE_DRAWS = 3       # cases per (triangles, loop, specular)
FUZZ_FILMS = ((33, 17), (31, 29), (7, 5), (1, 1), (97, 3), (40, 24))
FUZZ_SPP = (1, 15, 17, 33)
FUZZ_DEPTHS = (0, 1, 5)
# (triangles, max_tris): one cluster; the shared-memory tables; tables too
# large for them (the kernel's global-memory instance).
FUZZ_CLUSTER_SETS = ((1, 64), (24, 64), (160, 4), (600, 16), (6000, 4))
FUZZ_RAYS = (1, 255, 256, 257, 1000, 4097)
FUZZ_RAY_KINDS = ("camera", "inside", "axis")
# (triangles, specular): a single supercluster; all four instances of the
# beam kernel (more than 64 materials are inlined in the rows).
FUZZ_BEAM_SCENES = ((2, False), (24, False), (24, True), (160, False),
                    (160, True), (600, True))
FUZZ_BEAM_FILMS = ((33, 17), (100, 70), (65, 64), (130, 3))
FUZZ_BEAM_DRAWS = 4
FUZZ_REPLAYS = 256         # rounds of phase 3's corner-scene sequence
FUZZ_TIMEOUT = 600         # seconds for a child, start-up included


class GuardedTorch:
    """The torch module, except that ``zeros``, ``empty`` and ``cat``
    return views into the middle of larger buffers whose margins hold NaN
    bits (0x7FC00000, read as float32 or int32): a kernel that writes past
    either end of one changes a margin.  ``copy`` puts an input between such
    margins.  Only 4-byte types, those of every kernel buffer, are taken."""

    MARGIN = 1 << 16   # elements on each side
    NAN_BITS = 0x7FC00000

    def __init__(self):
        import torch
        self._torch = torch
        self.buffers = []

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def _guarded(self, shape, dtype, device):
        import math
        torch = self._torch
        if dtype.itemsize != 4:
            raise TypeError(f"GuardedTorch guards 4-byte types, not {dtype}")
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        n = math.prod(shape)
        buf = torch.full((n + 2 * self.MARGIN,), self.NAN_BITS,
                         dtype=torch.int32, device=device)
        self.buffers.append(buf)
        return buf[self.MARGIN:self.MARGIN + n].view(dtype).view(shape)

    def zeros(self, shape, *, dtype=None, device=None):
        dtype = dtype or self._torch.float32
        return self._guarded(shape, dtype, device).zero_()

    def empty(self, shape, *, dtype=None, device=None):
        return self._guarded(shape, dtype or self._torch.float32, device)

    def cat(self, tensors, dim=0):
        return self.copy(self._torch.cat(tensors, dim))

    def copy(self, x):
        return self._guarded(x.shape, x.dtype, x.device).copy_(x)

    def hits(self):
        """The buffers whose margins changed."""
        m = self.MARGIN
        return sum(1 for b in self.buffers
                   if not (bool((b[:m] == self.NAN_BITS).all())
                           and bool((b[-m:] == self.NAN_BITS).all())))


@contextlib.contextmanager
def guarded_wrappers(guard):
    """The kernel wrappers' ``torch`` replaced by ``guard`` (the trace
    kernel's module too: the beam wrapper packs its camera there)."""
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
    with contextlib.ExitStack() as stack:
        for module in (ttk, ck, bk):
            stack.enter_context(swapped(module, "torch", guard))
        yield


def guarded_fields(guard, obj):
    """A copy of the dataclass ``obj`` (a ClusterSet or BeamAccel) whose
    tensor fields lie between the guard's margins."""
    import dataclasses
    import torch
    return dataclasses.replace(obj, **{
        f.name: guard.copy(getattr(obj, f.name))
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def fuzz_trace_cases():
    """The trace kernel's cases: every count of FUZZ_TRACE_TRIS in both
    loops, with and without specular materials, FUZZ_TRACE_DRAWS times,
    each with a drawn film, band (the whole film, one row at h0 > 0, or
    any band), window and depth; then phase 3's shapes."""
    import numpy as np
    r = np.random.default_rng(15)
    cases = []
    for n in FUZZ_TRACE_TRIS:
        for loop in ("mt", "plucker"):
            for specular in (False, True):
                for _ in range(FUZZ_TRACE_DRAWS):
                    w, h = FUZZ_FILMS[r.integers(len(FUZZ_FILMS))]
                    band = r.integers(3)
                    if band == 0 or h == 1:
                        h0, band_h = 0, h
                    elif band == 1:
                        h0, band_h = int(r.integers(1, h)), 1
                    else:
                        h0 = int(r.integers(0, h))
                        band_h = int(r.integers(1, h - h0 + 1))
                    cases.append(dict(
                        n_tris=n, res=(w, h), loop=loop, specular=specular,
                        h0=h0, band_h=band_h,
                        s0=int(r.choice([0, r.integers(1, 1 << 20)])),
                        spp=int(r.choice(FUZZ_SPP)),
                        depth=int(r.choice(FUZZ_DEPTHS)),
                        seed=int(r.integers(1 << 31))))
    for loop in ("mt", "plucker"):   # phase 3's band and window launches
        cases.append(dict(n_tris=24, res=(64, 48), loop=loop, specular=True,
                          h0=17, band_h=13, s0=1, spp=3, depth=DEPTH,
                          seed=1))
    return cases


def fuzz_cluster_cases():
    """The cluster kernel's cases: each set of FUZZ_CLUSTER_SETS with each
    kind of rays (camera rays; origins anywhere in the scene's box, some
    direction components exactly 0; origins at cluster centres, directions
    along an axis) at two drawn ray counts, unsorted and sorted."""
    import numpy as np
    r = np.random.default_rng(16)
    cases = []
    for n, max_tris in FUZZ_CLUSTER_SETS:
        for kind in FUZZ_RAY_KINDS:
            for _ in range(2):
                rays = int(r.choice(FUZZ_RAYS))
                for sort_rays in (False, True):
                    cases.append(dict(n_tris=n, max_tris=max_tris,
                                      kind=kind, rays=rays,
                                      sort_rays=sort_rays,
                                      seed=int(r.integers(1 << 31))))
    return cases


def fuzz_beam_cases():
    """The beam kernel's cases: each scene of FUZZ_BEAM_SCENES on drawn
    films (none a multiple of 64), tile bands (the whole film, the last
    tile alone, or any band), windows and depths 1 and 3."""
    import numpy as np
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    r = np.random.default_rng(17)
    cases = []
    for n, specular in FUZZ_BEAM_SCENES:
        for k in range(FUZZ_BEAM_DRAWS):
            w, h = FUZZ_BEAM_FILMS[r.integers(len(FUZZ_BEAM_FILMS))]
            wp, hp = bk._padded_res(w, h)
            total = wp * hp // bk.TILE_PX
            band = k % 3
            if band == 0:
                tile0, n_tiles = 0, total
            elif band == 1:
                tile0, n_tiles = total - 1, 1
            else:
                tile0 = int(r.integers(0, total))
                n_tiles = int(r.integers(1, total - tile0 + 1))
            cases.append(dict(n_tris=n, specular=specular, res=(w, h),
                              tile0=tile0, n_tiles=n_tiles,
                              s0=int(r.integers(0, 1000)),
                              spp=int(r.integers(1, 5)),
                              depth=(1, 3)[k % 2], counts=k % 2 == 0,
                              seed=int(r.integers(1 << 31))))
    return cases


def fuzz_rays(case, cam, cs, dev):
    """(origins, directions) (R, 3) float32 of a cluster case."""
    import numpy as np
    import torch
    gen = np.random.default_rng(case["seed"])
    n = case["rays"]
    if case["kind"] == "camera":
        return camera_rays(cam, n, gen)
    if case["kind"] == "inside":
        lb, rt = (x.cpu().numpy() for x in cs.scene_bounds)
        o = lb + gen.random((n, 3)) * (rt - lb)
        d = gen.normal(size=(n, 3))
        zero = gen.random((n, 3)) < 0.3
        zero[np.all(zero, axis=1), 0] = False
        d[zero] = 0.0
    else:
        centres = cs.centers.cpu().numpy()
        o = centres[gen.integers(0, centres.shape[0], n)]
        d = np.zeros((n, 3))
        d[np.arange(n), gen.integers(0, 3, n)] = gen.choice([-1.0, 1.0], n)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev))


def cluster_instance(cs):
    """"smem" or "global": the cluster kernel's instance for this set, by
    the rule of csrc/cluster_kernel.cu (its tables and stack in shared
    memory when two blocks of them fit an SM)."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck
    per_sm = 228 * 1024       # the H100's, where torch does not report it
    if cs.device.type == "cuda":
        per_sm = getattr(torch.cuda.get_device_properties(cs.device),
                         "shared_memory_per_multiprocessor", per_sm)
    stack = cs.tree_depth * ck.BLOCK_RAYS * 8
    tables = (cs.num_clusters - 1) * 64 + cs.num_clusters * 8
    return "smem" if 2 * (stack + tables + 1024) <= per_sm else "global"


def same_bits(a, b):
    """Whether two tensors, or two tuples of tensors, are equal bit for
    bit."""
    import torch
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def run_fuzz_case(pt, dev, kind, case):
    """One case: the kernel launched twice on guarded buffers, then the
    plain version.  Returns {"launches", "equal" (to the plain version, bit
    for bit), "repeat" (the second launch's bits equal the first's),
    "guard_hits" (buffers whose margins changed), "instance"}."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

    guard = GuardedTorch()
    counts = []   # the beam's per-pixel test counts of each launch
    if kind == "trace":
        cam, scene = fuzz_scene(pt, 1000 + case["n_tris"], case["n_tris"],
                                case["res"], specular=case["specular"],
                                device=dev)
        args = (cam, scene, case["s0"], case["spp"], case["depth"])
        kw = dict(seed=case["seed"], h0=case["h0"], band_h=case["band_h"],
                  loop=case["loop"])
        module = ttk
        instance = (f"{case['loop']}/"
                    f"{'specular' if scene.has_specular else 'diffuse'}")

        def run():
            return ttk.render_sum_cuda(*args, **kw)

        def plain():
            return ttk.render_sum_reference(*args, **kw)
    elif kind == "cluster":
        cam, scene = fuzz_scene(pt, 2000 + case["n_tris"], case["n_tris"],
                                (64, 64), device=dev)
        cs = pt.build_clusters(scene, max_tris=case["max_tris"]).to(dev)
        o, d = fuzz_rays(case, cam, cs, dev)
        g_cs = guarded_fields(guard, cs)
        g_o, g_d = guard.copy(o), guard.copy(d)
        module = ck
        instance = cluster_instance(cs)

        def run():
            return ck.intersect_clusters(g_o, g_d, g_cs,
                                         sort_rays=case["sort_rays"])

        def plain():
            return ck.intersect_clusters_reference(o, d, cs)
    else:
        cam, scene = fuzz_scene(pt, 3000 + case["n_tris"], case["n_tris"],
                                case["res"], specular=case["specular"],
                                device=dev)
        accel = bk._accel_for(scene)
        g_accel = guarded_fields(guard, accel)
        args = (cam, scene, case["s0"], case["spp"], case["depth"])
        kw = dict(seed=case["seed"], tile0=case["tile0"],
                  n_tiles=case["n_tiles"])
        module = bk
        instance = (f"{'specular' if scene.has_specular else 'diffuse'}/"
                    f"{'inline' if accel.mats_inline else 'table'}")

        def run():
            c = None
            if case["counts"] and dev.type == "cuda":
                c = guard.zeros(case["n_tiles"] * bk.TILE_PX,
                                dtype=torch.int32, device=dev)
                counts.append(c)
            return bk.render_tiles_beam(*args, accel=g_accel, counts=c, **kw)

        def plain():
            return bk.render_tiles_beam_reference(*args, accel=accel, **kw)

    before = module.LAUNCHES
    with guarded_wrappers(guard):
        first = run()
        second = run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = module.LAUNCHES - before
    want = plain()
    repeat = same_bits(first, second) and (
        len(counts) < 2 or torch.equal(counts[0], counts[1]))
    return {"launches": launches, "equal": same_bits(first, want),
            "repeat": repeat, "guard_hits": guard.hits(),
            "buffers": len(guard.buffers), "instance": instance}


def fuzz_sweep(pt, dev, label):
    """Every case of the three kernels; prints one line per kernel and
    returns {kernel: summary}."""
    cases = {"trace": fuzz_trace_cases(), "cluster": fuzz_cluster_cases(),
             "beam": fuzz_beam_cases()}
    out = {}
    for kind, todo in cases.items():
        t0 = time.perf_counter()
        s = {"cases": len(todo), "launches": 0, "mismatches": [],
             "repeat_mismatches": [], "guard_hits": 0, "instances": {}}
        for case in todo:
            got = run_fuzz_case(pt, dev, kind, case)
            s["launches"] += got["launches"]
            s["guard_hits"] += got["guard_hits"]
            s["instances"][got["instance"]] = (
                s["instances"].get(got["instance"], 0) + 1)
            if not got["equal"]:
                s["mismatches"].append(case)
            if not got["repeat"]:
                s["repeat_mismatches"].append(case)
        s["seconds"] = time.perf_counter() - t0
        print(f"fuzz {label} {kind}: {s['cases']} cases, {s['launches']} "
              f"launches, {len(s['mismatches'])} mismatches against the "
              f"plain version, {len(s['repeat_mismatches'])} second "
              f"launches not bit-equal, {s['guard_hits']} guard-margin "
              f"hits, instances {s['instances']}, {s['seconds']:.1f} s",
              flush=True)
        for case in s["mismatches"] + s["repeat_mismatches"]:
            print(f"  failing {kind} case: {case}", flush=True)
        out[kind] = s
    return out


def fuzz_replay(pt, dev, label):
    """Phase 3's sequence on the corner scene, FUZZ_REPLAYS rounds: per
    loop a trace-kernel launch at 64^2, 4 spp, depth 5, then its plain
    version.  Prints and returns {"pairs", "mismatches", "seconds"}."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk

    t0 = time.perf_counter()
    bad = 0
    for _ in range(FUZZ_REPLAYS):
        cam, scene = pt.corner_scene(res=(64, 64), device=dev)
        for loop in ttk.LOOPS:
            got = ttk.render_sum_cuda(cam, scene, 0, 4, DEPTH, loop=loop)
            want = ttk.render_sum_reference(cam, scene, 0, 4, DEPTH,
                                            loop=loop)
            bad += not torch.equal(got, want)
    rec = {"pairs": FUZZ_REPLAYS * len(ttk.LOOPS), "mismatches": bad,
           "seconds": time.perf_counter() - t0}
    print(f"fuzz {label} replay of phase 3 (corner 64^2, both loops): "
          f"{rec['pairs']} kernel launches each followed by the plain "
          f"version, {bad} mismatches, {rec['seconds']:.1f} s, "
          f"CUDA_LAUNCH_BLOCKING="
          f"{os.environ.get('CUDA_LAUNCH_BLOCKING', 'unset')}", flush=True)
    return rec


def fuzz_child(out_path):
    """The child of phase 15 (``--fuzz-child OUT``): the sweep and the
    replay on the checked library, then the sweep on the normal one, their
    records into the JSON at OUT."""
    import torch
    sys.path.insert(0, REPO)
    import pathtracer_tpu_torch as pt
    from pathtracer_tpu_torch.utils import build

    check(torch.cuda.is_available(), "the fuzz child needs a GPU")
    dev = torch.device("cuda", 0)
    out = {"blocking": os.environ.get("CUDA_LAUNCH_BLOCKING") == "1"}
    checked = functools.partial(build.load_library, checked=True)
    with swapped(build, "load_library", checked):
        out["checked"] = {"sweep": fuzz_sweep(pt, dev, "checked"),
                          "replay": fuzz_replay(pt, dev, "checked")}
    out["normal"] = {"sweep": fuzz_sweep(pt, dev, "normal")}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)


def fuzz_verdict(results):
    """(faults, summary line) of phase 15's records: the child's
    ({"checked": {"sweep", "replay"}, "normal": {"sweep"}}) and the
    parent's replay.  A kernel faults on a library when a case differs
    from the plain version or from its own second launch, when a guard
    margin changed, when a case launched the kernel fewer than twice, or
    when the cases missed one of its instances; a replay faults on a
    mismatch."""
    instances = {"trace": 4, "cluster": 2, "beam": 4}
    child = results["child"]
    runs = [(label, kind, s) for label in ("checked", "normal")
            for kind, s in child[label]["sweep"].items()]
    bad = [f"{label} {kind}" for label, kind, s in runs
           if s["mismatches"] or s["repeat_mismatches"] or s["guard_hits"]
           or s["launches"] < 2 * s["cases"]
           or len(s["instances"]) != instances[kind]]
    replays = (child["checked"]["replay"], results["replay"])
    bad += [f"{name} replay" for name, r in zip(("checked", "unblocked"),
                                               replays) if r["mismatches"]]
    mismatches = sum(len(s["mismatches"]) + len(s["repeat_mismatches"])
                     for _, _, s in runs)
    counts = ", ".join(f"{kind} {s['cases']} cases ({s['launches']} "
                       f"launches)" for kind, s in
                       child["normal"]["sweep"].items())
    summary = (f"{counts} on each library; {mismatches} mismatches, "
               f"{sum(s['guard_hits'] for _, _, s in runs)} guard hits, no "
               f"trap; phase 3 replayed {replays[0]['pairs']} times checked "
               f"and {replays[1]['pairs']} unblocked, "
               f"{sum(r['mismatches'] for r in replays)} mismatches")
    return bad, summary


def phase_fuzz(pt, dev, card, record):
    """Phase 15: the sweep in a child process with CUDA_LAUNCH_BLOCKING=1
    (a device fault is pinned to its launch and cannot poison this
    process), on the checked library and then the normal one; a failure of
    the child fails the run, with its output.  Then the replay of phase 3
    here, on the normal library, with launches asynchronous as in phase
    3."""
    print("== 15 randomized sweep: each kernel against its plain version "
          "on random scenes and odd launch shapes", flush=True)
    t0 = time.perf_counter()
    path = os.path.join(OUT_DIR, "fuzz.json")
    if os.path.exists(path):
        os.unlink(path)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--fuzz-child", path],
        env=dict(os.environ, CUDA_LAUNCH_BLOCKING="1"), capture_output=True,
        text=True, timeout=FUZZ_TIMEOUT)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-20000:], end="", flush=True)
    check(proc.returncode == 0, f"phase 15 child exited {proc.returncode}")
    with open(path) as f:
        results = {"child": json.load(f),
                   "replay": fuzz_replay(pt, dev, "normal")}
    seconds = time.perf_counter() - t0
    bad, summary = fuzz_verdict(results)
    print(f"{card}: phase 15: {summary}; {seconds:.1f} s; the checked "
          f"library built in {record['build']['checked_seconds']:.2f} s "
          f"(phase 2); faults: {bad or 'none'}", flush=True)
    check(not bad, f"phase 15: {bad}")
    record["fuzz"] = dict(results, seconds=seconds)


def main():
    import argparse
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", metavar="DIR",
                    help="an older checkout's csrc/: time its beam and "
                         "cluster kernels beside these in phase 9")
    ap.add_argument("--phases", metavar="N,N",
                    help="run only these of phases 11-15 (after 1 and 2) "
                         "and print neither the kernels line nor the "
                         "device line")
    ap.add_argument("--fuzz-child", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.fuzz_child:
        fuzz_child(args.fuzz_child)
        return

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

    record = {"card": card}
    os.makedirs(OUT_DIR, exist_ok=True)
    regs, sass, parent = phase_build(record, args.parent_csrc)
    if args.phases:
        only = {int(x) for x in args.phases.split(",")}
        extra = {11: phase_sharded, 12: phase_realtime_cli,
                 13: phase_wavefront, 14: phase_bench, 15: phase_fuzz}
        check(only <= set(extra), f"--phases takes {sorted(extra)}")
        for n in sorted(only):
            extra[n](pt, dev, card, record)
        print(f"partial run: phases 1, 2, {sorted(only)} passed", flush=True)
        return
    phase_parity(pt, dev, record)
    launches = phase_main(pt, dev, record)
    trace = phase_trace_timing(pt, card, regs, sass, record)
    cluster_err = phase_cluster(pt, dev, record)
    beam_err = phase_beam(pt, dev, record)
    beam_launches, cluster_launches, band_err = phase_large(pt, dev, record)
    beam_err = max(beam_err, band_err)
    times = phase_timing(pt, dev, card, record, parent)
    cluster_err = max(cluster_err, times["cluster_err"])
    phase_diff(pt, dev, card, record)
    phase_sharded(pt, dev, card, record)
    phase_realtime_cli(pt, dev, card, record)
    phase_wavefront(pt, dev, card, record)
    phase_bench(pt, dev, card, record)
    phase_fuzz(pt, dev, card, record)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)

    kernels = [
        ("trace_kernel", "trace_kernel.py:96", launches, trace["max_abs"],
         (trace["ms"], trace["plain_ms"], trace["bound_ms"])),
        ("cluster_kernel", "cluster_kernel.py:57", cluster_launches,
         cluster_err, times["cluster_kernel"]),
        ("beam_kernel", "beam_kernel.py:167", beam_launches, beam_err,
         times["beam_kernel"])]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"pathtracer_tpu_torch/csrc/{name}.cu",
        "replaces": f"pathtracer_tpu/ops/pallas/{where}",
        "launches": n,
        "max_abs_err": err,
        "ms": t[0],
        "plain_ms": t[1],
        "bound_ms": t[2],
        "bound_by": "operations",
        "library_ms": None,
    } for name, where, n, err, t in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
