#!/usr/bin/env python3
"""Smoke run of pathtracer_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and the exit code is
not 0:
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit;
  2. build: compiles csrc/*.cu with nvcc for sm_90a, prints the time and
     the registers, stack and spill of every kernel instance, and, from
     cuobjdump's SASS, the instructions of each trace-kernel instance's
     triangle loop per test;
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
     random rays, t within rtol 1e-6, tid equal except at near-ties, the
     same hits with the ray sort, and backend="cluster" against
     backend="bvh" at 64^2;
  7. the beam kernel against its plain version on the lit sphere scene, the
     Cornell box, the specular Cornell box and two 70-material (inline)
     scenes, one with specular quads (all four kernel instances), at 64^2
     and 200x72, depth 1 and 5, a band of tiles against the same tiles of a
     full launch (bit for bit), a window split over two calls (atol 1e-6),
     and the emission check;
  8. the large-scene main path: render() through backend="auto" on
     sphere_in_box(50, 100) and mesh_garden() (105,708 triangles) at 512^2,
     which must launch the beam kernel; both films against the JAX
     package's converged renders in docs/; for each, the kernel at the main
     path's launch shape against its plain version on two bands of tiles;
     one backend="cluster" render;
  9. timing: the beam and cluster kernels against their plain versions, the
     cluster kernel on the garden's clusters (a slice of its 2^20 rays held
     against the plain version), each with its bound from the boxes and
     rows these rays need (count_work), and the ray segments/s of the beam
     and cluster renders at 512^2, depth 5, and the cluster render without
     the ray sort (the default) and with it, off/on/on/off;
then one JSON line on the kernels (each with its launches on its main
path, its error against its plain version, its time, the plain version's,
its bound: the operations these inputs need over the card's published
fp32 rate) and, last, the device line.  The renders and a JSON record of
the run go to build/chip_smoke/ (git-ignored).
"""

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
CLUSTER_T_RTOL = 1e-6
TIE_RTOL = 1e-5          # nearest hits closer than this may swap ids
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


def bound_ms(ops):
    """The least time for ``ops`` fp32 operations at FP32_OPS_PER_S."""
    return ops / FP32_OPS_PER_S * 1e3


def ptxas_table(log):
    """{mangled kernel name: (registers, stack bytes, spill store bytes)}
    from nvcc's -Xptxas -v output."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w]+)'?", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            out.setdefault(name, [0, 0, 0])[1:] = [int(m.group(1)),
                                                   int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, [0, 0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def trace_instance(name):
    """'plucker/specular' for a mangled trace_kernel<kHasSpecular, kLoop>
    name, else None."""
    import re
    m = re.search(r"trace_kernelILb([01])ELi([01])E", name)
    if not m:
        return None
    return (("mt", "plucker")[int(m.group(2))] + "/"
            + ("diffuse", "specular")[int(m.group(1))])


def sass_triangle_loops(text):
    """{instance: {...}} for each trace-kernel instance in cuobjdump's SASS
    ``text``: the innermost loop that holds row loads (LDS.128) and
    reciprocals (MUFU.RCP) is the triangle loop; its instructions over the
    rows it tests per trip, and the MUFU, CALL and local-memory
    instructions of the whole function."""
    import re
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        inst = trace_instance(chunk.split("\n", 1)[0])
        if inst is None:
            continue
        code = [(int(a, 16), op.strip()) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
        index = {a: i for i, (a, _) in enumerate(code)}
        loops = []
        for i, (a, op) in enumerate(code):
            m = re.search(r"\bBRA 0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < a:
                body = [o for _, o in code[index[int(m.group(1), 16)]:i + 1]]
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


def tie_gaps(ray_o, ray_d, rows, idx):
    """Relative gap between the two nearest hits of the rays ``idx`` against
    the packed rows (dense, plain PyTorch)."""
    import torch
    from pathtracer_tpu_torch.linalg import FLOAT_INF
    from pathtracer_tpu_torch.ops.intersect import _mt
    tri = rows[:, :9]
    t, ok = _mt(ray_o[idx, None, :], ray_d[idx, None, :], tri[:, 0:3],
                tri[:, 3:6], tri[:, 6:9])
    two = torch.where(ok, t, FLOAT_INF).topk(2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) / two[:, 0]


def hold_clusters(name, o, d, cs_d, n_ref):
    """The cluster kernel on the whole ray batch, without (the default) and
    with the ray sort, held against the plain version on its first
    ``n_ref`` rays: the same hit mask, t within CLUSTER_T_RTOL, tid equal
    but at near-ties; the sorted launch must give the unsorted one's t on
    every ray.  Returns (largest |t| difference on hits, record)."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck

    t_k, tid_k = ck.intersect_clusters(o, d, cs_d)
    t_u, tid_u = ck.intersect_clusters(o, d, cs_d, sort_rays=True)
    t_p, tid_p = ck.intersect_clusters_reference(o[:n_ref], d[:n_ref], cs_d)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(t_k).all()), f"{name}: non-finite t")
    hit = tid_p >= 0
    t_s, tid_s = t_k[:n_ref], tid_k[:n_ref]
    check(bool(((tid_s >= 0) == hit).all()), f"{name}: hit masks differ")
    rel = ((t_s - t_p).abs() / t_p.abs())[hit]
    worst = float(rel.max()) if hit.any() else 0.0
    check(worst <= CLUSTER_T_RTOL, f"{name}: t differs by {worst:.3e} "
          f"relative")
    max_err = float((t_s - t_p)[hit].abs().max()) if hit.any() else 0.0
    bit_equal = float((t_s == t_p).float().mean())
    differ = torch.nonzero(tid_s != tid_p).squeeze(1)
    if differ.numel():
        gaps = tie_gaps(o, d, cs_d.tri_data, differ)
        check(bool((gaps <= TIE_RTOL).all()),
              f"{name}: tid differs away from a near-tie")
    check(bool(torch.equal(t_u, t_k)), f"{name}: the ray sort changed t")
    sorted_differ = torch.nonzero(tid_u != tid_k).squeeze(1)
    if sorted_differ.numel():
        gaps = tie_gaps(o, d, cs_d.tri_data, sorted_differ)
        check(bool((gaps <= TIE_RTOL).all()),
              f"{name}: the ray sort changed a hit away from a near-tie")
    print(f"{name} rays: {int(hit.sum())} of {n_ref} held against the plain "
          f"version hit, t bit-equal {bit_equal:.4%}, max rel diff "
          f"{worst:.3e}, tid differs at {differ.numel()} (near-ties); "
          f"with the ray sort, on all {o.shape[0]} rays: t equal, tid "
          f"differs at {sorted_differ.numel()}", flush=True)
    return max_err, {"rays": o.shape[0], "held": n_ref,
                     "hits": int(hit.sum()), "t_bit_equal": bit_equal,
                     "t_max_rel": worst, "tid_differs": differ.numel(),
                     "sorted_tid_differs": sorted_differ.numel()}


def phase_cluster(pt, dev, record):
    """Phase 6; returns the largest |t| difference on hits."""
    import numpy as np
    import torch
    from pathtracer_tpu_torch.camera import get_rays

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
    w = torch.from_numpy(gen.integers(0, LARGE_RES[0], n)).to(dev)
    h = torch.from_numpy(gen.integers(0, LARGE_RES[1], n)).to(dev)
    u = torch.from_numpy(gen.random((2, n), np.float32)).to(dev)
    cam_o, cam_d = get_rays(cam, w, h, u[0], u[1])
    rnd_o = torch.from_numpy(gen.uniform(1, 499, (n, 3)).astype(np.float32))
    rnd_d = gen.normal(size=(n, 3)).astype(np.float32)
    rnd_d /= np.linalg.norm(rnd_d, axis=-1, keepdims=True)
    rays = {"camera": (cam_o.contiguous(), cam_d.contiguous()),
            "random": (rnd_o.to(dev), torch.from_numpy(rnd_d).to(dev))}
    max_err = 0.0
    out = {}
    for name, (o, d) in rays.items():
        err, out[name] = hold_clusters(name, o, d, cs_d, n)
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
                got = bk.render_sum_beam(cam, scene, 0, spp, depth) / spp
                want = bk.render_sum_beam_reference(cam, scene, 0, spp,
                                                    depth) / spp
                torch.cuda.synchronize()
                diff, share = film_diff(got, want)
                equal = float((got == want).float().mean())
                key = f"{name} {res[0]}x{res[1]} depth {depth}"
                print(f"{key}: max abs diff {diff:.3e}, pixels beyond "
                      f"{FILM_ATOL}: {share:.4%}, bit-equal values "
                      f"{equal:.4%}, mean {float(got.mean()):.5f}",
                      flush=True)
                check(float(got.mean()) > 0.0, f"{key}: black film")
                check(share <= MAX_FLIP_SHARE,
                      f"{key}: {share:.4%} of pixels beyond {FILM_ATOL}")
                max_abs = max(max_abs, diff)
                out[key] = {"max_abs": diff, "share": share,
                            "bit_equal": equal}

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


def hold_main_path_bands(pt, cam, scene, spp):
    """The beam kernel at the main path's launch shape (its padded film, its
    accel and its samples per launch) held against the plain version on two
    bands of BAND_TILES tiles: the film's first tiles and the tiles at its
    centre, the first launch's sample window.  Returns (record, largest
    per-sample difference)."""
    import torch
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk

    spp_call = bk._default_spp_per_call(cam, spp, DEPTH)
    wp, hp = bk._padded_res(*cam.res)
    centre_sq = (hp // 2 // 64) * (wp // 64) + wp // 2 // 64
    out, worst, lit = {}, 0.0, 0.0
    for tile0 in (0, centre_sq * (64 * 64 // bk.TILE_PX)):
        kw = dict(tile0=tile0, n_tiles=BAND_TILES)
        got = bk.render_tiles_beam(cam, scene, 0, spp_call, DEPTH, **kw)
        want = bk.render_tiles_beam_reference(cam, scene, 0, spp_call, DEPTH,
                                              **kw)
        torch.cuda.synchronize()
        diff, share = film_diff(got.T / spp_call, want.T / spp_call)
        equal = float((got == want).float().mean())
        lit = max(lit, float(got.mean()))
        key = f"tiles [{tile0}, {tile0 + BAND_TILES})"
        print(f"  {key}, {spp_call} spp (one main-path launch), kernel vs "
              f"plain: max abs diff {diff:.3e}, pixels beyond {FILM_ATOL}: "
              f"{share:.4%}, bit-equal values {equal:.4%}", flush=True)
        check(share <= MAX_FLIP_SHARE,
              f"{key}: {share:.4%} of pixels beyond {FILM_ATOL}")
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


def phase_timing(pt, dev, card, record):
    """Phase 9; returns {kernel: (ms, plain_ms, bound_ms)} and, under
    "cluster_err",
    the largest |t| difference of the garden's and the sphere's held
    rays."""
    import numpy as np
    import torch
    from pathtracer_tpu_torch.camera import get_rays
    from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
    from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck
    from pathtracer_tpu_torch.utils.timer import device_ms

    print("== 9 timing", flush=True)
    out = {}
    cluster_err = 0.0
    cam_d, sb = pt.meshes.sphere_in_box(50, 100)
    scene = scene_d = sb.build()

    cam_t = with_res(cam_d, TIME_BEAM_RES)
    res = {}
    plain_ms, plain_all = device_ms(lambda: res.__setitem__(
        "p", bk.render_sum_beam_reference(cam_t, scene_d, 0, TIME_BEAM_SPP,
                                          DEPTH)), calls=1)
    beam_ms, beam_all = device_ms(lambda: res.__setitem__(
        "k", bk.render_sum_beam(cam_t, scene_d, 0, TIME_BEAM_SPP, DEPTH)),
        calls=KERNEL_CALLS)
    diff, share = film_diff(res["k"], res["p"])
    check(share <= MAX_FLIP_SHARE, f"beam timing shape: {share:.4%}")
    print(f"{card}: beam kernel {beam_ms:.3f} ms (runs {beam_all}), plain "
          f"version {plain_ms:.3f} ms (runs {plain_all}) per call at "
          f"{TIME_BEAM_RES[0]}x{TIME_BEAM_RES[1]}, {TIME_BEAM_SPP} spp, "
          f"depth {DEPTH}; max abs diff {diff:.3e}", flush=True)
    work = bk.count_work(cam_t, scene_d, 0, TIME_BEAM_SPP, DEPTH)
    beam_bound = bound_ms(work["ops"])
    print(f"beam bound: {work['live_segments']} live segments test "
          f"{work['sc_box_tests']} supercluster and "
          f"{work['cluster_box_tests']} cluster boxes and {work['rows']} "
          f"rows ({work['rows'] / work['live_segments']:.2f} per segment): "
          f"{work['ops']:.4e} operations, {beam_bound:.4f} ms, "
          f"{beam_bound / beam_ms:.2%} of it reached", flush=True)
    out["beam"] = {"ms": beam_ms, "plain_ms": plain_ms, "runs": beam_all,
                   "plain_runs": plain_all, "work": work,
                   "bound_ms": beam_bound}

    gcam_d, gsb = pt.meshes.mesh_garden()
    gscene = gscene_d = gsb.build()
    gen = np.random.default_rng(9)
    n = TIME_CLUSTER_RAYS
    out["cluster"] = {}
    for name, c, s in (("sphere9812", cam_d, scene),
                       ("garden105708", gcam_d, gscene)):
        w = torch.from_numpy(gen.integers(0, LARGE_RES[0], n)).to(dev)
        h = torch.from_numpy(gen.integers(0, LARGE_RES[1], n)).to(dev)
        u = torch.from_numpy(gen.random((2, n), np.float32)).to(dev)
        o, d = get_rays(c, w, h, u[0], u[1])
        o, d = o.contiguous(), d.contiguous()
        cs = pt.build_clusters(s).to(dev)
        err, held = hold_clusters(f"{name} ({cs.num_clusters} clusters) "
                                  f"camera", o, d, cs, HELD_CLUSTER_RAYS)
        cluster_err = max(cluster_err, err)
        work = ck.count_work(o, d, cs, ck.intersect_clusters(o, d, cs)[0])
        bound = bound_ms(work["ops"])
        fns = [("unsorted", lambda: ck.intersect_clusters(o, d, cs)),
               ("sorted", lambda: ck.intersect_clusters(o, d, cs,
                                                        sort_rays=True))]
        if name == "sphere9812":    # the garden's would take about 30 s
            fns.append(("plain",
                        lambda: ck.intersect_clusters_reference(o, d, cs)))
        cl = {key: device_ms(fn, calls=1 if key == "plain" else 4)
              for key, fn in fns}
        plain = (f"; plain version {cl['plain'][0]:.3f} ms"
                 if "plain" in cl else "")
        print(f"{card}: cluster kernel per 2^20 camera rays of {name} "
              f"({cs.num_clusters} clusters): {cl['unsorted'][0]:.3f} ms "
              f"without the ray sort (the default), {cl['sorted'][0]:.3f} ms "
              f"with it{plain}; bound: {work['box_tests']} box tests and "
              f"{work['rows']} rows, {work['ops']:.4e} operations, "
              f"{bound:.4f} ms, {bound / cl['unsorted'][0]:.2%} of it "
              f"reached", flush=True)
        out["cluster"][name] = {k: {"ms": v[0], "runs": v[1]}
                                for k, v in cl.items()}
        out["cluster"][name].update(held=held, work=work, bound_ms=bound)
        if name == "sphere9812":
            times = (cl["unsorted"][0], cl["plain"][0], bound)

    renders = {"sphere9812": (cam_d, scene_d, scene),
               "garden105708": (gcam_d, gscene_d, gscene)}
    out["renders"] = {}
    unsorted = ck.intersect_clusters
    for name, (c, s, host) in renders.items():
        bk._accel_for(s)            # host build outside the timed calls
        beam_spp, cluster_spp = TIME_RENDER_SPP[name]
        segs = {"beam": LARGE_RES[0] * LARGE_RES[1] * beam_spp * DEPTH,
                "cluster": LARGE_RES[0] * LARGE_RES[1] * cluster_spp * DEPTH}
        for backend, spp in (("beam", beam_spp), ("cluster", cluster_spp)):
            ms, runs = device_ms(lambda: pt.render_film(
                c, s, spp, DEPTH, backend=backend), calls=1)
            rate = segs[backend] / ms * 1e3
            print(f"{card}: {name} {backend} 512^2, {spp} spp, depth "
                  f"{DEPTH}: {ms:.3f} ms per render (runs {runs}), "
                  f"{rate:.4e} ray segments/s", flush=True)
            out["renders"][f"{name} {backend}"] = {
                "spp": spp, "ms": ms, "runs": runs, "segments_per_s": rate}
        # The cluster render without the kernel's ray sort (the default)
        # and with it, off/on/on/off, with the cluster set built once so
        # that the host build's noise stays out of the comparison.
        cs = pt.build_clusters(host).to(dev)
        ab = []
        for sort in (False, True, True, False):
            ck.intersect_clusters = (functools.partial(
                unsorted, sort_rays=True) if sort else unsorted)
            try:
                ab.append(device_ms(lambda: pt.render_film(
                    c, s, cluster_spp, DEPTH, backend="cluster", bvh=cs),
                    calls=1)[0])
            finally:
                ck.intersect_clusters = unsorted
        print(f"{card}: {name} cluster 512^2, {cluster_spp} spp, depth "
              f"{DEPTH}, cluster set built once, ms per render without/with/"
              f"with/without the ray sort: {ab}", flush=True)
        out["renders"][f"{name} cluster sort off/on/on/off"] = ab
    tests = bk.count_tri_tests(cam_d, scene_d, samples=8, depth=DEPTH)
    print(f"sphere9812 512^2: {tests:.2f} triangle rows tested per ray "
          f"segment (beam kernel, per ray)", flush=True)
    out["sphere9812_tri_tests_per_segment"] = tests
    record["large_timing"] = out
    return {"beam_kernel": (beam_ms, plain_ms, beam_bound),
            "cluster_kernel": times, "cluster_err": cluster_err}


def phase_build(record):
    """Phase 2; returns {trace instance: (registers, stack, spill)} and the
    SASS figures of the trace kernel's triangle loops."""
    from pathtracer_tpu_torch.utils import build

    print("== 2 build", flush=True)
    built = build.build_library()
    build.load_library()
    print(f"built {os.path.relpath(built.path, REPO)} in "
          f"{built.seconds:.2f} s", flush=True)
    table = ptxas_table(built.log)
    check(len(table) >= 10, f"ptxas reported {len(table)} kernel instances")
    for name, (regs, stack, spill) in sorted(table.items()):
        label = trace_instance(name) or name
        print(f"  {label}: {regs} registers, {stack} bytes stack frame, "
              f"{spill} bytes spill stores", flush=True)
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = sass_triangle_loops(subprocess.run(
        [cuobjdump, "-sass", str(built.path)], capture_output=True,
        text=True, check=True, timeout=120).stdout)
    check(len(sass) == 4, f"SASS of {len(sass)} trace kernel instances")
    for inst, fig in sorted(sass.items()):
        print(f"  {inst} SASS: triangle loop {fig['loop_instructions']} "
              f"instructions for {fig['rows_per_trip']} rows, "
              f"{fig['instructions_per_test']:.2f} per test, "
              f"{fig['loop_calls']} calls in it; the function: "
              f"{fig['mufu']} MUFU, {fig['local_memory']} local-memory "
              f"instructions", flush=True)
    regs = {trace_instance(k): v for k, v in table.items()
            if trace_instance(k)}
    record["build"] = {"seconds": built.seconds,
                       "ptxas": {trace_instance(k) or k: v
                                 for k, v in table.items()},
                       "sass": sass}
    return regs, sass


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
            r, stack, spill = regs[inst]
            print(f"{card}: {name} {loop}: kernel {ms:.4f} ms (runs "
                  f"{runs}), plain version {plain_ms:.3f} ms (runs "
                  f"{plain_all}), bit-identical; {bound / ms:.2%} of the "
                  f"bound; the triangle loop's issue slots alone "
                  f"{issue_ms:.4f} ms ({per_test:.2f} instructions per "
                  f"test); {r} registers, {stack} bytes stack, {spill} "
                  f"bytes spill", flush=True)
            out[name][loop] = {"ms": ms, "runs": runs, "plain_ms": plain_ms,
                               "plain_runs": plain_all, "max_abs": max_abs,
                               "share_of_bound": bound / ms,
                               "issue_ms": issue_ms,
                               "instructions_per_test": per_test,
                               "registers": r, "stack": stack,
                               "spill": spill}
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

    record = {"card": card}
    os.makedirs(OUT_DIR, exist_ok=True)
    regs, sass = phase_build(record)
    phase_parity(pt, dev, record)
    launches = phase_main(pt, dev, record)
    trace = phase_trace_timing(pt, card, regs, sass, record)
    cluster_err = phase_cluster(pt, dev, record)
    beam_err = phase_beam(pt, dev, record)
    beam_launches, cluster_launches, band_err = phase_large(pt, dev, record)
    beam_err = max(beam_err, band_err)
    times = phase_timing(pt, dev, card, record)
    cluster_err = max(cluster_err, times["cluster_err"])
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
