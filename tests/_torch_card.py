"""Helpers of the card tests (tests/test_torch_cuda.py) and of the CPU tests
that check them (tests/test_torch_card_support.py, tests/test_torch_fuzz.py).

Imports neither JAX nor pathtracer_tpu, so the card tests run on a machine
without JAX.  Every helper also takes CPU tensors, where the kernels'
wrappers run their plain versions: that is how the CPU tests exercise the
helpers, and how a one-ulp change to a wrapper's output is shown to fail
them.  A failed hold raises AssertionError.

The randomized sweep (``fuzz_scene`` and the ``fuzz_*_cases`` lists) holds
each kernel against its plain version at launch shapes the main paths
never send: films that are no power of two, short last warps, sample
counts off the 16-sample pool, row counts at and around the row multiple
and the 512-row ceiling, bands one row high at h0 > 0, windows at s0 > 0, a
one-cluster set, cluster tables too large for shared memory, films off the
64-pixel squares, the last tile alone, brute row counts at and around the
brute kernel's shared-memory tile with tied, degenerate and near-EPS rows.
Every buffer of a wrapper and every accel input lies between NaN guard
margins that must come back untouched (``GuardedTorch``), and a second
launch must give the first one's bits.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.camera import get_rays
from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk
from pathtracer_tpu_torch.ops.cuda import brute_kernel as brk
from pathtracer_tpu_torch.ops.cuda import cluster_kernel as ck
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
from pathtracer_tpu_torch.ops.intersect import intersect_brute

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

# Film bar, as in the CPU parity tests (tests/_torch_parity.py): the JAX
# package's own bar for its kernel against its oracle is atol 2e-4, and at
# most 1% of the pixels may differ by more (a one-ulp difference can flip a
# near-tie hit and move that path's radiance by O(1 / spp)).
FILM_ATOL = 2e-4
MAX_FLIP_SHARE = 0.01
DEPTH = 5
# Renders against the committed 2048-spp JAX renders in docs/ (8-bit, gamma
# 2.2), bars set from the first card runs (NVIDIA H100 80GB HBM3, 700 W):
# linear means +0.27% (sphere9812) and +0.98% (garden105708) apart.  PSNR:
# the garden render at 2048 spp read 50.43 dB, the same image up to near-tie
# hits (the committed render drew the same streams); the sphere render 34.45
# dB, a noise floor: the committed one was drawn with other streams.
GOLDENS = {"sphere9812": "docs/sphere9812_beam_2048spp.png",
           "garden105708": "docs/garden105708_beam_2048spp.png"}
GOLDEN_MEAN_RTOL = 0.02
GOLDEN_MIN_PSNR = {"sphere9812": 30.0, "garden105708": 45.0}
BAND_TILES = 2            # tiles of each main-path band held bit for bit


def sync(x):
    """Waits for the card when ``x`` lies on it."""
    if x.is_cuda:
        torch.cuda.synchronize()


def with_res(cam, res):
    return dataclasses.replace(cam, res=tuple(res))


def film_diff(got, want):
    """(max abs difference, share of pixels beyond FILM_ATOL) of two films
    (..., 3); ``got`` must be finite."""
    assert bool(torch.isfinite(got).all()), "non-finite film"
    diff = (got - want).abs()
    return (float(diff.max()),
            float((diff.amax(dim=-1) > FILM_ATOL).float().mean()))


def camera_rays(cam, n, gen):
    """(origins, directions) of ``n`` camera rays of ``cam`` through random
    pixels with random jitter, drawn from the numpy generator ``gen``, on
    the camera's device."""
    dev = cam.device
    w = torch.from_numpy(gen.integers(0, cam.width, n)).to(dev)
    h = torch.from_numpy(gen.integers(0, cam.height, n)).to(dev)
    u = torch.from_numpy(gen.random((2, n), np.float32)).to(dev)
    o, d = get_rays(cam, w, h, u[0], u[1])
    return o.contiguous(), d.contiguous()


def hold_clusters(o, d, cs, n_ref):
    """The cluster kernel on the whole ray batch held against the plain
    version on its first ``n_ref`` rays: t and tid bit for bit.  Returns
    how many of those rays hit."""
    t, tid = ck.intersect_clusters(o, d, cs)
    t_p, tid_p = ck.intersect_clusters_reference(o[:n_ref], d[:n_ref], cs)
    sync(t)
    assert bool(torch.isfinite(t).all()), "non-finite t"
    assert torch.equal(t[:n_ref], t_p) and torch.equal(tid[:n_ref], tid_p), (
        f"t or tid differ from the plain version on "
        f"{int((tid[:n_ref] != tid_p).sum())} of {n_ref} rays")
    return int((tid_p >= 0).sum())


def hold_main_path_bands(cam, scene, spp, depth=DEPTH, seed=None):
    """The beam kernel at the main path's launch shape (its padded film, its
    accel and its samples per launch) held bit for bit against the plain
    version on two bands of BAND_TILES tiles: the film's first tiles and
    the tiles at its centre, over the first launch's sample window
    (``seed``: the render's, None for the package's).  Returns the samples
    of that window."""
    spp_call = bk._default_spp_per_call(cam, spp, depth)
    wp, hp = bk._padded_res(*cam.res)
    centre_sq = (hp // 2 // 64) * (wp // 64) + wp // 2 // 64
    lit = 0.0
    for tile0 in (0, centre_sq * (64 * 64 // bk.TILE_PX)):
        kw = dict(tile0=tile0, n_tiles=BAND_TILES)
        if seed is not None:
            kw["seed"] = seed
        got = bk.render_tiles_beam(cam, scene, 0, spp_call, depth, **kw)
        want = bk.render_tiles_beam_reference(cam, scene, 0, spp_call, depth,
                                              **kw)
        sync(got)
        film_diff(got.T, want.T)
        assert torch.equal(got, want), (
            f"tiles [{tile0}, {tile0 + BAND_TILES}): not bit-identical")
        lit = max(lit, float(got.mean()))
    assert lit > 0.0, "the main path's bands are black"
    return spp_call


def golden_compare(png, golden):
    """(PSNR in gamma space, linear mean of the PNG ``png``, linear mean of
    the committed render ``golden``, a path under the repository)."""
    got = pt.read_png(png).astype(np.float64) / 255.0
    ref = pt.read_png(os.path.join(REPO, golden)).astype(np.float64) / 255.0
    assert got.shape == ref.shape, f"{png}: {got.shape} vs {ref.shape}"
    return (pt.psnr(got, ref), float((got ** 2.2).mean()),
            float((ref ** 2.2).mean()))


def hold_golden(png, golden, min_psnr):
    """The render saved at ``png`` against the committed ``golden``: its
    linear mean within GOLDEN_MEAN_RTOL of the golden's and its PSNR at
    least ``min_psnr``."""
    psnr, mean, want = golden_compare(png, golden)
    assert abs(mean - want) <= GOLDEN_MEAN_RTOL * want, (
        f"linear mean {mean} vs the golden's {want}")
    assert psnr >= min_psnr, f"PSNR {psnr:.2f} dB below {min_psnr}"


def brightest_sees_light(cam, scene, img_u8, ties=False):
    """(w, h, value) of the first brightest pixel of a PNG read back (rows
    top first); raises unless its centre ray hits an EMIT triangle.  With
    ``ties``, every pixel at the brightest value is a candidate and one of
    them must see the light: in a box of glossy walls the light's
    reflections saturate as the light does."""
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
    assert bool(sees[first]), (
        f"brightest pixel ({bw}, {bh}) sees triangle {int(tid[0])}, not the "
        f"light" + (f" (nor does any of the {len(hs)} as bright)"
                    if ties else ""))
    return bw, bh, float(lum[bh, bw])


# -- the randomized sweep ---------------------------------------------------

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
# Row counts of the brute kernel's cases, at and around one and two of its
# shared-memory tiles (brk.TILE_ROWS = 256); from BRUTE_EXTRA_FROM rows on
# a case adds BRUTE_TIES exact copies and BRUTE_TIES turned copies of its
# triangles and BRUTE_EPS_ROWS near-EPS rows (``brute_rows``).
FUZZ_BRUTE_ROWS = (1, 7, 40, 255, 256, 257, 512, 513, 700)
FUZZ_BRUTE_KINDS = ("camera", "inside", "axis", "eps")
BRUTE_EXTRA_FROM = 40
BRUTE_TIES = 6
BRUTE_EPS_ROWS = 16
BRUTE_EPS_Z = 40.0        # the near-EPS rows' stack, beyond the scene
FUZZ_REPLAYS = 256         # rounds of the corner-scene launch sequence
FUZZ_TIMEOUT = 900         # seconds for the checked library's child


def fuzz_scene(pkg, seed, n_tris, res=(32, 32), specular=True, **device):
    """tests/test_fuzz.py's random scene with exactly ``n_tris`` triangles:
    an emitter quad (two triangles), n_tris - 3 random ones (centres in
    [-8, 8]^3, scales from 10^-2 to 10^0.8, so slivers and overlaps; Emit,
    Diffuse or Specular), then an axis-aligned triangle (axis-parallel
    rays meet d == 0 slab planes); below 3 the first n_tris of the quad and
    that triangle.  The camera, at a random point, looks at the centroid of
    the triangles' first vertices.  Without ``specular`` the specular
    draws make diffuse triangles of the same colour, on the same geometry.
    ``pkg`` is pathtracer_tpu_torch, with ``device=`` for its builders, or
    any package with the same SceneBuilder, materials and make_camera (the
    JAX one, in the CPU tests).  Returns (camera, scene)."""
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


def fuzz_trace_cases():
    """The trace kernel's cases: every count of FUZZ_TRACE_TRIS in both
    loops, with and without specular materials, FUZZ_TRACE_DRAWS times,
    each with a drawn film, band (the whole film, one row at h0 > 0, or
    any band), window and depth; then a band and window launch per loop."""
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
    for loop in ("mt", "plucker"):
        cases.append(dict(n_tris=24, res=(64, 48), loop=loop, specular=True,
                          h0=17, band_h=13, s0=1, spp=3, depth=DEPTH,
                          seed=1))
    return cases


def fuzz_cluster_cases():
    """The cluster kernel's cases: each set of FUZZ_CLUSTER_SETS with each
    kind of rays (camera rays; origins anywhere in the scene's box, some
    direction components exactly 0; origins at cluster centres, directions
    along an axis) at two drawn ray counts."""
    r = np.random.default_rng(16)
    cases = []
    for n, max_tris in FUZZ_CLUSTER_SETS:
        for kind in FUZZ_RAY_KINDS:
            for _ in range(2):
                cases.append(dict(n_tris=n, max_tris=max_tris, kind=kind,
                                  rays=int(r.choice(FUZZ_RAYS)),
                                  seed=int(r.integers(1 << 31))))
    return cases


def fuzz_beam_cases():
    """The beam kernel's cases: each scene of FUZZ_BEAM_SCENES on drawn
    films (none a multiple of 64), tile bands (the whole film, the last
    tile alone, or any band), windows and depths 1 and 3."""
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


def fuzz_brute_cases():
    """The brute kernel's cases: each row count of FUZZ_BRUTE_ROWS with
    each kind of rays (camera rays; origins anywhere in the triangles' box,
    some direction components exactly 0; origins at row centroids,
    directions along an axis; rays along z through the near-EPS rows, for
    cases that have them) at a drawn ray count."""
    r = np.random.default_rng(18)
    cases = []
    for rows in FUZZ_BRUTE_ROWS:
        for kind in FUZZ_BRUTE_KINDS:
            if kind == "eps" and rows < BRUTE_EXTRA_FROM:
                continue
            cases.append(dict(rows=rows, kind=kind,
                              rays=int(r.choice(FUZZ_RAYS)),
                              seed=int(r.integers(1 << 31))))
    return cases


FUZZ_CASES = {"trace": fuzz_trace_cases(), "cluster": fuzz_cluster_cases(),
              "beam": fuzz_beam_cases(), "brute": fuzz_brute_cases()}


class GuardedTorch:
    """The torch module, except that ``zeros``, ``empty`` and ``cat``
    return views into the middle of larger buffers whose margins hold NaN
    bits (0x7FC00000, read as float32 or int32): a kernel that writes past
    either end of one changes a margin.  ``copy`` puts an input between such
    margins.  Only 4-byte types, those of every kernel buffer, are taken."""

    MARGIN = 1 << 16   # elements on each side
    NAN_BITS = 0x7FC00000

    def __init__(self):
        self.buffers = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def _guarded(self, shape, dtype, device):
        if dtype.itemsize != 4:
            raise TypeError(f"GuardedTorch guards 4-byte types, not {dtype}")
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        n = math.prod(shape)
        buf = torch.full((n + 2 * self.MARGIN,), self.NAN_BITS,
                         dtype=torch.int32, device=device)
        self.buffers.append(buf)
        return buf[self.MARGIN:self.MARGIN + n].view(dtype).view(shape)

    def zeros(self, shape, *, dtype=None, device=None):
        return self._guarded(shape, dtype or torch.float32, device).zero_()

    def empty(self, shape, *, dtype=None, device=None):
        return self._guarded(shape, dtype or torch.float32, device)

    def cat(self, tensors, dim=0):
        return self.copy(torch.cat(tensors, dim))

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
    with contextlib.ExitStack() as stack:
        for module in (ttk, ck, bk, brk):
            stack.enter_context(mock.patch.object(module, "torch", guard))
        yield


def guarded_fields(guard, obj):
    """A copy of the dataclass ``obj`` (a ClusterSet or BeamAccel) whose
    tensor fields lie between the guard's margins."""
    return dataclasses.replace(obj, **{
        f.name: guard.copy(getattr(obj, f.name))
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def fuzz_rays(case, cam, cs, dev):
    """(origins, directions) (R, 3) float32 of a cluster case."""
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


def brute_eps_rows(n=BRUTE_EPS_ROWS):
    """(v1, v2, v3) (n, 3) float32: right triangles with legs e1 = (s, 0, 0)
    and e2 = (0, s', 0) at x = y = 0, stacked along z from BRUTE_EPS_Z in a
    shuffled order.  s = 2^-10, and s' steps by one ulp from EPS * 2^10,
    so a ray along z computes |a| = s s' exactly: the first n - n // 2
    rows fall below EPS (they fail), the rest reach it."""
    s = np.float32(2.0 ** -10)
    up = [np.float32(np.float32(1e-6) / s)]     # |a| = EPS exactly
    while len(up) < n // 2:
        up.append(np.nextafter(up[-1], np.float32(1.0)))
    down = [np.nextafter(up[0], np.float32(0.0))]
    while len(down) < n - n // 2:
        down.append(np.nextafter(down[-1], np.float32(0.0)))
    legs = np.array(down[::-1] + up, np.float32)
    z = BRUTE_EPS_Z + np.random.default_rng(n).permutation(n) * 0.125
    v1 = np.stack([np.zeros(n), np.zeros(n), z], 1).astype(np.float32)
    v2 = v1 + np.array([s, 0, 0], np.float32)
    v3 = v1 + np.stack([np.zeros(n), legs, np.zeros(n)], 1)
    return v1, v2, v3.astype(np.float32)


def brute_rows(seed, rows, dev):
    """(camera, (v1, v2, v3)) of a brute case: ``rows`` rows (T, 3)
    float32 on ``dev``: a fuzz_scene's triangles; from BRUTE_EXTRA_FROM
    rows on, BRUTE_TIES exact copies of some of them (exact ties, the lower
    row must win), BRUTE_TIES copies with their vertices turned to
    (v2, v3, v1) (the same triangle by other arithmetic) and the near-EPS
    rows; then one to three all-zero rows (the padding rows' degenerate
    triangles), where ``rows`` leaves room for them."""
    r = np.random.default_rng(seed)
    extra = (2 * BRUTE_TIES + BRUTE_EPS_ROWS
             if rows >= BRUTE_EXTRA_FROM else 0)
    n = max(1, rows - extra - int(r.integers(1, 4)))
    cam, scene = fuzz_scene(pt, seed, n, device=dev)
    v = list(scene.host_verts())
    if extra:
        same, turn = r.integers(0, n, BRUTE_TIES), r.integers(0, n, BRUTE_TIES)
        eps = brute_eps_rows()
        v = [np.concatenate([v[k], v[k][same], v[(k + 1) % 3][turn], eps[k]])
             for k in range(3)]
    pad = np.zeros((rows - v[0].shape[0], 3), np.float32)
    return cam, tuple(torch.from_numpy(np.concatenate([x, pad])).to(dev)
                      for x in v)


def brute_rays(case, cam, v, dev):
    """(origins, directions) (R, 3) float32 of a brute case (``v``: its
    rows from ``brute_rows``)."""
    gen = np.random.default_rng(case["seed"])
    n = case["rays"]
    kind = case["kind"]
    if kind == "camera":
        return camera_rays(cam, n, gen)
    v1, v2, v3 = (x.cpu().numpy() for x in v)
    if kind == "inside":
        pts = np.concatenate([v1, v2, v3])
        lb, rt = pts.min(0), pts.max(0)
        o = lb + gen.random((n, 3)) * (rt - lb)
        d = gen.normal(size=(n, 3))
        zero = gen.random((n, 3)) < 0.3
        zero[np.all(zero, axis=1), 0] = False
        d[zero] = 0.0
    elif kind == "axis":
        o = ((v1 + v2 + v3) / 3.0)[gen.integers(0, v1.shape[0], n)]
        d = np.zeros((n, 3))
        d[np.arange(n), gen.integers(0, 3, n)] = gen.choice([-1.0, 1.0], n)
    else:
        # Inside the smallest near-EPS triangle, from below or above the
        # stack, along z.
        up = gen.random(n) < 0.5
        s = 2.0 ** -10
        o = np.stack([gen.uniform(0.1, 0.4, n) * s,
                      gen.uniform(0.1, 0.4, n) * s,
                      np.where(up, BRUTE_EPS_Z - 5.0, BRUTE_EPS_Z + 7.0)], 1)
        d = np.zeros((n, 3))
        d[:, 2] = np.where(up, 1.0, -1.0)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev))


def cluster_instance(cs):
    """"smem" or "global": the cluster kernel's instance for this set, by
    the rule of csrc/cluster_kernel.cu (its tables and stack in shared
    memory when two blocks of them fit an SM)."""
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
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def run_fuzz_case(dev, kind, case):
    """One case: the kernel launched twice on guarded buffers, then the
    plain version.  Returns {"launches", "equal" (to the plain version, bit
    for bit), "repeat" (the second launch's bits equal the first's),
    "guard_hits" (buffers whose margins changed), "buffers",
    "instance"}."""
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
            return ck.intersect_clusters(g_o, g_d, g_cs)

        def plain():
            return ck.intersect_clusters_reference(o, d, cs)
    elif kind == "brute":
        cam, v = brute_rows(case["seed"], case["rows"], dev)
        o, d = brute_rays(case, cam, v, dev)
        g = [guard.copy(x) for x in (o, d, *v)]
        module = brk
        instance = ("one tile" if case["rows"] <= brk.TILE_ROWS
                    else "tiles")

        def run():
            return brk.intersect_brute_cuda(*g)

        def plain():
            return intersect_brute(o, d, *v)
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


def case_holds(got, dev):
    """Whether a run_fuzz_case record holds: bit for bit against the plain
    version and against its own second launch, no guard margin changed,
    and on a card two launches of the kernel."""
    return (got["equal"] and got["repeat"] and got["guard_hits"] == 0
            and got["buffers"] >= 2
            and got["launches"] == (2 if dev.type == "cuda" else 0))


def replay_mismatches(dev, rounds=FUZZ_REPLAYS):
    """The corner scene at 64^2, 4 spp, depth 5, ``rounds`` times: per loop
    a trace-kernel launch, then its plain version.  Returns how many
    launches differed from their plain version."""
    bad = 0
    for _ in range(rounds):
        cam, scene = pt.corner_scene(res=(64, 64), device=dev)
        for loop in ttk.LOOPS:
            got = ttk.render_sum_cuda(cam, scene, 0, 4, DEPTH, loop=loop)
            want = ttk.render_sum_reference(cam, scene, 0, 4, DEPTH,
                                            loop=loop)
            bad += not torch.equal(got, want)
    return bad


def checked_sweep():
    """Every case of the sweep, then FUZZ_REPLAYS rounds of the corner
    scene's launches, on the bounds-checked library (built with
    -DPTK_CHECKED: an index out of range traps, naming the kernel, the
    array and the index).  Runs in a child process with
    CUDA_LAUNCH_BLOCKING=1 (``run_checked_sweep``), so a device fault is
    pinned to its launch and cannot poison the tests' process.  Prints each
    failing case and exits 1 if any failed."""
    from pathtracer_tpu_torch.utils import build

    dev = torch.device("cuda", 0)
    checked = build.load_library(checked=True)
    failed = []
    with mock.patch.object(build, "load_library", lambda *a, **k: checked):
        for kind, cases in FUZZ_CASES.items():
            for case in cases:
                if not case_holds(run_fuzz_case(dev, kind, case), dev):
                    failed.append((kind, case))
        replay = replay_mismatches(dev)
    for kind, case in failed:
        print(f"failing {kind} case: {case}", flush=True)
    print(json.dumps({"cases": sum(map(len, FUZZ_CASES.values())),
                      "failed": len(failed), "replay_mismatches": replay}),
          flush=True)
    sys.exit(1 if failed or replay else 0)


def run_checked_sweep():
    """``checked_sweep`` in a child process with CUDA_LAUNCH_BLOCKING=1:
    the finished process."""
    code = (f"import sys; sys.path[:0] = [{TESTS!r}, {REPO!r}]; "
            f"import _torch_card; _torch_card.checked_sweep()")
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=FUZZ_TIMEOUT,
        env=dict(os.environ, CUDA_LAUNCH_BLOCKING="1"))


# -- two ranks on one card ---------------------------------------------------

# The 1024^2 Cornell box at the main path's 256 spp; the garden at the beam
# kernel's main-path launch (512^2, 25 spp), and at 24 spp for the sample
# split, which needs an even count; the Cornell recovery's width (128^2, 384
# spp, depth 5) for the train step.
SHARD_RANKS = 2
SHARD_SPLITS = ((2, 1), (1, 2))      # (tile, sample)
SHARD_CORNELL = ((1024, 1024), 256)
SHARD_GARDEN = ((512, 512), {1: 25, 2: 24})   # spp by the sample axis
SHARD_TRAIN = ((128, 128), 384, 3)            # res, spp, steps
SHARD_TIMEOUT = 600      # seconds for both ranks, start-up included


def shard_worker(rank, world, store, work):
    """One rank: joins the group through the file ``store``, drives the
    sharded entry points with each kernel's launches counted around each
    render, and saves its films, its parameters after each train step and
    its launch counts under ``work`` for the test to check.  The train
    step's target comes from ``work``/target.pt."""
    import torch.distributed as dist
    from pathtracer_tpu_torch import inverse
    from pathtracer_tpu_torch.parallel import (
        distributed, make_mesh, make_sharded_train_step,
        render_film_sharded_beam, render_film_sharded_cuda)

    dev = distributed.initialize(f"file://{store}", world, rank,
                                 timeout=SHARD_TIMEOUT // 2)
    out = {"backend": dist.get_backend()}
    meshes = {split: make_mesh(tile=split[0], sample=split[1])
              for split in SHARD_SPLITS}

    def drive(name, render, module):
        before = module.LAUNCHES
        film = render()
        torch.cuda.synchronize()
        out[name] = module.LAUNCHES - before
        torch.save(film.data.cpu(), os.path.join(work, f"{name}_{rank}.pt"))

    res, spp = SHARD_CORNELL
    cam, scene = pt.cornell_box(res=res, device=dev)
    for split, mesh in meshes.items():
        drive(f"cornell_{split[0]}x{split[1]}", lambda: (
            render_film_sharded_cuda(mesh, cam, scene, spp, DEPTH)), ttk)
    res, spps = SHARD_GARDEN
    cam_g, sb = pt.meshes.mesh_garden(device=dev)
    cam_g, garden = with_res(cam_g, res), sb.build(device=dev)
    for split, mesh in meshes.items():
        drive(f"garden_{split[0]}x{split[1]}", lambda: (
            render_film_sharded_beam(mesh, cam_g, garden, spps[split[1]],
                                     DEPTH)), bk)

    res, spp, steps = SHARD_TRAIN
    cam_t, scene_t = pt.cornell_box(res=res, device=dev)
    target = torch.load(os.path.join(work, "target.pt")).to(dev)
    step, init = make_sharded_train_step(
        meshes[(2, 1)], cam_t, scene_t, target, spp, DEPTH,
        param_transform=inverse.to_materials)
    params = inverse.init_params(scene_t)
    opt = init(params)
    out["losses"] = []
    for k in range(steps):
        params, opt, loss = step(params, opt, k)
        out["losses"].append(float(loss))
        torch.save({n: p.detach().cpu() for n, p in params.items()},
                   os.path.join(work, f"train{k}_{rank}.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def run_shard_workers(work):
    """SHARD_RANKS processes of ``shard_worker`` on ``work``: [(exit code,
    output)] in rank order."""
    store = os.path.join(work, "rendezvous")
    procs = []
    for rank in range(SHARD_RANKS):
        code = (f"import sys; sys.path[:0] = [{TESTS!r}, {REPO!r}]; "
                f"import _torch_card; _torch_card.shard_worker({rank}, "
                f"{SHARD_RANKS}, {store!r}, {work!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=SHARD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, text) for p, text in zip(procs, outputs)]
