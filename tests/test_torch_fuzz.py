"""Randomized cross-backend sweep of the port: tests/test_fuzz.py's
counterpart.

Seeded random scenes (``_torch_card.fuzz_scene``: an emitter quad, slivers
down to 10^-2 scale, overlapping triangles, Emit/Diffuse/Specular, an
axis-aligned triangle, the camera looking at the centroid) are built by
the JAX SceneBuilder and carried across (``_torch_parity.carry``), so both
packages see the same arrays, on odd film shapes.  Depth-1 radiance is a
pure function of the nearest hit and the camera jitter, so each of the
port's backends is held against its ``"brute"`` film:

* bit for bit: the trace kernel's ``"mt"`` loop, ``"bvh"``, ``"cluster"``
  and ``"beam"`` (on a CPU scene the kernels' wrappers take their plain
  versions: ``render_sum_reference``, ``intersect_clusters_reference``,
  ``render_tiles_beam_reference``);
* the near-tie bar of ``_torch_parity`` (atol 2e-4 on all but 1% of the
  pixels): the ``"plucker"`` loop, which computes its hits with other
  arithmetic, so a near-tie hit may flip.

Depth-3 ``"brute"`` and ``"bvh"`` agree bit for bit, as in the reference
sweep.  The port's ``"brute"`` films are held against the JAX package's
``"brute"`` films within the near-tie bar; the JAX side runs only its
brute and BVH paths (tests/test_fuzz.py holds its Pallas kernels to its
brute path).

The cases of the card's randomized sweep (``tests/_torch_card.py``, run
by tests/test_torch_cuda.py), which hold each CUDA kernel against its
plain version, are checked here for the launch shapes they must reach,
and a few of them run through their wrappers' CPU path (the plain
versions) to exercise the sweep itself.
"""

import functools

import numpy as np
import pytest
import torch

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.linalg import EPS
from pathtracer_tpu_torch.ops import intersect as tisect
from pathtracer_tpu_torch.ops.cuda import beam_kernel as tbk
from pathtracer_tpu_torch.ops.cuda import brute_kernel as tbr
from pathtracer_tpu_torch.ops.cuda import cluster_kernel as tck
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
from pathtracer_tpu_torch.render import BRUTE_MAX, _auto_backend

import _torch_card as card
from _torch_card import fuzz_scene
from _torch_parity import as_np, assert_films_close, carry

# (seed, triangles, film): the reference's seeds and sizes on odd films,
# and one scene above BRUTE_MAX, where "auto" changes route.
CASES = [(11, 24, (33, 17)), (12, 64, (31, 29)), (13, 160, (32, 32)),
         (14, 600, (24, 20))]
SPP = 2

# Backend -> (render of the film, bar against "brute").
EXACT, NEAR_TIE = "bit for bit", "near-tie bar"
BACKENDS = {
    "cuda_mt": (lambda cam, scene, seed: ttk.render_sum_cuda(
        cam, scene, 0, SPP, 1, seed=seed, loop="mt") / SPP, EXACT),
    "cuda_plucker": (lambda cam, scene, seed: tpt.render_film(
        cam, scene, SPP, 1, seed=seed, backend="cuda").data, NEAR_TIE),
    "bvh": (lambda cam, scene, seed: tpt.render_film(
        cam, scene, SPP, 1, seed=seed, backend="bvh").data, EXACT),
    "cluster": (lambda cam, scene, seed: tpt.render_film(
        cam, scene, SPP, 1, seed=seed, backend="cluster").data, EXACT),
    "beam": (lambda cam, scene, seed: tpt.render_film(
        cam, scene, SPP, 1, seed=seed, backend="beam").data, EXACT),
}


@functools.lru_cache(maxsize=None)
def _case(seed, n_tris, res):
    """((JAX camera, scene), (port camera, scene), port brute film)."""
    jcam, jscene = fuzz_scene(jpt, seed, n_tris, res)
    cam, scene = carry(jcam, jscene)
    ref = tpt.render_film(cam, scene, SPP, 1, seed=seed,
                          backend="brute").data
    return (jcam, jscene), (cam, scene), ref


@pytest.mark.parametrize("n_tris", [1, 2, 3, 4, 24, 513])
def test_generator_builds_exactly_n_tris(n_tris):
    jcam, jscene = fuzz_scene(jpt, 5, n_tris, (9, 7))
    cam, scene = fuzz_scene(tpt, 5, n_tris, (9, 7), device="cpu")
    assert jscene.num_tris == scene.num_tris == n_tris
    np.testing.assert_array_equal(as_np(scene.v1), np.asarray(jscene.v1))
    np.testing.assert_array_equal(as_np(cam.forward),
                                  np.asarray(jcam.forward))
    assert cam.res == jcam.res == (9, 7)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("seed,n_tris,res", CASES)
def test_fuzz_depth1_backends_agree(seed, n_tris, res, backend):
    _, (cam, scene), ref = _case(seed, n_tris, res)
    assert scene.num_tris == n_tris
    assert float(ref.max()) > 0, "fuzz scene renders all-black; weak test"
    render, bar = BACKENDS[backend]
    got = render(cam, scene, seed)
    assert got.shape == ref.shape == (res[1], res[0], 3)
    if bar == EXACT:
        assert torch.equal(got, ref), backend
    else:
        assert_films_close(got, ref)


def test_fuzz_auto_route_above_brute_max():
    """Above BRUTE_MAX padded triangles "auto" leaves the dense path: on a
    CPU scene it takes "bvh", whose film is the brute one."""
    seed, n_tris, res = CASES[-1]
    _, (cam, scene), ref = _case(seed, n_tris, res)
    assert scene.padded_size > BRUTE_MAX
    assert _auto_backend(cam, scene) == "bvh"
    assert torch.equal(tpt.render_film(cam, scene, SPP, 1, seed=seed).data,
                       ref)


def test_fuzz_deep_bounce_brute_vs_bvh_bit_exact():
    """Depth 3: brute and BVH traversal are the same estimator over the
    same RNG streams, so any hit that differs anywhere along a bounce
    chain changes the film (tests/test_fuzz.py:77-88)."""
    jcam, jscene = fuzz_scene(jpt, 21, 48, (32, 32))
    cam, scene = carry(jcam, jscene)
    a = tpt.render_film(cam, scene, 24, 3, seed=5, backend="brute").data
    b = tpt.render_film(cam, scene, 24, 3, seed=5, backend="bvh").data
    assert float(a.max()) > 0
    assert torch.equal(b, a)


@pytest.mark.parametrize("seed,n_tris,res", CASES)
def test_fuzz_brute_matches_jax_brute(seed, n_tris, res):
    (jcam, jscene), _, ref = _case(seed, n_tris, res)
    want = jpt.render_film(jcam, jscene, samples=SPP, depth=1, seed=seed,
                           backend="brute").data
    assert_films_close(ref, want)


def test_fuzz_deep_bounce_matches_jax_bvh():
    """Depth 3 on the JAX package's BVH path against the port's brute."""
    jcam, jscene = fuzz_scene(jpt, 21, 48, (32, 32))
    cam, scene = carry(jcam, jscene)
    got = tpt.render_film(cam, scene, 8, 3, seed=5, backend="brute").data
    want = jpt.render_film(jcam, jscene, samples=8, depth=3, seed=5,
                           backend="bvh").data
    assert_films_close(got, want)


ROW_MULTIPLE = 4   # csrc/trace_kernel.cu kUnroll (pt_trace_row_multiple)


def test_sweep_cases_reach_the_launch_edges():
    """The sweep's cases hit the shapes the main paths never send."""
    trace = card.FUZZ_CASES["trace"]
    tris = {c["n_tris"] for c in trace}
    assert {1, ROW_MULTIPLE - 1, ROW_MULTIPLE, ROW_MULTIPLE + 1,
            ttk.MAX_CUDA_TRIS} <= tris <= set(range(1, ttk.MAX_CUDA_TRIS + 1))
    assert {(c["loop"], c["specular"]) for c in trace} == {
        (loop, spec) for loop in ttk.LOOPS for spec in (False, True)}
    assert {1, 15, 17, 33} <= {c["spp"] for c in trace}
    assert {0, 1, 5} <= {c["depth"] for c in trace}
    assert any(c["band_h"] == 1 and c["h0"] > 0 for c in trace)
    assert any(c["s0"] > 0 for c in trace)
    assert any(c["res"][0] & (c["res"][0] - 1) for c in trace)
    assert any(c["res"][0] * c["band_h"] % 32 for c in trace)
    for c in trace:
        assert 0 <= c["h0"] < c["h0"] + c["band_h"] <= c["res"][1]

    cluster = card.FUZZ_CASES["cluster"]
    assert any(c["rays"] % tck.BLOCK_RAYS for c in cluster)
    assert {c["kind"] for c in cluster} == {"camera", "inside", "axis"}

    beam = card.FUZZ_CASES["beam"]
    assert all(c["res"][0] % 64 or c["res"][1] % 64 for c in beam)
    assert {1, 3} <= {c["depth"] for c in beam}
    for c in beam:
        wp, hp = tbk._padded_res(*c["res"])
        total = wp * hp // tbk.TILE_PX
        assert 0 <= c["tile0"] < c["tile0"] + c["n_tiles"] <= total
    assert any(c["n_tiles"] == 1 and c["tile0"] == (
        tbk._padded_res(*c["res"])[0] * tbk._padded_res(*c["res"])[1]
        // tbk.TILE_PX - 1) for c in beam)


def test_sweep_sets_reach_both_cluster_instances():
    """One set of one cluster (no tree), and sets on both sides of the
    cluster kernel's shared-memory rule."""
    seen = set()
    for n, max_tris in card.FUZZ_CLUSTER_SETS:
        _, scene = fuzz_scene(tpt, 2000 + n, n, (8, 8), device="cpu")
        cs = tpt.build_clusters(scene, max_tris=max_tris)
        seen.add(card.cluster_instance(cs))
        if n == 1:
            assert cs.num_clusters == 1 and cs.tree_depth == 0
    assert seen == {"smem", "global"}


def test_sweep_scenes_reach_all_beam_instances():
    seen = set()
    for n, specular in card.FUZZ_BEAM_SCENES:
        _, scene = fuzz_scene(tpt, 3000 + n, n, (8, 8), specular=specular,
                              device="cpu")
        accel = tbk._accel_for(scene)
        seen.add((scene.has_specular, accel.mats_inline))
        if n == 2:
            assert accel.num_superclusters == 1
    assert seen == {(s, i) for s in (False, True) for i in (False, True)}


def test_sweep_brute_cases_reach_the_tile_and_eps_edges():
    """Row counts at and around one and two shared-memory tiles, every
    kind of rays, and near-EPS rows on both sides of the test's EPS for
    rays along z; ties, turned copies and zero rows in the rows."""
    brute = card.FUZZ_CASES["brute"]
    tile = tbr.TILE_ROWS
    assert {1, tile - 1, tile, tile + 1, 2 * tile, 2 * tile + 1} <= {
        c["rows"] for c in brute}
    assert {c["kind"] for c in brute} == set(card.FUZZ_BRUTE_KINDS)
    assert any(c["rays"] % tbr.BLOCK_RAYS for c in brute)
    v1, v2, v3 = (torch.from_numpy(x) for x in card.brute_eps_rows())
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(v1.shape[0], 3)
    a = (tisect.cross(d, v3 - v1) * (v2 - v1)).sum(-1).abs()
    below = int((a < EPS).sum())
    assert below == v1.shape[0] - v1.shape[0] // 2 and float(a.max()) < 2e-6
    _, (w1, w2, w3) = card.brute_rows(7, 300, "cpu")
    assert w1.shape == (300, 3)
    rows = torch.cat([w1, w2, w3], 1)
    assert len(torch.unique(rows, dim=0)) < 300       # exact copies
    assert bool((rows == 0).all(1).any())             # a zero row


@pytest.mark.parametrize("kind,index", [("trace", 0), ("trace", -1),
                                        ("cluster", 0), ("beam", 1),
                                        ("brute", 0), ("brute", -1)])
def test_sweep_case_runs_on_the_cpu(kind, index):
    """On CPU tensors the wrappers take their plain versions: the case
    must then agree with itself, allocate guarded buffers and launch
    nothing."""
    dev = torch.device("cpu")
    got = card.run_fuzz_case(dev, kind, card.FUZZ_CASES[kind][index])
    assert card.case_holds(got, dev), got


def test_guarded_torch_sees_a_write_past_an_output():
    guard = card.GuardedTorch()
    film = guard.zeros((4, 3), dtype=torch.float32, device="cpu")
    slots = guard.empty(5, dtype=torch.int32, device="cpu")
    rows = guard.cat([torch.ones(2, 3), torch.zeros(1, 3)])
    assert guard.hits() == 0 and torch.equal(rows[:2], torch.ones(2, 3))
    assert film.shape == (4, 3) and slots.shape == (5,)
    guard.buffers[1][guard.MARGIN + 5] = 0      # one element past `slots`
    assert guard.hits() == 1

