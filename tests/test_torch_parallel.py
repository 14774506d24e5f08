"""pathtracer_tpu_torch.parallel: the rank grid, the sharded drivers and
the train step, held against single-process sums of the same windows and
against pathtracer_tpu.parallel on the conftest's virtual CPU devices.

The multi-rank cases run once, in 4 gloo processes on the CPU
(``tests/_torch_dist_worker.py``, spawned by the module fixture); each
test then reads the ranks' saved results.  On the CPU the kernel drivers
run the kernels' plain versions, so their single-process reference is
``render_sum_reference`` / ``render_tiles_beam_reference``."""

import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import pathtracer_tpu as jpt
import pathtracer_tpu_torch as tpt
from pathtracer_tpu import inverse as jinv
from pathtracer_tpu.parallel import make_mesh as jmake_mesh
from pathtracer_tpu.parallel import mesh as jmesh
from pathtracer_tpu.parallel import shard as jshard
from pathtracer_tpu_torch import diff as tdiff
from pathtracer_tpu_torch.ops import trace as ttrace
from pathtracer_tpu_torch.ops.cuda import beam_kernel as tbk
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
from pathtracer_tpu_torch.parallel import distributed
from pathtracer_tpu_torch.parallel import mesh as tmesh
from pathtracer_tpu_torch.parallel import shard as tshard

from _torch_dist_cases import CASES
from _torch_parity import as_np, assert_films_close, carry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
WORLD = 4
SPAWN_TIMEOUT = 120     # seconds for all ranks; they take ~10 s here
LOSS_RTOL = 1e-4        # tests/test_torch_inverse.py's trajectory bar
PARAM_ATOL = 1e-5


def _scenes(case):
    make = {"corner": jpt.corner_scene, "cornell": jpt.cornell_box}
    jcam, jscene = make[case["scene"]](res=case["res"])
    return (jcam, jscene), carry(jcam, jscene)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's saved results of every multi-rank case."""
    out = tmp_path_factory.mktemp("ranks")
    inputs = {}
    for name, case in CASES.items():
        if case["kind"] == "train":
            (_, jscene), _ = _scenes(case)
            for k, v in jinv.init_params(jscene).items():
                inputs[f"{name}/{k}"] = np.asarray(v)
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(out / "rendezvous"),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for r in range(WORLD)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_{r}_OK" in log, (
            f"rank {r} failed:\n{log}")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _same_on_every_rank(ranks, key):
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r][key], ranks[0][key],
                                      err_msg=f"{key}: rank {r}")
    return ranks[0][key]


def _banded(case):
    (n_tile, n_sample), height = case["mesh"], case["res"][1]
    return height % n_tile == 0 and case["spp"] % n_sample == 0


# -- in-process ------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    assert tmesh._factor(n) == jmesh._factor(n)
    m = jmake_mesh(n)
    assert tmesh.mesh_shape(n) == (m.shape["tile"], m.shape["sample"])
    for tile in (t for t in range(1, n + 1) if n % t == 0):
        m = jmake_mesh(n, tile=tile)
        assert tmesh.mesh_shape(n, tile=tile) == (m.shape["tile"],
                                                  m.shape["sample"])


def test_single_process_mesh_and_initialize(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is None
    assert not dist.is_initialized() and distributed.is_primary()
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"tile": 1, "sample": 1} and mesh.coords == (0, 0)
    assert tmesh.mesh_axes() == jmesh.mesh_axes()
    with pytest.raises(ValueError, match="whole group"):
        tmesh.make_mesh(2)
    film = torch.arange(12.0).reshape(2, 2, 3)
    np.testing.assert_array_equal(distributed.gather_film(film),
                                  film.numpy())


def test_one_rank_render_matches_diff_path():
    """The sharded film equals the single-pass differentiable film: both
    trace global samples 0..spp-1 with the same streams."""
    cam, scene = tpt.corner_scene(res=(16, 16), device="cpu")
    film = tshard.render_film_sharded(tmesh.make_mesh(), cam, scene, 8, 3)
    ref = tdiff.render_film_diff(cam, scene, tdiff.material_params(scene),
                                 8, 3)
    np.testing.assert_allclose(as_np(film.data), as_np(ref), atol=1e-5)


def test_sharded_drivers_refuse_splits_that_do_not_divide():
    cam, scene = tpt.corner_scene(res=(16, 16), device="cpu")
    grid = tmesh.RankMesh(shape={"tile": 3, "sample": 2}, coords=(0, 0),
                          groups={"tile": None, "sample": None})
    with pytest.raises(ValueError, match="height 16 % tile 3"):
        tshard.render_film_sharded(grid, cam, scene, 8, 2)
    with pytest.raises(ValueError, match="height 16 % tile 3"):
        tshard.make_sharded_train_step(grid, cam, scene,
                                       torch.zeros(16, 16, 3), 8, 2)
    with pytest.raises(ValueError, match="samples 8 % ranks 6"):
        tshard.render_film_sharded_cuda(grid, cam, scene, 8, 2)
    with pytest.raises(ValueError, match="samples 8 % ranks 6"):
        tshard.render_film_sharded_beam(grid, cam, scene, 8, 2)


def test_train_step_needs_the_leaves_init_gave():
    """One rank: the step updates the dict init() made the optimizer's
    leaves, in place, and refuses another."""
    cam, scene = tpt.corner_scene(res=(8, 8), device="cpu")
    step, init = tshard.make_sharded_train_step(
        tmesh.make_mesh(), cam, scene, torch.zeros(8, 8, 3), 4, 2)
    params = tdiff.material_params(scene)
    params = {k: v.clone() for k, v in params.items()}
    before = {k: v.detach().clone() for k, v in params.items()}
    opt = init(params)
    out, opt, loss = step(params, opt, 0)
    assert out is params and float(loss) > 0
    assert any(not torch.equal(params[k], before[k]) for k in params)
    with pytest.raises(ValueError, match="leaves"):
        step({k: v.detach().clone() for k, v in params.items()}, opt, 1)


# -- 4 gloo ranks ----------------------------------------------------------

def test_ranks_coords_primary_and_gather(ranks):
    for r, res in enumerate(ranks):
        assert bool(res["primary"]) == (r == 0)
        for name, case in CASES.items():
            assert tuple(res[f"{name}/coords"]) == divmod(r, case["mesh"][1])
    want = np.concatenate([np.full((2, 3, 3), float(r), np.float32)
                           for r in range(WORLD)])
    np.testing.assert_array_equal(ranks[0]["gather"], want)
    assert all(res["gather"].size == 0 for res in ranks[1:])


def test_plain_film_matches_windows_and_jax(ranks):
    case = CASES["plain22"]
    got = _same_on_every_rank(ranks, "plain22")
    (jcam, jscene), (cam, scene) = _scenes(case)
    (n_tile, n_sample), spp = case["mesh"], case["spp"]
    band_h, spp_l = cam.height // n_tile, spp // n_sample
    table = ttrace.shade_table(scene)
    bands = []
    for t in range(n_tile):
        acc = tshard._trace_band(cam, scene, table, t * band_h, band_h, 0,
                                 spp_l, case["depth"], case["seed"])
        for s in range(1, n_sample):
            acc = acc + tshard._trace_band(cam, scene, table, t * band_h,
                                           band_h, s * spp_l, spp_l,
                                           case["depth"], case["seed"])
        bands.append(acc)
    np.testing.assert_array_equal(got, as_np(torch.cat(bands) / spp))
    want = jshard.render_film_sharded(
        jmake_mesh(WORLD, tile=n_tile, sample=n_sample), jcam, jscene, spp,
        case["depth"], seed=case["seed"])
    assert_films_close(got, want.data)


def _window_sums(case, fn, layout):
    """Single-process film from ``fn(sample0, spp, **band)`` over the
    windows each rank renders, added in rank order."""
    (n_tile, n_sample), spp = case["mesh"], case["spp"]
    if layout is None:
        spp_l = spp // WORLD
        acc = fn(0, spp_l)
        for r in range(1, WORLD):
            acc = acc + fn(r * spp_l, spp_l)
        return acc
    bands, spp_l = [], spp // n_sample
    for t in range(n_tile):
        acc = fn(0, spp_l, **layout(t))
        for s in range(1, n_sample):
            acc = acc + fn(s * spp_l, spp_l, **layout(t))
        bands.append(acc)
    return bands


@pytest.mark.parametrize("name", ["cuda41", "cuda22", "cuda_samples"])
def test_trace_kernel_film_matches_windows_and_jax(ranks, name):
    case = CASES[name]
    got = _same_on_every_rank(ranks, name)
    (jcam, jscene), (cam, scene) = _scenes(case)
    (n_tile, n_sample), spp = case["mesh"], case["spp"]
    assert _banded(case) == (name != "cuda_samples")
    band_h = cam.height // n_tile

    def window(s0, n, **band):
        return ttk.render_sum_reference(cam, scene, s0, n, case["depth"],
                                        seed=case["seed"], **band)
    if _banded(case):
        want = torch.cat(_window_sums(case, window, lambda t: dict(
            h0=t * band_h, band_h=band_h))) / spp
    else:
        want = _window_sums(case, window, None) / spp
    np.testing.assert_array_equal(got, as_np(want))
    if n_sample == 1:   # bands of one window: the single-process film
        np.testing.assert_array_equal(got, as_np(window(0, spp) / spp))
    jfilm = jshard.render_film_sharded_pallas(
        jmake_mesh(WORLD, tile=n_tile, sample=n_sample), jcam, jscene, spp,
        case["depth"], seed=case["seed"])
    assert_films_close(got, jfilm.data)
    assert got.max() > 0


@pytest.mark.parametrize("name", ["beam22", "beam_samples"])
def test_beam_kernel_film_matches_windows_and_jax(ranks, name):
    case = CASES[name]
    got = _same_on_every_rank(ranks, name)
    (jcam, jscene), (cam, scene) = _scenes(case)
    (n_tile, n_sample), spp = case["mesh"], case["spp"]
    wp, hp = tbk._padded_res(*cam.res)
    n_tiles = wp * hp // tbk.TILE_PX
    per_row = wp // tbk._SQ * (tbk._SQ_PIX // tbk.TILE_PX)
    banded = (n_tiles // n_tile) % per_row == 0 and n_tiles % n_tile == 0
    assert banded == (name == "beam22")
    tiles_l = n_tiles // n_tile

    def window(s0, n, **band):
        return tbk.render_tiles_beam_reference(
            cam, scene, s0, n, case["depth"], seed=case["seed"], **band)
    if banded:
        flat = torch.cat(_window_sums(case, window, lambda t: dict(
            tile0=t * tiles_l, n_tiles=tiles_l)), dim=1)
    else:
        flat = _window_sums(case, window, None)
    want = tbk._to_raster(flat, *cam.res) / spp
    np.testing.assert_array_equal(got, as_np(want))
    jfilm = jshard.render_film_sharded_beam(
        jmake_mesh(WORLD, tile=n_tile, sample=n_sample), jcam, jscene, spp,
        case["depth"], seed=case["seed"])
    assert_films_close(got, jfilm.data)
    assert got.max() > 0


def test_train_step_matches_jax(ranks):
    """3 steps on (2, 2): the parameters bit-identical on every rank after
    each step, and the losses and parameters of JAX's sharded step from
    the same start."""
    name = "train8"
    case = CASES[name]
    (jcam, jscene), _ = _scenes(case)
    n_tile, n_sample = case["mesh"]
    target = _same_on_every_rank(ranks, f"{name}/target")
    step, init = jshard.make_sharded_train_step(
        jmake_mesh(WORLD, tile=n_tile, sample=n_sample), jcam, jscene,
        jnp.asarray(target), case["spp"], case["depth"], seed=case["seed"],
        param_transform=jinv.to_materials)
    params = jinv.init_params(jscene)
    opt_state = init(params)
    losses = _same_on_every_rank(ranks, f"{name}/losses")
    assert np.all(np.isfinite(losses))
    for k in range(case["steps"]):
        params, opt_state, loss = step(params, opt_state, jnp.int32(k))
        np.testing.assert_allclose(losses[k], float(loss), rtol=LOSS_RTOL)
        for p in ("albedo", "emit", "roughness"):
            got = _same_on_every_rank(ranks, f"{name}/{k}/{p}")
            np.testing.assert_allclose(got, np.asarray(params[p]),
                                       atol=PARAM_ATOL, err_msg=f"{k} {p}")


def test_train_step_lowers_the_loss(ranks):
    """20 steps at 16^2 on (2, 2), as tests/test_parallel.py checks."""
    name = "train16"
    case = CASES[name]
    losses = _same_on_every_rank(ranks, f"{name}/losses")
    for k in range(case["steps"]):
        _same_on_every_rank(ranks, f"{name}/{k}/albedo")
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.8, losses
