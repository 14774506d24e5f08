"""The port's recovery on the garden through the cluster intersection held
against the benchmark's plain mesh recovery
(``benchmark/reference/recover_mesh.py``) on the CPU: the program's steps
within the ``garden_recover`` cell's limits, the grouped reference equal
to the dense one bit for bit, ``step_from`` equal to ``run``'s steps, and
the ``pt.diff.render`` span's count."""

import json
import math
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.reference import compare, scenes  # noqa: E402
from benchmark.reference.recover import Recovery, start_params  # noqa: E402
from benchmark.reference.recover_mesh import (MeshRecovery,  # noqa: E402
                                               nearest_hits, tracer)
from benchmark.reference.render import mt_intersector  # noqa: E402

from pathtracer_tpu_torch import diff, inverse  # noqa: E402
from pathtracer_tpu_torch.camera import make_camera  # noqa: E402
from pathtracer_tpu_torch.ops.trace import ONEHOT_GATHER_MAX_ROWS  # noqa: E402
from pathtracer_tpu_torch.scene import Scene  # noqa: E402

SEED = 2**33 + 23
CPU = torch.device("cpu")


def _json(*parts):
    with open(os.path.join(ROOT, "benchmark", *parts)) as f:
        return json.load(f)


CELL = _json("workloads", "garden_recover.json")
TRAFFIC = _json("traffic", "recover_256_128_cluster.json")


def garden(grid, n_lat=None, n_lon=None):
    cfg = _json("configs", "garden105708_inverse.json")
    cfg["scene"]["grid"] = grid
    if n_lat is not None:
        cfg["scene"].update(n_lat=n_lat, n_lon=n_lon)
    return cfg


def program(cfg, res, target, samples, depth, optimize):
    """The benchmark driver's training state: the grey start, Adam and the
    program's ``_Problem`` over the cluster intersection."""
    arrays = scenes.make_scene(cfg)
    camera = make_camera(**scenes.camera_args(cfg, res), device="cpu")
    scene = Scene.from_arrays(*arrays.as_args(), device="cpu")
    p0 = start_params(arrays, CPU)
    params = {n: p0[n].clone().requires_grad_(True)
              for n in inverse.PARAM_NAMES}
    opt = torch.optim.Adam([params[n] for n in inverse.PARAM_NAMES],
                           lr=TRAFFIC["lr"], betas=inverse.ADAM_BETAS,
                           eps=inverse.ADAM_EPS)
    pb = inverse._Problem(
        camera=camera, scene=scene, target=target, samples=samples,
        depth=depth, seed=SEED, backend="cluster",
        accel=diff.make_accel(scene, "cluster"), loss="paired",
        rel_eps=2e-2, masks=inverse._row_masks(scene, optimize),
        rough_spsa=False)
    return arrays, p0, params, opt, pb


def target_of(cfg, res, samples, depth):
    arrays = scenes.make_scene(cfg)
    cam = scenes.make_camera(cfg, res)
    pix = torch.arange(res[0] * res[1])
    return tracer(arrays, cam, CPU).film(
        pix % res[0], pix // res[0], samples, depth, SEED ^ 0x7A26E7,
        samples).reshape(res[1], res[0], 3)


def test_program_steps_follow_the_reference_within_the_cells_limits():
    """Three steps of the program on a garden of about 19k triangles (its
    shade table above the one-hot gather's rows), 16^2, 4 spp, depth 4:
    each loss, the first gradient and the update within the cell's
    limits."""
    cfg, res, spp, depth = garden(3), (16, 16), 4, 4
    optimize = tuple(TRAFFIC["optimize"])
    target = target_of(cfg, res, 8, depth)
    arrays, p0, params, opt, pb = program(cfg, res, target, spp, depth,
                                          optimize)
    assert arrays.v1.shape[0] > ONEHOT_GATHER_MAX_ROWS
    steps = CELL["check"]["steps"]
    losses, first = [], None
    for k in range(steps):
        losses.append(inverse._train_step(pb, params, opt, k, TRAFFIC["lr"]))
        if k == 0:
            first = {n: opt.state[params[n]]["exp_avg"] / (1 - 0.9)
                     for n in inverse.PARAM_NAMES}
    ref = MeshRecovery(arrays, scenes.make_camera(cfg, res), target,
                       samples=spp, depth=depth, seed=SEED, lr=TRAFFIC["lr"],
                       optimize=optimize, device=CPU)
    ref_losses, ref_first, ref_last, _ = ref.run(p0, steps)
    counted = compare.counted_leaves(ref_first)
    assert "albedo" in counted
    limits = CELL["limits"]
    assert max(compare.rel_gap(a, b) for a, b in zip(losses, ref_losses)) \
        <= limits["loss_gap"]
    assert compare.leaf_gaps(first, ref_first, counted) <= limits["grad_gap"]
    change = {n: params[n].detach() - p0[n] for n in inverse.PARAM_NAMES}
    ref_change = {n: ref_last[n] - p0[n] for n in inverse.PARAM_NAMES}
    assert float(change["albedo"].abs().max()) > 0.05
    assert compare.leaf_gaps(change, ref_change, counted) \
        <= limits["update_gap"]


def test_two_level_test_equals_the_dense_test():
    """A garden of about 8.6k triangles (several top boxes): rays from all
    over the room and the camera's own rays, nearest distances and
    triangles bit for bit, across batches."""
    arrays = scenes.make_scene(garden(2))
    assert arrays.num_tris > 32 * 32 * 4
    dense = mt_intersector(arrays, CPU, pairs_per_chunk=1 << 22)
    grouped = nearest_hits(arrays, CPU, rays_per_batch=700)
    g = torch.Generator().manual_seed(5)
    o = torch.rand(2000, 3, generator=g) * 520.0 - 10.0
    d = torch.randn(2000, 3, generator=g)
    d[::7, 0] = 0.0                     # rays along a box's face
    d = d / d.norm(dim=-1, keepdim=True)
    for rays in ((o, d), (torch.tensor([[250.0, 330.0, -420.0]]).expand(
            2000, 3), d.abs() * torch.tensor([0.4, -0.3, 1.0]))):
        t_d, id_d = dense(*rays)
        t_g, id_g = grouped(*rays)
        assert torch.equal(id_d, id_g) and torch.equal(t_d, t_g)
        assert int((id_d >= 0).sum()) > 500


def small_recoveries(dtype=torch.float32):
    cfg, res = garden(2, 6, 8), (8, 8)
    arrays = scenes.make_scene(cfg)
    cam = scenes.make_camera(cfg, res)
    target = target_of(cfg, res, 8, 3)
    kw = dict(samples=4, depth=3, seed=SEED, lr=0.08, optimize=("albedo",),
              device=CPU, dtype=dtype)
    return (arrays, Recovery(arrays, cam, target, **kw),
            MeshRecovery(arrays, cam, target, **kw))


def test_grouped_recovery_equals_the_dense_one_bit_for_bit():
    arrays, dense, grouped = small_recoveries()
    p0 = start_params(arrays, CPU)
    a, b = dense.run(p0, 2), grouped.run(p0, 2)
    assert a[0] == b[0] and all(math.isfinite(x) for x in a[0])
    for n in ("albedo", "emit", "roughness"):
        assert torch.equal(a[1][n], b[1][n]) and torch.equal(a[2][n], b[2][n])
    assert not torch.equal(a[2]["albedo"], p0["albedo"])


def test_step_from_equals_runs_steps():
    """Three steps of ``step_from`` chained from the grey start and zero
    moments equal ``run``'s three steps: each loss and the parameters
    after each step."""
    arrays, _, grouped = small_recoveries()
    p = start_params(arrays, CPU)
    losses, _, last, kept = grouped.run(p, 3, at=(1, 2))
    m = {n: torch.zeros_like(x) for n, x in p.items()}
    v = {n: torch.zeros_like(x) for n, x in p.items()}
    for k in range(3):
        loss, p, m, v = grouped.step_from(p, m, v, k, k)
        assert loss == losses[k]
        want = kept[k + 1] if k < 2 else last
        for n in p:
            assert torch.equal(p[n], want[n])


@pytest.mark.parametrize("depth", [1, 4])
def test_diff_render_span_twice_a_paired_step_whatever_the_depth(depth):
    cfg, res = garden(2, 6, 8), (8, 8)
    target = torch.zeros((8, 8, 3))
    _, _, params, opt, pb = program(cfg, res, target, 4, depth, ("albedo",))
    inverse._train_step(pb, params, opt, 0, 0.08)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in (1, 2):
            inverse._train_step(pb, params, opt, k, 0.08)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith("pt.")),
                   key=lambda s: s[1])
    renders = [s for s in spans if s[0] == "pt.diff.render"]
    forwards = [s for s in spans if s[0] == "pt.step.forward"]
    assert len(renders) == 4 and len(forwards) == 2
    for f in forwards:
        assert sum(f[1] <= r[1] and r[2] <= f[2] for r in renders) == 2
