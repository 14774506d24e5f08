"""Whole runs of each cell on the CPU at small sizes, past the harness's
look for a card: sound, ``correct`` is true; with the timed path broken
underneath, once for each fault the cell can have, it is false."""

import dataclasses
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import core  # noqa: E402

import importlib  # noqa: E402

from pathtracer_tpu_torch import inverse  # noqa: E402
from pathtracer_tpu_torch.image import Film  # noqa: E402
from pathtracer_tpu_torch.parallel import shard  # noqa: E402

SEED = 2**31 + 3
# The package exports a function of the module's name.
render = importlib.import_module("pathtracer_tpu_torch.render")


def small(cell, seconds=0.3):
    ctx = core.context(cell, SEED, seconds, False, time.perf_counter(),
                       device="cpu")
    t = dict(ctx.traffic)
    w = json.loads(json.dumps(ctx.workload))
    c = json.loads(json.dumps(ctx.config))
    if cell == "garden_offline":
        t.update(width=64, height=64, samples=4, depth=2, backend="beam")
        c["scene"].update(grid=2, n_lat=6, n_lon=8)
        w["check"].update(launch_spp=4, jobs=1, pixels=32)
    elif cell == "cornell_recover":
        t.update(width=8, height=8, samples=8, target_samples=16, depth=3)
    else:
        t.update(width=16, height=16, samples=16, depth=3)
        w["check"].update(tracer="mt", launch_spp=16, jobs=2, pixels=64)
    return dataclasses.replace(ctx, traffic=t, workload=w, config=c)


def run(ctx):
    return core.driver(ctx.workload["driver"]).run(ctx)


def altered(fn):
    """The film altered where it is produced: every value 1% brighter."""
    def wrapper(*a, **k):
        film = fn(*a, **k)
        return Film((film.width, film.height), data=film.data * 1.01)
    return wrapper


def half_the_samples(fn):
    """Half the job's samples left out, the mean taken over the rest."""
    def wrapper(camera, scene, samples, *a, **k):
        return fn(camera, scene, max(1, samples // 2), *a, **k)
    return wrapper


@pytest.mark.parametrize("cell", ["cornell_offline", "garden_offline"])
def test_render_cells(cell, monkeypatch):
    sound = run(small(cell))
    assert sound.correct, sound.checks
    assert sound.checks["film_gap"]["value"] == 0.0
    for fault in (altered, half_the_samples):
        with monkeypatch.context() as m:
            m.setattr(render, "render_film", fault(render.render_film))
            broken = run(small(cell))
        assert not broken.correct, (fault.__name__, broken.checks)


def no_step(self, closure=None):
    """A step that returns its state unchanged."""
    return None


def value_over_half(self, params, k):
    """The paired loss over the top half of the film's rows only."""
    mats = inverse.to_materials(params)
    t = self.target
    rows = t.shape[0] // 2
    half = max(self.samples // 2, 1)
    a = self.render(mats, half, k * self.samples)[:rows]
    b = self.render(mats, self.samples - half,
                    k * self.samples + half)[:rows]
    wgt = 1.0 / (t[:rows] + self.rel_eps) ** 2
    return torch.mean(wgt * (a - t[:rows]) * (b - t[:rows]))


def frozen_in_the_window(train_step):
    """Set-up's steps sound, and every step of the window one that returns
    its state unchanged: a fault of the steady state alone."""
    steps = core.context("cornell_recover", 1, 0.0, False, 0.0).workload[
        "check"]["steps"]

    def wrapper(pb, params, opt, k, lr):
        if k < steps:
            return train_step(pb, params, opt, k, lr)
        opt.step = no_step.__get__(opt)
        try:
            return train_step(pb, params, opt, k, lr)
        finally:
            del opt.step
    return wrapper


def test_recover_cell(monkeypatch):
    sound = run(small("cornell_recover"))
    assert sound.correct, sound.checks
    with monkeypatch.context() as m:
        m.setattr(torch.optim.Adam, "step", no_step)
        broken = run(small("cornell_recover"))
    assert not broken.correct
    assert broken.checks["update_gap"]["value"] == pytest.approx(1.0)
    with monkeypatch.context() as m:
        m.setattr(inverse._Problem, "value", value_over_half)
        broken = run(small("cornell_recover"))
    assert not broken.correct, broken.checks
    with monkeypatch.context() as m:
        m.setattr(inverse, "_train_step",
                  frozen_in_the_window(inverse._train_step))
        broken = run(small("cornell_recover"))
    assert not broken.correct, broken.checks
    limit = broken.checks["window_update_gap"]["limit"]
    assert broken.checks["window_update_gap"]["value"] > limit
    assert broken.checks["update_gap"]["value"] <= limit


def gather_left_out(x, group=None, n=None):
    """The exchange between ranks left out: each rank's own band stands in
    for every band."""
    n = 1 if n is None else n
    return [x] * n


def faulty_child(rank, world, port, ctx, tmp):
    shard.all_gather = gather_left_out
    from benchmark.drivers import sharded
    sharded.rank_main(rank, world, port, ctx, tmp)


def test_sharded_cell(monkeypatch):
    from benchmark.drivers import sharded
    sound = run(small("cornell_sharded4"))
    assert sound.correct, sound.checks
    assert sound.device["count"] == 4
    with monkeypatch.context() as m:
        m.setattr(shard, "all_gather", gather_left_out)
        m.setattr(sharded, "_child", faulty_child)
        broken = run(small("cornell_sharded4"))
    assert not broken.correct, broken.checks
