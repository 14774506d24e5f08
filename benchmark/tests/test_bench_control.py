"""The control of each cell's check, the reference in bfloat16 in the
program's place, fails the check: at a small size on the CPU, and at the
cell's own size on a card (marker ``cuda``; run there with
``python -m pytest benchmark/tests/test_bench_control.py -m cuda``)."""

import dataclasses
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import control  # noqa: E402
from benchmark.harness import core  # noqa: E402

CELLS = ["cornell_offline", "garden_offline", "cornell_recover",
         "cornell_sharded4"]


def small(cell, seed):
    ctx = core.context(cell, seed, 0.0, False, 0.0, device="cpu")
    t, w = dict(ctx.traffic), json.loads(json.dumps(ctx.workload))
    c = json.loads(json.dumps(ctx.config))
    if cell == "garden_offline":
        t.update(width=64, height=64, samples=4, depth=2)
        c["scene"].update(grid=2, n_lat=6, n_lon=8)
        w["check"].update(launch_spp=4, jobs=1, pixels=64)
    elif cell == "cornell_recover":
        t.update(width=8, height=8, samples=8, target_samples=16, depth=3)
    else:
        t.update(width=16, height=16, samples=64, depth=3)
        w["check"].update(launch_spp=16, jobs=1, pixels=128)
    return dataclasses.replace(ctx, traffic=t, workload=w, config=c)


def fails(readings, limits):
    return any(readings[n] > limits[n] for n in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_a_small_size(cell):
    ctx = small(cell, 2**31 + 21)
    assert fails(control.readings(ctx, torch.device("cpu"),
                                  window_steps=2), ctx.workload["limits"])


def test_half_batch_fault_fails_the_recovery_check():
    ctx = small("cornell_recover", 7)
    assert fails(control.readings(ctx, torch.device("cpu"), "half_batch",
                                  window_steps=2), ctx.workload["limits"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_at_the_cells_size(cell, seed, card):
    ctx = core.context(cell, seed, 0.0, False, 0.0)
    assert fails(control.readings(ctx, card), ctx.workload["limits"])
