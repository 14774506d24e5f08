"""The shade table's gather by id (ops/cuda/gather_kernel.py,
csrc/gather_kernel.cu) and its routing from ops/trace.gather_features.

On the CPU ``gather_rows`` is its plain version, ``gather_rows_reference``
(``index_select`` of the clamped ids, then zeros where an id is < 0),
forward and gradient, and it refuses what the kernels would not take
before it looks at the device.  On the card (marked ``cuda``; this file
imports no JAX, so ``pytest --noconftest -m cuda tests/`` collects it): the
forward is the plain version's copy bit for bit; the backward, an order-fixed
segment sum, is within GATHER_GRAD_RTOL of a float64 ``index_add_`` and the
same bits on every run, at the garden recovery's shape and at the launch
shapes around the kernels' chunk edges, on the normal library and the
bounds-checked one; and a garden recovery step launches both 2 x depth
times.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.ops import trace as ttrace
from pathtracer_tpu_torch.ops.cuda import gather_kernel as tgk

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SOURCE = Path(REPO) / "pathtracer_tpu_torch" / "csrc" / "gather_kernel.cu"


def _table(rows, cols=12, seed=0):
    gen = np.random.default_rng(seed)
    return torch.from_numpy(gen.normal(size=(rows, cols)).astype(np.float32))


def _ids(shape, rows, seed=1):
    gen = np.random.default_rng(seed)
    return torch.from_numpy(gen.integers(-1, rows, shape).astype(np.int32))


# -- the CPU: the plain version, and the checks ------------------------------

@pytest.mark.parametrize("shape,rows,cols", [((37,), 40, 12),
                                             ((3, 5, 7), 9, 4),
                                             ((0,), 5, 12),
                                             ((64,), 1, 16)])
def test_cpu_table_takes_the_plain_version(shape, rows, cols):
    """Forward and gradient of ``gather_rows`` on a CPU table are
    ``gather_rows_reference``'s, and nothing is launched."""
    table = _table(rows, cols)
    ids = _ids(shape, rows)
    grad = torch.from_numpy(np.random.default_rng(2).normal(
        size=shape + (cols,)).astype(np.float32))
    before = dict(tgk.LAUNCHES)
    leaf = table.clone().requires_grad_(True)
    got = tgk.gather_rows(leaf, ids)
    (got_grad,) = torch.autograd.grad(got, leaf, grad)
    ref_leaf = table.clone().requires_grad_(True)
    want = tgk.gather_rows_reference(ref_leaf, ids)
    (want_grad,) = torch.autograd.grad(want, ref_leaf, grad)
    assert got.shape == shape + (cols,)
    assert torch.equal(got, want) and torch.equal(got_grad, want_grad)
    assert bool((got[ids < 0] == 0).all())
    assert tgk.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("grad", [False, True])
def test_gather_features_takes_the_plain_version_on_the_cpu(dtype, grad):
    """Above ONEHOT_GATHER_MAX_ROWS, or without a gradient, a CPU table's
    gather is ``gather_rows_reference``, whatever the id type."""
    rows = ttrace.ONEHOT_GATHER_MAX_ROWS + 3
    table = _table(rows).requires_grad_(grad)
    ids = _ids((6, 11), rows).to(dtype)
    got = ttrace.gather_features(table, ids)
    assert got.requires_grad == grad
    assert torch.equal(got, tgk.gather_rows_reference(table, ids))


def _nonc(x):
    """A tensor like ``x``, not contiguous."""
    return x.t().contiguous().t() if x.dim() == 2 else x.repeat(2)[::2]


REFUSALS = {
    "int64 ids": (lambda t, i: (t, i.long()), "int32"),
    "float64 table": (lambda t, i: (t.double(), i), "float32"),
    "strided table": (lambda t, i: (_nonc(t), i), "contiguous"),
    "strided ids": (lambda t, i: (t, _nonc(i)), "contiguous"),
    "a 24-byte row": (lambda t, i: (t[:, :6].contiguous(), i), "16-byte"),
    "a table of no rows": (lambda t, i: (t[:0], i), "T >= 1"),
    "a flat table": (lambda t, i: (t.reshape(-1), i), "T >= 1"),
    "mixed devices": (lambda t, i: (t.to("meta"), i), "table on meta"),
    "another device": (lambda t, i: (t.to("meta"), i.to("meta")),
                       "runs on CUDA"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_what_the_kernels_do_not_take(case):
    """The checks come before the device branch: a CPU call is refused as
    a CUDA one would be, and nothing is launched."""
    make, match = REFUSALS[case]
    table, ids = make(_table(20), _ids((33,), 20))
    before = dict(tgk.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        tgk.gather_rows(table, ids)
    assert tgk.LAUNCHES == before


def test_backward_source_takes_no_float_atomic():
    """The table's gradient is a sum in a fixed order: the kernels' source
    takes no atomic at all, so no float one."""
    code = "\n".join(line.split("//")[0]
                     for line in SOURCE.read_text().splitlines())
    assert "atomic" not in code.lower()


# -- the card -----------------------------------------------------------------

# Relative L2 of the table's gradient against a float64 index_add_, for
# gradient rows of terms in [0, 1).  Each row's sum is a chain of at most
# kItems - 1 = 7 sequential adds in a thread, 8 levels of the block's scan
# tree, and one add a chunk of 2,048 sorted ids its ids span: at the
# garden's shape a wall row of ~210,000 ids spans <= 104 chunks, so with
# terms >= 0 a row is off by at most ~120 * 2^-24 = 7.2e-6 of itself.
GATHER_GRAD_RTOL = 1e-5

GARDEN_ROWS = 105_712         # the garden's shade table, padded
GARDEN_IDS = 4_194_304        # a bounce of a 256^2, 64-spp half-film
WALL_ROWS = 12


def garden_ids(n=GARDEN_IDS, rows=GARDEN_ROWS, seed=24):
    """(n,) int32 ids as a garden bounce gives them: ~60% on 12 "wall"
    rows, ~20% misses and dead rays (-1), the rest uniform."""
    gen = np.random.default_rng(seed)
    walls = gen.choice(rows, WALL_ROWS, replace=False)
    u = gen.random(n)
    ids = np.where(u < 0.6, walls[gen.integers(0, WALL_ROWS, n)],
                   np.where(u < 0.8, -1, gen.integers(0, rows, n)))
    return torch.from_numpy(ids.astype(np.int32))


def _ramp(n):
    """n sorted ids, runs of every length from 1 up, so runs end inside
    threads, at thread edges and across the 2,048-id chunks."""
    return torch.from_numpy(np.repeat(np.arange(n), np.arange(1, n + 1))
                            .astype(np.int32))


# (rows, cols, ids) at the shapes around the kernels' edges.
CASES = {
    "one id": (1, 12, lambda: torch.zeros(1, dtype=torch.int32)),
    "no ids": (5, 12, lambda: torch.zeros(0, dtype=torch.int32)),
    "all misses": (5, 12, lambda: torch.full((3000,), -1,
                                             dtype=torch.int32)),
    "one row": (7, 12, lambda: torch.full((5000,), 3, dtype=torch.int32)),
    "chunk edge": (40, 12, lambda: _ids((4097,), 40, seed=3)),
    "sorted runs": (130, 12, lambda: _ramp(130)),
    "skewed": (1000, 12, lambda: garden_ids(100_000, 1000, seed=5)),
    "shaped ids": (50, 12, lambda: _ids((3, 5, 77), 50, seed=6)),
    "four floats": (300, 4, lambda: _ids((10_000,), 300, seed=7)),
    "eight floats": (300, 8, lambda: _ids((10_000,), 300, seed=8)),
    "twenty floats": (300, 20, lambda: _ids((10_000,), 300, seed=9)),
}


def gather_case(device, rows, cols, ids, seed=10):
    """The forward's and the backward's errors on one case: (forward equal
    to the plain version, relative L2 of the gradient against float64, two
    backward runs equal)."""
    ids = ids.to(device)
    table = _table(rows, cols).to(device)
    gen = np.random.default_rng(seed)
    grad = torch.from_numpy(gen.random(tuple(ids.shape) + (cols,))
                            .astype(np.float32)).to(device)
    leaf = table.clone().requires_grad_(True)
    got = tgk.gather_rows(leaf, ids)
    equal = torch.equal(got, tgk.gather_rows_reference(table, ids))
    grads = [torch.autograd.grad(tgk.gather_rows(leaf, ids), leaf, grad)[0]
             for _ in range(2)]
    ok = ids >= 0
    want = torch.zeros((rows, cols), dtype=torch.float64, device=device)
    want.index_add_(0, ids[ok].long(), grad[ok].double())
    err = float((grads[0].double() - want).norm()
                / want.norm().clamp_min(1e-30))
    return equal, err, torch.equal(grads[0], grads[1])


def checked_cases():
    """Every case of CASES on the bounds-checked library (an index out of
    range traps, naming the kernel, the array and the index); run in a
    child with CUDA_LAUNCH_BLOCKING=1 by ``run_checked_cases``.  Exits 1 if
    a case fails its bars."""
    from unittest import mock

    from pathtracer_tpu_torch.utils import build

    dev = torch.device("cuda", 0)
    checked = build.load_library(checked=True)
    failed = []
    with mock.patch.object(build, "load_library", lambda *a, **k: checked):
        for name, (rows, cols, make) in CASES.items():
            equal, err, same = gather_case(dev, rows, cols, make())
            if not (equal and err <= GATHER_GRAD_RTOL and same):
                failed.append((name, equal, err, same))
    torch.cuda.synchronize()
    print(f"checked cases: {len(CASES)}, failed: {failed}", flush=True)
    sys.exit(1 if failed else 0)


def run_checked_cases():
    code = (f"import sys; sys.path[:0] = [{TESTS!r}, {REPO!r}]; "
            f"import test_torch_gather_kernel as t; t.checked_cases()")
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, CUDA_LAUNCH_BLOCKING="1"))


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: these tests run on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run `pytest -m cuda` "
                    "on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_garden_shape_forward_copies_and_backward_is_fixed(cuda_device):
    """4,194,304 garden-like ids into the garden's 105,712-row table: the
    forward equals the plain version bit for bit; the backward is within
    GATHER_GRAD_RTOL of float64 and the same bits twice; one launch of each
    a call."""
    before = dict(tgk.LAUNCHES)
    equal, err, same = gather_case(cuda_device, GARDEN_ROWS, 12,
                                   garden_ids())
    torch.cuda.synchronize()
    assert equal and same and err <= GATHER_GRAD_RTOL, (equal, err, same)
    assert tgk.LAUNCHES["forward"] == before["forward"] + 3
    assert tgk.LAUNCHES["backward"] == before["backward"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_gather_cases_match_plain(cuda_device, case):
    rows, cols, make = CASES[case]
    equal, err, same = gather_case(cuda_device, rows, cols, make())
    torch.cuda.synchronize()
    assert equal and same and err <= GATHER_GRAD_RTOL, (equal, err, same)


@pytest.mark.cuda
def test_gather_cases_on_the_checked_library(cuda_device):
    done = run_checked_cases()
    assert done.returncode == 0, done.stdout[-20000:] + done.stderr[-20000:]


@pytest.mark.cuda
def test_gather_kernels_write_only_their_outputs(cuda_device, monkeypatch):
    """The forward's rows, the backward's gradient and its partial slots
    sit between NaN guard margins that come back untouched."""
    import _torch_card as card

    guard = card.GuardedTorch()
    monkeypatch.setattr(tgk, "torch", guard)
    equal, err, same = gather_case(cuda_device, 1000, 12,
                                   garden_ids(20_000, 1000, seed=11))
    torch.cuda.synchronize()
    assert len(guard.buffers) >= 3 and guard.hits() == 0
    assert equal and same and err <= GATHER_GRAD_RTOL, (equal, err, same)


@pytest.mark.cuda
def test_gather_wrapper_does_not_synchronise(cuda_device):
    """Forward and backward return while earlier work on the stream still
    runs: the sort and both passes are queued, the ids never read."""
    import time

    ids = garden_ids(1 << 20, 4096, seed=12).to(cuda_device)
    table = _table(4096).to(cuda_device).requires_grad_(True)
    grad = torch.ones((1 << 20, 12), device=cuda_device)
    torch.autograd.grad(tgk.gather_rows(table, ids), table, grad)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of device time at ~2 GHz
    t0 = time.perf_counter()
    torch.autograd.grad(tgk.gather_rows(table, ids), table, grad)
    seconds = time.perf_counter() - t0
    pending = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert pending and seconds < 0.25


@pytest.mark.cuda
def test_garden_step_launches_the_pair_a_bounce(cuda_device):
    """One paired recovery step on the garden (64^2, 8 spp, depth 4,
    "cluster"): its table is above ONEHOT_GATHER_MAX_ROWS, so each bounce
    of both renders gathers through the kernel pair, forward and
    backward: 2 x depth calls of each."""
    import _torch_card as card
    from pathtracer_tpu_torch import inverse

    cam, sb = tpt.meshes.mesh_garden(device=cuda_device)
    scene = sb.build(device=cuda_device)
    assert scene.padded_size > ttrace.ONEHOT_GATHER_MAX_ROWS
    cam = card.with_res(cam, (64, 64))
    target = torch.full((64, 64, 3), 0.2, device=cuda_device)
    depth = 4
    before = dict(tgk.LAUNCHES)
    _, losses = inverse.recover_materials(
        cam, scene, target, steps=1, samples=8, depth=depth, lr=0.08,
        backend="cluster", optimize=("albedo",))
    torch.cuda.synchronize()
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert tgk.LAUNCHES["forward"] == before["forward"] + 2 * depth
    assert tgk.LAUNCHES["backward"] == before["backward"] + 2 * depth
