"""The harness: one cell, one run, one result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, found by the name in ``BENCHMARK.json``:

  workloads/<cell>.json   config, traffic, driver, the check's sizes and
                          limits
  configs/<config>.json   the scene, camera and film of a deployment
  traffic/<traffic>.json  the jobs a client sends
  drivers/<driver>.py     set-up, one request, the check of its outputs
  e2e/<metric>.py         ``compute(window)`` over the window's requests
  metrics/<metric>.py     ``read(trace)`` over the traced window

A metric whose name has no file of its own is read by the file named by
the part before its first dot: ``rays_per_s.mesh`` by ``e2e/rays_per_s.py``,
so metrics that differ only in their cells and bound share one reader.

A driver's ``run(ctx)`` returns a ``Run``; ``finish`` turns it into the
result line.  A reader that finds nothing to read returns None and its
metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file of the benchmark, by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(folder: str, name: str):
    """The reader of metric ``name`` in ``benchmark/<folder>/``: the file
    of the full name, else the one of the part before the first dot."""
    path = BENCH / folder / f"{name}.py"
    if not path.exists():
        path = BENCH / folder / f"{name.split('.')[0]}.py"
    return load_module(path)


@dataclasses.dataclass
class Context:
    """What a driver needs for one run."""
    cell: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t0: float                   # the process's start on the host clock
    device: str = "cuda"        # "cpu" only in the harness's own tests


def context(cell: str, seed: int, seconds: float, trace: bool, t0: float,
            device: str = "cuda") -> Context:
    wl = load_json(BENCH / "workloads" / f"{cell}.json")
    return Context(cell, wl, load_json(BENCH / "configs"
                                       / f"{wl['config']}.json"),
                   load_json(BENCH / "traffic" / f"{wl['traffic']}.json"),
                   int(seed), float(seconds), bool(trace), t0, device)


def rng_for(seed: int, *salt: int):
    """A numpy generator of the run's seed (any whole number) and a salt
    of the draw."""
    import numpy as np
    return np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                  (int(seed) >> 32) & 0xFFFFFFFF, *salt])


def driver(name: str):
    """``benchmark/drivers/<name>.py``, imported by name: a driver that
    starts processes hands them its functions by name."""
    return importlib.import_module(f"benchmark.drivers.{name}")


@dataclasses.dataclass
class Window:
    """The timed requests: host-clock (start, end) and the work of each."""
    setup_s: float
    spans: List[tuple]
    work: List[float]

    @property
    def seconds(self) -> float:
        return self.spans[-1][1] - self.spans[0][0]


@dataclasses.dataclass
class Run:
    """What a driver hands back: the window, the check, the device, and in
    a traced run what the readers read."""
    window: Window
    checks: Dict[str, dict]
    correct: bool
    device: dict
    trace: Optional[object] = None      # harness.trace.TraceRun
    failed: int = 0


def closed_loop(request: Callable[[int], None], sync: Callable[[], None],
                seconds: float, mark: Callable[[str], object]) -> List[tuple]:
    """One client that sends request i + 1 when request i has ended, until
    ``seconds`` have passed: every request is whole and synchronised.
    ``mark(name)`` is a context manager that names a span in the trace."""
    spans = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        with mark("bench.request"):
            request(i)
            sync()
        t1 = time.perf_counter()
        spans.append((t0, t1))
        i += 1
        if t1 - start >= seconds:
            return spans


def benchmark_file() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def e2e_metrics(bench: dict, cell: str, window: Window) -> dict:
    out = {}
    for m in bench["end_to_end"]:
        if applies(m, cell):
            v = reader("e2e", m["name"]).compute(window)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def per_layer_metrics(bench: dict, cell: str, trace) -> dict:
    out = {}
    for m in bench["per_layer"]:
        if applies(m, cell):
            v = reader("metrics", m["name"]).read(trace)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the port must not load:
    JAX and the JAX package, compared whole (the port's name begins with
    the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def finish(ctx: Context, run: Run) -> int:
    """Print the checks on stderr and the result line on stdout; returns
    the exit code."""
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    bench = benchmark_file()
    if ctx.trace:
        metrics = per_layer_metrics(bench, ctx.cell, run.trace)
    else:
        metrics = e2e_metrics(bench, ctx.cell, run.window)
    result = {"correct": bool(run.correct),
              "attempted": len(run.window.spans),
              "failed": run.failed, "metrics": metrics, "device": run.device}
    if ctx.trace and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {n: {"value": _number(c["value"]), "limit": c["limit"]}
                        for n, c in run.checks.items()}
    for name, c in run.checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def _number(x: float) -> float:
    """JSON has no infinity or NaN: a check that read one prints 1e300."""
    return x if math.isfinite(x) else 1e300
