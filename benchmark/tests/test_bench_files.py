"""The benchmark's files: BENCHMARK.json against the contract, every cell,
configuration, traffic mix and metric found by name, a new cell and a new
metric added as files alone, and no forbidden import."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
sys.path.insert(0, ROOT)

from benchmark.harness import core  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "pathtracer_tpu", "chip_smoke"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert [w["name"] for w in b["workloads"]] == [
        "cornell_offline", "garden_offline", "cornell_recover",
        "cornell_sharded4"]
    assert [w["chips"] for w in b["workloads"]] == [1, 1, 1, 4]
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        for cell in m["workloads"]:
            moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
            assert core.applies(moved, cell), (m["name"], cell)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        cell = w["name"]
        e2e = [m for m in b["end_to_end"] if core.applies(m, cell)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert any(core.applies(m, cell) for m in b["per_layer"])
        assert len(w["why"]) <= 200
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_finds_its_files_by_name():
    b = bench()
    for w in b["workloads"]:
        ctx = core.context(w["name"], 1, 1.0, False, 0.0)
        assert ctx.workload["config"] == w["config"]
        assert ctx.workload["traffic"] == w["traffic"]
        assert ctx.workload["chips"] == w["chips"]
        assert ctx.workload["limits"]
        assert core.driver(ctx.workload["driver"]).run
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for m in b["end_to_end"]:
        assert core.reader("e2e", m["name"]).compute
    for m in b["per_layer"]:
        assert core.reader("metrics", m["name"]).read


def test_a_new_cell_and_metric_are_files_alone(tmp_path, monkeypatch):
    """A later cell or metric adds files and entries; no existing file of
    the harness changes."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    b["workloads"].append({"name": "cornell_small", "config": "cornell_box",
                           "traffic": "offline_256_64", "chips": 1,
                           "why": "a new mix"})
    b["per_layer"].append({"name": "jobs.new", "unit": "jobs",
                           "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "rays_per_s",
                           "workloads": ["cornell_small"]})
    next(m for m in b["end_to_end"] if m["name"] == "rays_per_s")[
        "workloads"].append("cornell_small")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = json.loads((root / "benchmark/workloads/cornell_offline.json")
                      .read_text())
    cell["traffic"] = "offline_256_64"
    (root / "benchmark/workloads/cornell_small.json").write_text(
        json.dumps(cell))
    mix = json.loads((root / "benchmark/traffic/offline_1024_10k.json")
                     .read_text())
    mix.update(width=256, height=256, samples=64)
    (root / "benchmark/traffic/offline_256_64.json").write_text(
        json.dumps(mix))
    (root / "benchmark/metrics/jobs.new.py").write_text(
        "def read(trace):\n    return float(trace.requests)\n")
    monkeypatch.setattr(core, "BENCH", root / "benchmark")
    monkeypatch.setattr(core, "ROOT", root)
    ctx = core.context("cornell_small", 3, 1.0, True, 0.0)
    assert ctx.traffic["width"] == 256
    window = core.Window(1.5, [(0.0, 1.0), (1.0, 3.0)], [10.0, 10.0])
    e2e = core.e2e_metrics(core.benchmark_file(), "cornell_small", window)
    assert e2e["rays_per_s"]["value"] == pytest.approx(20.0 / 3.0)
    assert e2e["setup_s"]["value"] == 1.5

    class Trace:
        requests = 7
        ranks = []

        def idle_share(self):
            return None

    layer = core.per_layer_metrics(core.benchmark_file(), "cornell_small",
                                   Trace())
    assert layer == {"jobs.new": {"value": 7.0, "unit": "jobs"}}


def imported_roots(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def python_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in python_files(BENCH):
        for name in imported_roots(path):
            assert name not in FORBIDDEN, (path, name)
            assert not name.startswith("bench_torch"), (path, name)


def test_the_reference_imports_nothing_of_the_port():
    for path in python_files(os.path.join(BENCH, "reference")):
        assert "pathtracer_tpu_torch" not in set(imported_roots(path)), path
    for path in python_files(os.path.join(BENCH, "counts")):
        assert "pathtracer_tpu_torch" not in set(imported_roots(path)), path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pathtracer_tpu_torch_x", sys)
    assert "pathtracer_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pathtracer_tpu.render", sys)
    assert "pathtracer_tpu" in core.forbidden_modules()


def test_run_exits_without_a_card_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "cornell_offline", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_run_exits_where_only_the_benchmark_is(tmp_path):
    """In a checkout without the program the run fails and prints no
    result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cornell_offline",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_run_loads_no_jax(tmp_path):
    """A whole run on the CPU at a small size, in a fresh interpreter: the
    process that prints the result holds no JAX module."""
    script = tmp_path / "run_small.py"
    script.write_text(f"""
import dataclasses, sys, time
sys.path.insert(0, {ROOT!r})
from benchmark.harness import core
ctx = core.context("cornell_offline", 5, 0.2, False, time.perf_counter(),
                   device="cpu")
t = dict(ctx.traffic, width=8, height=8, samples=8, depth=2)
w = dict(ctx.workload, check=dict(ctx.workload["check"], tracer="mt",
         launch_spp=8, jobs=1, pixels=8))
ctx = dataclasses.replace(ctx, traffic=t, workload=w)
rc = core.finish(ctx, core.driver("render").run(ctx))
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "pathtracer_tpu")), file=sys.stderr)
sys.exit(rc)
""")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1] == "[]"
