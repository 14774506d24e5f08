"""bench_torch.py on the CPU: every cell but the garden's at 16^2 (the
kernels' wrappers take their plain versions on CPU tensors), the timing
protocol on a stubbed clock, the slice and film checks against a one-ulp
mutation, the golden means, the light check's ties, the
verdict of chip_smoke.py's phase 14 and its resource table, and that the
script neither loads JAX nor falls back to the CPU.

The sphere cells run on a stand-in for meshes.sphere_in_box(50, 100): a
180-triangle sphere in the same lit room, seen from a camera tilted up to
the light (the plain beam version's dense test of 9,812 rows costs seconds
a sample here, and a depth-2 film of the stock view is black at 2 spp)."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.ops.cuda import beam_kernel as tbk
from pathtracer_tpu_torch.ops.cuda import cluster_kernel as tck
from pathtracer_tpu_torch.ops.cuda import trace_kernel as ttk
from pathtracer_tpu_torch.utils import timer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402

TINY = ["--device", "cpu", "--res", "16", "--large-res", "16", "--spp", "2",
        "--refconfig-spp", "2", "--large-spp", "2", "--garden-spp", "2",
        "--wavefront-spp", "1", "--depth", "2", "--repeats", "1",
        "--refconfig-repeats", "1"]
CPU_CELLS = [c for c in bench_torch.CELLS if c != "garden105708_beam"]
METRICS = {
    "cornell1024": "rays_per_sec_cornell16",
    "cornell1024_refconfig": "rays_per_sec_cornell16_refconfig_2spp",
    "specular1024": "rays_per_sec_specular16",
    "sphere9812_beam": "rays_per_sec_bvh_180tris_16",
    "sphere9812_cluster": "rays_per_sec_bvh_cluster_16",
    "wavefront512_d5": "rays_per_sec_wavefront_16_d5",
    "wavefront512_d16": "rays_per_sec_wavefront_16_d16",
}
_SPHERE_IN_BOX = tpt.meshes.sphere_in_box


def small_sphere(n_lat=50, n_lon=100, device="cuda"):
    _, sb = _SPHERE_IN_BOX(8, 12, device=device)
    cam = tpt.make_camera((250, 250, -420), (0, 0.35, 1), (0, 1, 0),
                          (16, 16), 60 * tpt.DEG2RAD, 1.0, device=device)
    return cam, sb


def run_bench(argv, capsys):
    """(exit code, the printed JSON lines) of bench_torch.main."""
    rc = bench_torch.main(argv)
    out = capsys.readouterr().out
    return rc, [json.loads(x) for x in out.splitlines()
                if x.startswith("{")]


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """One run of every cell but the garden's: (exit code, the printed
    lines, the lines of --out)."""
    out = tmp_path_factory.mktemp("bench") / "bench_torch.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpt.meshes, "sphere_in_box", small_sphere)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench_torch.main(TINY + ["--cells", ",".join(CPU_CELLS),
                                          "--out", str(out)])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    return rc, lines, [json.loads(x) for x in out.read_text().splitlines()]


def test_cpu_run_prints_a_line_per_cell_then_the_head(cpu_run):
    rc, lines, saved = cpu_run
    assert rc == 0
    assert [x["cell"] for x in lines[:-1]] == CPU_CELLS
    assert saved == lines
    head = lines[-1]
    assert head["metric"] == "rays_per_sec_cornell16"
    assert [x["cell"] for x in head["extra"]] == CPU_CELLS[1:]
    assert head["extra"] == lines[1:-1]
    assert head["all_correct"] is True
    # bench.py's flag: 16^2 on the CPU is far below 3x the reference.
    assert head["regression"] is True and head["regression_notes"]


@pytest.mark.parametrize("cell", CPU_CELLS)
def test_cpu_cell_line(cpu_run, cell):
    line = next(x for x in cpu_run[1] if x["cell"] == cell)
    assert line["metric"] == METRICS[cell]
    assert line["correct"] is True and all(line["checks"].values())
    expected = {"finite", "slice"}
    expected |= ({"light"} if cell in ("cornell1024", "cornell1024_refconfig",
                                       "specular1024") else set())
    expected |= {"wavefront", "megakernel"} if "wavefront" in cell else set()
    assert set(line["checks"]) == expected   # "launched" only on a card
    assert line["device"] == "cpu" and line["card"] is None
    assert line["kernel_ms"] is None and line["peak_bytes"] is None
    assert line["value"] > 0 and line["unit"] == "rays/s"
    timing = line["timing"]
    assert timing["runs"] == 1 and timing["spread"] == 0.0
    rays = 16 * 16 * line["spp"] * line["depth"]
    assert line["value"] == pytest.approx(rays / timing["seconds"][0])
    assert line["slice_max_abs"] == 0.0
    if cell.startswith("sphere"):
        assert line["fingerprint_ms"] > 0
        # The committed renders are at depth 5 and 256^2 or more.
        assert "golden" not in line["checks"] and line["notes"]
        assert "golden" not in line and "golden_converged" not in line
    if "wavefront" in cell:
        assert line["depth"] == int(cell.rsplit("_d", 1)[1])
        assert line["megakernel_same_config"] > 0
        assert line["flip_share_mt"] <= 0.01
        assert line["megakernel_band_max_abs"] == 0.0
    if cell == "cornell1024_refconfig":
        assert line["reference_seconds"] == 112.0
        assert line["seconds"] == timing["seconds"][0]


def test_measure_on_a_stubbed_clock(monkeypatch):
    """One untimed call, the reset, then runs of 1, 4 and 2 seconds: the
    median, min and max rays/s, the spread and the run count."""
    clock = iter([0.0, 1.0, 10.0, 14.0, 20.0, 22.0])
    monkeypatch.setattr(timer.time, "perf_counter", lambda: next(clock))
    calls = []
    film, timing = bench_torch.measure(
        lambda: calls.append("render") or len(calls), 8.0, 3,
        torch.device("cpu"), reset=lambda: calls.append("reset"))
    assert calls == ["render", "reset", "render", "render", "render"]
    assert film == 5
    assert timing == {"median": 4.0, "min": 2.0, "max": 8.0,
                      "spread": 1.5, "runs": 3,
                      "seconds": [1.0, 4.0, 2.0]}


def _one_ulp(fn, pick):
    """``fn`` with one element of its output (``pick`` selects the tensor)
    moved one ulp up."""
    def perturbed(*args, **kw):
        out = fn(*args, **kw)
        x = pick(out).view(-1)
        x[0] = torch.nextafter(x[0], torch.tensor(float("inf")))
        return out
    return perturbed


@pytest.mark.parametrize("cell, module, name, pick", [
    ("cornell1024", ttk, "render_sum_cuda", lambda out: out),
    ("sphere9812_beam", tbk, "render_tiles_beam", lambda out: out),
    ("sphere9812_cluster", tck, "intersect_clusters", lambda out: out[0]),
])
def test_one_ulp_in_the_kernel_fails_the_slice(monkeypatch, capsys, tmp_path,
                                               cell, module, name, pick):
    """A kernel output one ulp off its plain version's makes the cell
    incorrect and the exit code 1."""
    monkeypatch.setattr(tpt.meshes, "sphere_in_box", small_sphere)
    monkeypatch.setattr(module, name, _one_ulp(getattr(module, name), pick))
    rc, lines = run_bench(TINY + ["--cells", cell, "--out",
                                  str(tmp_path / "b.json")], capsys)
    assert rc == 1
    assert lines[0]["cell"] == cell and lines[0]["correct"] is False
    assert lines[0]["checks"]["slice"] is False
    assert lines[0]["checks"]["finite"] is True
    assert lines[-1]["all_correct"] is False


def _golden_film(name):
    """A linear film whose 8-bit PNG is the committed render."""
    u8 = tpt.read_png(os.path.join(REPO, bench_torch.GOLDENS[name]))
    lin = ((u8[::-1].astype(np.float64) + 0.5) / 255.0) ** 2.2
    return torch.from_numpy(lin.astype(np.float32).copy())


@pytest.mark.parametrize("name", sorted(bench_torch.GOLDENS))
def test_crop_mean_of_the_committed_render_is_its_mean(name, tmp_path):
    """The committed render, written back as a film's PNG, reads its own
    linear mean; the same film 3% brighter is outside the cells' bar."""
    film = _golden_film(name)
    assert bench_torch.golden_res(tpt, name) == (film.shape[1],
                                                 film.shape[0])
    rec = bench_torch.golden_record(tpt, film, name, str(tmp_path / "a.png"))
    assert rec["linear_mean"] == pytest.approx(rec["golden_mean"],
                                               rel=1e-12)
    assert rec["rel_err"] == pytest.approx(0.0, abs=1e-12)
    rec = bench_torch.golden_record(tpt, film * 1.03, name,
                                    str(tmp_path / "b.png"))
    assert abs(rec["rel_err"]) > chip_smoke.GOLDEN_MEAN_RTOL


def test_crop_mean_reads_the_committed_corner(tmp_path):
    """The 256^2 sphere render is the corner [0, 256)^2 of the 512^2 view;
    a film that does not cover it gives None."""
    corner = _golden_film("sphere9812")
    film = torch.full((512, 512, 3), 7.0)
    film[:256, :256] = corner
    rec = bench_torch.golden_record(tpt, film, "sphere9812",
                                    str(tmp_path / "a.png"))
    assert rec["rel_err"] == pytest.approx(0.0, abs=1e-12)
    assert bench_torch.golden_record(tpt, corner[:128], "sphere9812",
                                     str(tmp_path / "b.png")) is None


def _run_golden_cell(monkeypatch, capsys, tmp_path, scale):
    """The sphere beam cell at 16^2, 2 spp, depth 5, held against a
    committed render that is this cell's own film times ``scale``; the
    converged render takes 2 spp.  Returns (exit code, the cell's line)."""
    monkeypatch.setattr(tpt.meshes, "sphere_in_box", small_sphere)
    monkeypatch.setattr(chip_smoke, "GOLDEN_SPP", 2)
    monkeypatch.setattr(bench_torch, "BEAM_GOLDEN_TILE_SAMPLES", 1)
    cam, sb = small_sphere(device="cpu")
    own = tpt.render_film(cam, sb.build(device="cpu"), 2, 5,
                          backend="beam").data
    png = str(tmp_path / "golden.png")
    tpt.Film((16, 16), data=own * scale).gamma_correct().save_png(png)
    monkeypatch.setitem(bench_torch.GOLDENS, "sphere9812", png)
    argv = TINY + ["--depth", "5", "--cells", "sphere9812_beam", "--out",
                   str(tmp_path / "b.json")]
    rc, lines = run_bench(argv, capsys)
    return rc, lines[0]


@pytest.mark.parametrize("scale, correct", [(1.0, True), (1.1, False)])
def test_golden_check_of_a_large_cell(monkeypatch, capsys, tmp_path, scale,
                                      correct):
    """At depth 5 the cell holds its own timed film, and a render of the
    committed pixels through its route at the converged samples, within
    2% of the committed render's linear mean: a committed film 10%
    brighter (a mean several % off once 8-bit) fails both and the
    cell."""
    rc, line = _run_golden_cell(monkeypatch, capsys, tmp_path, scale)
    assert line["golden"]["rel_err"] == pytest.approx(
        line["golden_converged"]["rel_err"])
    assert line["golden_converged"]["spp"] == 2
    assert line["checks"]["golden"] is correct
    assert line["checks"]["golden_converged"] is correct
    assert line["correct"] is correct and rc == (0 if correct else 1)
    assert (tmp_path / "bench_torch_sphere9812_beam.png").exists()


def test_golden_bar_on_the_own_film_alone_fails_the_cell(
        monkeypatch, capsys, tmp_path):
    """The cell's own film 3% off the committed mean fails the cell even
    when its converged render holds the bar."""
    real = bench_torch.golden_record

    def own_off(pt, film, key, png):
        rec = real(pt, film, key, png)
        if png.endswith("_beam.png"):
            rec["rel_err"] = 0.03
        return rec
    monkeypatch.setattr(bench_torch, "golden_record", own_off)
    rc, line = _run_golden_cell(monkeypatch, capsys, tmp_path, 1.0)
    assert line["checks"]["golden"] is False
    assert line["checks"]["golden_converged"] is True
    assert line["correct"] is False and rc == 1


def test_golden_spp_counts_beam_tile_samples():
    """The beam's golden render takes 2^21 (tile, sample) pairs: 65,536
    spp over the sphere's 256^2 (32 tiles of 2048 pixels), 16,384 over the
    garden's 512^2; other routes the committed 2048."""
    make = tpt.make_camera
    c256 = make((0, 0, 0), (0, 0, 1), (0, 1, 0), (256, 256), 1.0,
                device="cpu")
    c512 = make((0, 0, 0), (0, 0, 1), (0, 1, 0), (512, 512), 1.0,
                device="cpu")
    assert bench_torch.golden_spp(c256, "beam") == 65536
    assert bench_torch.golden_spp(c512, "beam") == 16384
    assert bench_torch.golden_spp(c256, "cluster") == 2048


def test_one_ulp_in_the_megakernel_film_fails_its_band(monkeypatch, capsys,
                                                       tmp_path):
    """A timed megakernel film one ulp off in the wavefront cell's middle
    band makes the cell incorrect: the band is held bit for bit."""
    real = ttk.render_film_cuda

    def perturbed(cam, scene, samples, depth=5, **kw):
        film = real(cam, scene, samples, depth, **kw)
        if kw.get("loop") is None:
            x = film.data[cam.height // 2].view(-1)
            x[0] = torch.nextafter(x[0], torch.tensor(float("inf")))
        return film
    monkeypatch.setattr(ttk, "render_film_cuda", perturbed)
    rc, lines = run_bench(TINY + ["--cells", "wavefront512_d5", "--out",
                                  str(tmp_path / "b.json")], capsys)
    assert lines[0]["checks"]["megakernel"] is False
    assert lines[0]["checks"]["wavefront"] is True
    assert lines[0]["correct"] is False and rc == 1


def _centre_hits(cam, scene):
    """The triangle index each pixel's centre ray hits, (H, W), film rows
    (bottom first)."""
    from pathtracer_tpu_torch.camera import get_rays
    from pathtracer_tpu_torch.ops.intersect import intersect_brute
    h, w = torch.meshgrid(torch.arange(cam.height), torch.arange(cam.width),
                          indexing="ij")
    half = torch.full(w.shape, 0.5)
    o, d = get_rays(cam, w, h, half, half)
    return intersect_brute(o, d, scene.v1, scene.v2, scene.v3)[1]


@pytest.mark.parametrize("ties", [True, False])
def test_light_check_takes_every_pixel_as_bright(ties):
    """The specular box at 32^2 with a wall pixel and a light pixel both
    saturated, the wall's first: with ``ties`` (the specular cell's) the
    light pixel holds the check; without (the diffuse cells') the first
    brightest pixel, the wall's, fails it."""
    cam, scene = tpt.modified_cornell(0.05, res=(32, 32), device="cpu")
    tid = _centre_hits(cam, scene)
    light = scene.mat_type[tid.clamp_min(0).long()] == tpt.EMIT
    lh, lw = (int(x) for x in light.nonzero()[-1])
    wall = (~light & (tid >= 0)).nonzero()
    wh, ww = (int(x) for x in wall[0])
    assert (wh, ww) < (lh, lw)          # the wall's is the first maximum
    img = np.zeros((32, 32, 3), np.uint8)
    img[31 - wh, ww] = img[31 - lh, lw] = 255
    if ties:
        assert chip_smoke.brightest_sees_light(
            tpt, cam, scene, img, ties=True) == (lw, lh, 255.0)
    else:
        with pytest.raises(chip_smoke.CheckFailed, match="not the light"):
            chip_smoke.brightest_sees_light(tpt, cam, scene, img)


def _line(cell, backend, **checks):
    return {"cell": cell, "backend": backend, "checks": checks}


@pytest.mark.parametrize("lines, failed, reported", [
    ([_line("a", "beam", slice=True, golden=True, golden_converged=True),
      _line("b", "auto", slice=True, light=True)], [], []),
    ([_line("a", "beam", slice=True, golden=False, golden_converged=True)],
     [], ["a"]),
    ([_line("a", "beam", slice=True, golden=False, golden_converged=False)],
     [("a", ["golden", "golden_converged"])], []),
    ([_line("a", "beam", slice=False, golden=False, golden_converged=True)],
     [("a", ["golden", "slice"])], []),
    ([_line("a", "cluster", golden=False, golden_converged=True)],
     [("a", ["golden"])], []),
    ([_line("a", "auto", light=False)], [("a", ["light"])], []),
])
def test_phase_14_verdict(lines, failed, reported):
    """Phase 14 holds every check but a beam cell's golden bar on its own
    film, which it reports while the converged render holds the bar."""
    assert chip_smoke.bench_verdict(lines) == (failed, reported)


def test_resource_table_reads_cuobjdump():
    """Registers and stack from --dump-resource-usage, local stores
    counted in the SASS, whoever built the library."""
    usage = ("Resource usage:\n Common:\n  GLOBAL:0\n"
             " Function _Z12beam_kernelILb0ELb1EEvv:\n"
             "  REG:96 STACK:16 SHARED:0 LOCAL:0 CONSTANT[0]:900\n"
             " Function _Z14cluster_kernelILb1EEvv:\n"
             "  REG:40 STACK:0 SHARED:8192 LOCAL:0 CONSTANT[0]:600\n")
    sass = ("\n        Function : _Z12beam_kernelILb0ELb1EEvv\n"
            "        /*0000*/  MOV R1, c[0x0][0x28] ;\n"
            "        /*0010*/  STL [R1], R2 ;\n"
            "        /*0020*/  LDL R2, [R1] ;\n"
            "        /*0030*/  STL.64 [R1+0x8], R4 ;\n"
            "\n        Function : _Z14cluster_kernelILb1EEvv\n"
            "        /*0000*/  EXIT ;\n")
    table = chip_smoke.resource_table(usage, sass)
    assert table == {"_Z12beam_kernelILb0ELb1EEvv": (96, 16, 2),
                     "_Z14cluster_kernelILb1EEvv": (40, 0, 0)}
    assert {chip_smoke.instance_label(k) for k in table} == {
        "beam/diffuse/inline", "cluster/shared"}


def test_cells_flag_picks_in_bench_order_and_refuses_others():
    args = bench_torch.parse_args(["--cells",
                                   "wavefront512_d5,cornell1024"])
    assert args.cells == ("cornell1024", "wavefront512_d5")
    assert bench_torch.parse_args([]).cells == bench_torch.CELLS
    with pytest.raises(SystemExit):
        bench_torch.parse_args(["--cells", "cornell1024,bvh10k"])


def test_default_metric_names_are_bench_pys():
    """At the defaults every cell's metric is bench.py's name, at the
    resolution the cell runs at (the large scenes at 512^2)."""
    bench = bench_torch.Bench(None, bench_torch.parse_args([]),
                              torch.device("cpu"), None)
    tris = {"sphere9812": 9812, "garden105708": 105708}
    names = [bench.spec(c).metric.format(tris=tris.get(bench.spec(c).scene))
             for c in bench_torch.CELLS]
    assert names == [
        "rays_per_sec_cornell1024",
        "rays_per_sec_cornell1024_refconfig_10000spp",
        "rays_per_sec_specular1024",
        "rays_per_sec_bvh_9812tris_512",
        "rays_per_sec_bvh_cluster_512",
        "rays_per_sec_garden_105708tris_512",
        "rays_per_sec_wavefront_512_d5",
        "rays_per_sec_wavefront_512_d16"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = (
        "import sys, bench_torch\n"
        f"rc = bench_torch.main({TINY!r} + ['--cells', 'cornell1024', "
        f"'--out', {str(tmp_path / 'b.json')!r}])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pathtracer_tpu')]\n"
        "print('LOADED', bad)\n"
        "sys.exit(rc or bool(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_without_a_card_it_exits_nonzero(tmp_path):
    """No CUDA device and no --device cpu: an error, no result line."""
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--cells",
         "cornell1024", "--res", "8", "--spp", "1", "--out",
         str(tmp_path / "b.json")],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "torch.cuda.is_available() is false" in res.stderr
    assert not (tmp_path / "b.json").exists()
