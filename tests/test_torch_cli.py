"""pathtracer_tpu_torch's CLI: the cases of tests/test_cli.py with
``--device cpu``, invert's 'auto' rule, the bench line and
``python -m pathtracer_tpu_torch``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.render import BRUTE_MAX
from pathtracer_tpu_torch.image import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def test_cli_render(tmp_path, capsys):
    out = tmp_path / "corner.png"
    cli.main(["render", "corner", str(out), "--res", "32", "--spp", "4",
              "--depth", "2", "--backend", "brute"] + CPU)
    img = read_png(str(out))
    assert img.shape == (32, 32, 3)
    assert img.max() > 0  # the emitter must be visible


def test_cli_render_camera_spec(tmp_path):
    out = tmp_path / "cam.png"
    cli.main(["render", "corner", str(out), "--res", "16", "--spp", "2",
              "--depth", "1", "--backend", "brute",
              "--camera", "0,0,-6:0,0,1"] + CPU)
    assert read_png(str(out)).shape == (16, 16, 3)


def test_cli_invert(capsys):
    cli.main(["invert", "corner", "--res", "12", "--spp", "4",
              "--depth", "2", "--steps", "3", "--target-spp", "8"] + CPU)
    tail = capsys.readouterr().out.strip().splitlines()[-1]
    assert "albedo error" in tail
    err = float(tail.rsplit(" ", 1)[-1])
    assert np.isfinite(err)


def test_cli_realtime_scripted(tmp_path, capsys):
    cli.main(["realtime", "corner", str(tmp_path), "--res", "16",
              "--frames", "3", "--frame-samples", "1", "--depth", "1",
              "--keys", "w,,p"] + CPU)
    # 'p' on the last frame writes a screenshot into the directory
    shots = list(tmp_path.glob("*.png"))
    assert shots, "screenshot key produced no file"
    assert "pos:" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["cuda", "beam", "bvh-gather"])
def test_cli_render_kernel_backends_on_cpu(tmp_path, backend):
    """The kernel backends take their plain versions on a CPU scene; the
    JAX name 'bvh-gather' is the port's per-ray 'bvh'."""
    out = tmp_path / f"{backend}.png"
    cli.main(["render", "cornell", str(out), "--res", "16", "--spp", "2",
              "--depth", "2", "--backend", backend] + CPU)
    assert read_png(str(out)).max() > 0


def test_invert_auto_rule_by_padded_size():
    _, small = tpt.cornell_box(res=(8, 8), device="cpu")
    assert cli.invert_backend(small) == "brute"
    sb = tpt.SceneBuilder()
    for i in range(BRUTE_MAX + 1):
        sb.add_triangle((i, 0, 0), (i + 1, 0, 0), (i, 1, 0), tpt.Diffuse(1))
    big = sb.build(device="cpu")
    assert big.padded_size > BRUTE_MAX
    assert cli.invert_backend(big) == "bvh"      # a CPU scene

    class CudaScene:     # what the rule reads of a scene on a card
        padded_size = big.padded_size
        device = type("D", (), {"type": "cuda"})()
    assert cli.invert_backend(CudaScene()) == "cluster"
    CudaScene.padded_size = BRUTE_MAX
    assert cli.invert_backend(CudaScene()) == "brute"


def test_cli_bench_prints_one_json_line(capsys):
    cli.main(["bench", "--res", "16", "--spp", "4", "--depth", "2"] + CPU)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(line)
    assert got["backend"] == "cuda" and got["device"] == "cpu"
    assert got["card"] is None and got["seconds"] > 0
    assert got["rays_per_sec"] == pytest.approx(16 * 16 * 4 * 2
                                                / got["seconds"])


def test_python_m_help():
    res = subprocess.run([sys.executable, "-m", "pathtracer_tpu_torch",
                          "--help"], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    for cmd in ("render", "sweep", "realtime", "invert", "bench"):
        assert cmd in res.stdout
