"""Worker process for tests/test_torch_parallel.py.

Run as: python _torch_dist_worker.py <rank> <world> <init_file> <out_dir>

Joins a gloo process group on the CPU through
``pathtracer_tpu_torch.parallel.distributed.initialize`` (a file
rendezvous), runs every multi-rank case of the sharded drivers, and saves
this rank's results to ``<out_dir>/rank<rank>.npz``; the test holds them
against single-process sums and against the JAX package.  The inputs the
JAX package provides (the starting parameters) come from
``<out_dir>/inputs.npz``.  Imports no JAX.
"""

import os
import sys
import time

rank, world = int(sys.argv[1]), int(sys.argv[2])
init_file, out_dir = sys.argv[3], sys.argv[4]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

import pathtracer_tpu_torch as pt  # noqa: E402
from pathtracer_tpu_torch import diff, inverse  # noqa: E402
from pathtracer_tpu_torch.convert import (  # noqa: E402
    material_params_from_arrays)
from pathtracer_tpu_torch.parallel import (  # noqa: E402
    distributed, make_mesh, make_sharded_train_step, render_film_sharded,
    render_film_sharded_beam, render_film_sharded_cuda)

# Sizes shared with tests/test_torch_parallel.py.
from _torch_dist_cases import CASES  # noqa: E402

t0 = time.perf_counter()
distributed.initialize(f"file://{init_file}", world, rank, device="cpu",
                       timeout=120)
inputs = np.load(os.path.join(out_dir, "inputs.npz"))
out = {"primary": np.array(distributed.is_primary())}


def scene(case):
    make = {"corner": pt.corner_scene, "cornell": pt.cornell_box}[case["scene"]]
    return make(res=case["res"], device="cpu")


for name, case in CASES.items():
    mesh = make_mesh(tile=case["mesh"][0], sample=case["mesh"][1])
    out[f"{name}/coords"] = np.array(mesh.coords)
    cam, sc = scene(case)
    if case["kind"] in ("plain", "cuda", "beam"):
        fn = {"plain": render_film_sharded, "cuda": render_film_sharded_cuda,
              "beam": render_film_sharded_beam}[case["kind"]]
        film = fn(mesh, cam, sc, case["spp"], case["depth"],
                  seed=case["seed"])
        out[name] = film.data.numpy()
        continue
    # A train step from the JAX package's start.
    target = diff.render_film_diff(cam, sc, diff.material_params(sc),
                                   case["target_spp"], case["depth"],
                                   sample_offset=10_000).detach()
    out[f"{name}/target"] = target.numpy()
    step, init = make_sharded_train_step(
        mesh, cam, sc, target, case["spp"], case["depth"], seed=case["seed"],
        param_transform=inverse.to_materials)
    params = material_params_from_arrays(
        {k: inputs[f"{name}/{k}"] for k in ("albedo", "emit", "roughness")},
        device="cpu")
    opt = init(params)
    losses = []
    for k in range(case["steps"]):
        params, opt, loss = step(params, opt, k)
        losses.append(float(loss))
        for p, v in params.items():
            out[f"{name}/{k}/{p}"] = v.detach().numpy().copy()
    out[f"{name}/losses"] = np.array(losses)

band = torch.full((2, 3, 3), float(rank))
gathered = distributed.gather_film(band)
out["gather"] = np.zeros(0) if gathered is None else gathered
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
print(f"WORKER_{rank}_OK {time.perf_counter() - t0:.2f} s", flush=True)
