"""Checkpoint / resume for long renders and material recovery.

One ``.npz`` per run, in the same layout as ``pathtracer_tpu``'s
checkpoints, with a JSON config record under ``meta``:

  * render: the film SUM and the number of samples done.  The
    per-(pixel, sample) RNG streams make a resumed render identical to an
    uninterrupted one.
  * train (``inverse.recover_materials``): the parameter leaves
    ``params:i`` in sorted-key order (albedo, emit, roughness), the
    optimizer's leaves ``opt:i`` and the ``step``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch


def checkpoint_path(path: str) -> str:
    """The file ``np.savez`` writes for ``path``."""
    return path if path.endswith(".npz") else path + ".npz"


def _meta_bytes(meta: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def save_render_checkpoint(path: str, film_sum, samples_done: int,
                           meta: Dict[str, Any]) -> None:
    film = torch.as_tensor(film_sum).detach().cpu().numpy()
    np.savez_compressed(
        path, film_sum=film, samples_done=np.int64(samples_done),
        meta=_meta_bytes(meta))


def load_render_checkpoint(path: str) -> Tuple[np.ndarray, int,
                                               Dict[str, Any]]:
    with np.load(checkpoint_path(path)) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        return z["film_sum"], int(z["samples_done"]), meta


def save_train_checkpoint(path: str, params: Mapping[str, Any],
                          opt_state: Sequence[Any], step: int,
                          meta: Dict[str, Any]) -> None:
    """``params`` {name: tensor or array}, written as ``params:i`` in
    sorted-name order; ``opt_state`` a sequence of tensors or arrays,
    written as ``opt:i``."""
    def host(x):
        return torch.as_tensor(x).detach().cpu().numpy()

    data = {f"params:{i}": host(params[k])
            for i, k in enumerate(sorted(params))}
    data.update({f"opt:{i}": host(x) for i, x in enumerate(opt_state)})
    np.savez_compressed(path, step=np.int64(step), meta=_meta_bytes(meta),
                        **data)


def load_train_checkpoint(path: str, names: Sequence[str]
                          ) -> Tuple[Dict[str, np.ndarray], List[np.ndarray],
                                     int, Dict[str, Any]]:
    """(params {name: array} for ``names`` in sorted order, the ``opt:i``
    arrays in order, step, meta)."""
    with np.load(checkpoint_path(path), allow_pickle=False) as z:
        params = {k: z[f"params:{i}"] for i, k in enumerate(sorted(names))}
        opt = []
        while f"opt:{len(opt)}" in z:
            opt.append(z[f"opt:{len(opt)}"])
        meta = json.loads(bytes(z["meta"]).decode())
        return params, opt, int(z["step"]), meta
