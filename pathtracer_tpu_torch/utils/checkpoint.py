"""Checkpoint / resume for long renders.

One ``.npz`` per render: the film SUM, the number of samples done and a
JSON config record, in the same layout as ``pathtracer_tpu``'s render
checkpoints.  The per-(pixel, sample) RNG streams make a resumed render
identical to an uninterrupted one.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np
import torch


def checkpoint_path(path: str) -> str:
    """The file ``np.savez`` writes for ``path``."""
    return path if path.endswith(".npz") else path + ".npz"


def save_render_checkpoint(path: str, film_sum, samples_done: int,
                           meta: Dict[str, Any]) -> None:
    film = torch.as_tensor(film_sum).detach().cpu().numpy()
    np.savez_compressed(
        path, film_sum=film, samples_done=np.int64(samples_done),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))


def load_render_checkpoint(path: str) -> Tuple[np.ndarray, int,
                                               Dict[str, Any]]:
    with np.load(checkpoint_path(path)) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        return z["film_sum"], int(z["samples_done"]), meta
