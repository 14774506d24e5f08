"""Process-group set-up and the collectives of the sharded drivers, the
PyTorch counterpart of ``pathtracer_tpu/parallel/distributed.py``.

Every rank runs the same program.  ``initialize()`` joins the process
group from torch's standard environment (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, as ``torchrun`` sets them) and
binds the rank to its card; the (tile, sample) grid of ``mesh.py`` then
spans every rank.

Film assembly and every reduction are built from ``all_reduce`` alone:
gloo carries only ``all_reduce`` and ``broadcast`` for CUDA tensors.
``all_gather`` writes each rank's tensor into its own slot of a zero
stack and sums the stacks; ``x + 0`` is exact, so every slot arrives
bit for bit, and ``ordered_sum`` then adds the slots in rank order, the
same order on every rank.  Sums over ranks are therefore bit-identical on
every rank and to a single process adding the same windows in the same
order, whichever algorithm the backend runs.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..image import Film


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, *, device: str = "cuda",
               timeout: Optional[float] = None) -> Optional[torch.device]:
    """Join the process group; a no-op (returning None) for a single
    process.  Returns the rank's device.

    ``coordinator``: ``host:port`` (a TCP rendezvous) or an init-method URL
    such as ``file:///path``; default ``MASTER_ADDR:MASTER_PORT``.
    ``num_processes``/``process_id`` default to ``WORLD_SIZE``/``RANK``.
    ``device="cuda"`` binds the rank to ``cuda:(LOCAL_RANK % cards)`` and
    raises without a card; ``device="cpu"`` keeps the rank on the CPU.
    ``backend=None`` picks ``nccl`` when every rank of this host has a card
    of its own and ``gloo`` otherwise: NCCL refuses two ranks on one card.
    The choice moves only the collectives; the rendering stays on the
    rank's device either way, and each rank prints it.  ``timeout``:
    seconds for the collectives.
    """
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if not num_processes or num_processes == 1:
        return None  # single process
    if process_id is None:
        raise ValueError("initialize: no process id (pass process_id or "
                         "set RANK)")
    if coordinator is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError("initialize: no coordinator (pass one or set "
                             "MASTER_ADDR and MASTER_PORT)")
        coordinator = f"{addr}:{port}"
    init_method = (coordinator if "://" in coordinator
                   else f"tcp://{coordinator}")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes

    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA device (pass "
                               "device='cpu' to keep the ranks on the CPU)")
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        own_card = local_world <= cards
    else:
        dev, cards, own_card = torch.device(device), 0, False
    if backend is None:
        backend = ("nccl" if dev.type == "cuda" and own_card
                   and dist.is_nccl_available() else "gloo")
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    if backend == "nccl":
        kw["device_id"] = dev      # NCCL would guess it from the rank
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)
    why = ("a card per rank" if own_card else
           f"{local_world} ranks share {cards} card(s)"
           if dev.type == "cuda" else "ranks on the CPU")
    print(f"[rank {process_id}/{num_processes}] torch.distributed backend "
          f"{backend} ({why}); rendering on {dev}", flush=True)
    return dev


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def all_gather(x: torch.Tensor, group=None, n: Optional[int] = None
               ) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape on every rank), in the group's rank
    order, from one ``all_reduce`` of a zero stack.  ``group``/``n``: the
    process group and its size; ``n == 1`` sends nothing (and a ``None``
    group with no ``n`` is the whole default group)."""
    if n is None:
        n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        return [x]
    slots = x.new_zeros((n,) + tuple(x.shape))
    slots[dist.get_rank(group)] = x
    dist.all_reduce(slots, group=group)
    return list(slots.unbind(0))


def ordered_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """((p0 + p1) + p2) + ..., the order a single process adds windows."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def gather_film(film) -> Optional[np.ndarray]:
    """Assemble the full film on process 0 from each rank's own rows (a
    ``Film`` or an (rows, W, 3) tensor, the same shape on every rank),
    stacked in rank order, as the JAX package gathers a film sharded over
    hosts.  Returns the numpy array on the primary rank, None elsewhere;
    with one process, the film itself.  (The sharded renders of
    ``shard.py`` already return the full film on every rank.)"""
    data = film.data if isinstance(film, Film) else film
    data = data.detach()
    full = torch.cat(all_gather(data), dim=0)
    return full.cpu().numpy() if is_primary() else None
