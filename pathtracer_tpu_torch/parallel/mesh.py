"""The (tile, sample) rank grid, the PyTorch counterpart of
``pathtracer_tpu/parallel/mesh.py``.

Axes:
  * ``tile``   — pixel-row bands of the film; each rank traces its own.
  * ``sample`` — Monte-Carlo sample windows; a band's partial sums are
                 reduced over this axis (the estimate is a mean, so the
                 windows add up to the film of their union).

The ranks of the default process group take the place of JAX's devices:
rank r sits at (r // sample, r % sample), as JAX reshapes its device list
row-major.  Every line of the grid along an axis has a process group of
its own, over which that axis reduces.  The grid is a small class and not
``torch.distributed.device_mesh``: ``init_device_mesh("cuda", ...)`` binds
rank r to ``cuda:r``, which does not exist when several ranks share one
card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch.distributed as dist

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def mesh_axes() -> Tuple[str, str]:
    return (TILE_AXIS, SAMPLE_AXIS)


def _factor(n: int) -> Tuple[int, int]:
    """Split n into (tile, sample) as square as possible, tile <= sample
    (sample parallelism has no spatial divisibility constraints)."""
    best = (1, n)
    f = 1
    while f * f <= n:
        if n % f == 0:
            best = (f, n // f)
        f += 1
    return best


def mesh_shape(n: int, tile: Optional[int] = None,
               sample: Optional[int] = None) -> Tuple[int, int]:
    """(tile, sample) of a grid of n ranks: near-square with no sizes
    given, else the missing size from the other."""
    if tile is None and sample is None:
        tile, sample = _factor(n)
    elif tile is None:
        tile = n // sample
    elif sample is None:
        sample = n // tile
    if tile * sample != n:
        raise ValueError(f"mesh {tile}x{sample} != {n} ranks")
    return tile, sample


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This rank's view of the grid.

    ``shape[axis]`` is the axis's size, ``coords`` this rank's
    ``(ti, si)``, and ``groups[axis]`` the process group of the ranks that
    share this rank's position on the OTHER axis, over which ``axis``
    reduces (None when the axis has one rank, so nothing is sent)."""
    shape: Dict[str, int]
    coords: Tuple[int, int]
    groups: Dict[str, Optional[object]]

    @property
    def size(self) -> int:
        return self.shape[TILE_AXIS] * self.shape[SAMPLE_AXIS]


def make_mesh(n_ranks: Optional[int] = None, *, tile: Optional[int] = None,
              sample: Optional[int] = None) -> RankMesh:
    """The (tile, sample) grid over every rank of the default process
    group, or a grid of one when no group is initialised.

    ``n_ranks`` must be the group's size (the JAX version may take the
    first n devices; here a rank outside the grid would have no work)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if n_ranks is None else n_ranks
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of "
                         f"{world}: the grid spans the whole group")
    tile, sample = mesh_shape(n, tile, sample)
    ti, si = divmod(rank, sample)
    groups = {TILE_AXIS: None, SAMPLE_AXIS: None}
    # new_group must be called by every rank, for every group, in the same
    # order, even for the groups a rank is not in.
    if sample > 1:
        for t in range(tile):
            g = dist.new_group([t * sample + s for s in range(sample)])
            if t == ti:
                groups[SAMPLE_AXIS] = g
    if tile > 1:
        for s in range(sample):
            g = dist.new_group([t * sample + s for t in range(tile)])
            if s == si:
                groups[TILE_AXIS] = g
    return RankMesh(shape={TILE_AXIS: tile, SAMPLE_AXIS: sample},
                    coords=(ti, si), groups=groups)
