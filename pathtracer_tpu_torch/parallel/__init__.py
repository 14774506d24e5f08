"""Sharded rendering and training over ``torch.distributed``, the PyTorch
counterpart of ``pathtracer_tpu/parallel/``.

Pixel-row bands over the ``tile`` axis and sample windows over the
``sample`` axis of a (tile, sample) grid of ranks; the scene and camera
are replicated on every rank; film sums and material gradients are
reduced over the ranks (``distributed.all_gather`` + ``ordered_sum``).
Each rank's render runs the kernels of its device: the trace kernel on
its film band, the beam kernel on its run of Morton tiles.
"""

from . import distributed  # noqa: F401
from .mesh import make_mesh, mesh_axes  # noqa: F401
from .shard import (  # noqa: F401
    render_film_sharded, render_film_sharded_cuda, render_film_sharded_beam,
    make_sharded_train_step,
)
