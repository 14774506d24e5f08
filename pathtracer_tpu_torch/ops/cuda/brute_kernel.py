"""Dense nearest hit: host wrapper of the brute kernel.

The kernel, ``csrc/brute_kernel.cu``, replaces no TPU kernel.  On the TPU,
XLA fused ``ops/intersect.intersect_brute`` (Möller–Trumbore of every ray
against every triangle, then the first index of the minimum) into one
pass; eager PyTorch runs it as ~66 kernels over (rays, T) and
(rays, T, 3) temporaries, most of a recovery step's device time.  The
kernel computes the same function in one launch.

What bounds it on this card: fp32 issue, ``MT_OPS`` operations and one
IEEE division a row test, every row for every ray; 24 bytes are read and 8
written a ray.  Design: one thread per ray, ``BLOCK_RAYS`` a block, the
rows [v1, e1, e2] staged through shared memory in tiles of ``TILE_ROWS``
(any row count, one kernel), so memory is O(rays) and a batch of any size
is one launch.

``intersect_brute_cuda`` takes what ``intersect_brute`` takes and returns
what it returns, bit for bit: a CUDA batch launches the kernel on the
current stream without synchronising, or raises; a CPU batch takes
``intersect_brute`` itself, the plain version.  The hits carry no
gradient, so an input that requires one is refused: a caller detaches its
rays.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...utils import build
from ..intersect import intersect_brute

BLOCK_RAYS = 256     # rays per CUDA block; csrc/brute_kernel.cu kThreads
TILE_ROWS = 256      # rows per shared-memory tile; kTileRows

LAUNCHES = 0         # kernel launches since the last reset

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def _check(ray_o, ray_d, v1, v2, v3):
    if ray_o.dim() < 1 or ray_o.shape[-1] != 3 or ray_d.shape != ray_o.shape:
        raise ValueError(f"need ray_o, ray_d of one shape (..., 3), got "
                         f"{tuple(ray_o.shape)} and {tuple(ray_d.shape)}")
    if (v1.dim() != 2 or v1.shape[-1] != 3 or v1.shape[0] < 1
            or v2.shape != v1.shape or v3.shape != v1.shape):
        raise ValueError(f"need v1, v2, v3 of one shape (T >= 1, 3), got "
                         f"{tuple(v1.shape)}, {tuple(v2.shape)}, "
                         f"{tuple(v3.shape)}")
    for name, x in (("ray_o", ray_o), ("ray_d", ray_d), ("v1", v1),
                    ("v2", v2), ("v3", v3)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: need float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous tensor")
        if x.requires_grad:
            raise ValueError(f"{name} requires grad: the hits carry no "
                             f"gradient (detach the rays)")
        if x.device != ray_o.device:
            raise ValueError(f"{name} on {x.device}, ray_o on "
                             f"{ray_o.device}")


def _launch(o, d, v1, v2, v3) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    dev = o.device
    n = o.shape[0]
    # The plain version's edge subtractions, so the rows are its bits.
    e1 = v2 - v1
    e2 = v3 - v1
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tid = torch.empty(n, dtype=torch.int32, device=dev)
    lib = build.load_library()
    fn = lib.pt_brute_intersect
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = fn(o.data_ptr(), d.data_ptr(), v1.data_ptr(), e1.data_ptr(),
             e2.data_ptr(), t.data_ptr(), tid.data_ptr(), n, v1.shape[0],
             index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"brute kernel launch failed: "
                           f"{build.error_string(lib, err)} (cudaError {err})")
    LAUNCHES += 1
    return t, tid


def intersect_brute_cuda(ray_o: torch.Tensor, ray_d: torch.Tensor,
                         v1: torch.Tensor, v2: torch.Tensor,
                         v3: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ray_o, ray_d: (..., 3); v1, v2, v3: (T, 3); all float32, contiguous,
    on one device, none requiring grad.  Returns ``intersect_brute``'s
    (t (...,), tid (...,) int32): the nearest positive hit, FLOAT_INF and
    -1 on a miss, ties to the lower row.  A CUDA batch is one launch."""
    _check(ray_o, ray_d, v1, v2, v3)
    shape = ray_o.shape[:-1]
    o, d = ray_o.reshape(-1, 3), ray_d.reshape(-1, 3)
    dev = o.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the brute kernel runs on CUDA, not {dev}")
    if dev.type == "cpu" or o.shape[0] == 0:
        t, tid = intersect_brute(o, d, v1, v2, v3)
    else:
        t, tid = _launch(o, d, v1, v2, v3)
    return t.reshape(shape), tid.reshape(shape)
