"""Rows of a table by id, and the table's gradient: host wrapper of the
gather kernel pair.

The kernels, ``csrc/gather_kernel.cu``, replace no TPU kernel: the JAX
package leaves the shade table's gather to XLA (``jnp.take``).  Eager
PyTorch ran it as four launches a bounce (clamp, int64 cast,
``index_select``, ``where``), and its backward as ``index_add_``, float
atomics that pile up on the few rows most paths hit, in an order that
changes from run to run.

``gather_rows(table, ids)`` is ``gather_rows_reference``'s function: the
rows of ``table`` (T, C) named by ``ids`` (...,), zeros where an id is
< 0.  On a CUDA table it is a ``torch.autograd.Function``: the forward one
launch that copies each row as 16-byte quads (the same bits as the plain
version); the backward sorts the ids stably (``torch.sort``) and sums each
table row's gradient rows in that order with two launches (a block's chunk
of sorted ids reduced by id with a fixed tree, then the rows whose ids span
chunks finished from the chunks' partials in chunk order), with no float
atomic: the table's gradient is the same bits on every run.  A CPU table
takes ``gather_rows_reference``.  The checks come first, on either device;
the ids' values are not read (that would synchronise): every id must be
< T, as every intersector of the port gives.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import build

LAUNCHES = {"forward": 0, "backward": 0}   # calls that launched, by pass

_FORWARD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p]
_BACKWARD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p]


def gather_rows_reference(table: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``index_select`` of the clamped ids, then
    zeros where an id is < 0; (...,) ids of any integer type give
    (..., C) rows."""
    rows = table.index_select(0, ids.clamp_min(0).reshape(-1).to(torch.int64))
    rows = rows.reshape(tuple(ids.shape) + (table.shape[1],))
    return torch.where((ids >= 0)[..., None], rows, 0.0)


def _check(table, ids):
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"need a table of shape (T >= 1, C), got "
                         f"{tuple(table.shape)}")
    if table.dtype != torch.float32:
        raise ValueError(f"table: need float32, got {table.dtype}")
    if (table.shape[1] * 4) % 16 != 0 or table.shape[1] == 0:
        raise ValueError(f"table: a row of {table.shape[1]} floats is not a "
                         f"whole number of 16-byte quads")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids: need int32, got {ids.dtype}")
    for name, x in (("table", table), ("ids", ids)):
        if not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous tensor")
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the gather kernel runs on CUDA, not "
                         f"{table.device}")
    if table.data_ptr() % 16 != 0:
        raise ValueError("table: need rows on a 16-byte boundary")


def _call(name, argtypes, *args):
    lib = build.load_library()
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: "
                           f"{build.error_string(lib, err)} (cudaError {err})")


def _stream_args(dev):
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def _forward(table, ids):
    n, cols = ids.shape[0], table.shape[1]
    out = torch.empty((n, cols), dtype=torch.float32, device=table.device)
    if n > 0:
        _call("pt_gather_rows", _FORWARD_ARGTYPES, table.data_ptr(),
              ids.data_ptr(), out.data_ptr(), n, table.shape[0], cols // 4,
              *_stream_args(table.device))
        LAUNCHES["forward"] += 1
    return out


def _backward(grad, ids, rows):
    dev, (n, cols) = grad.device, grad.shape
    if grad.data_ptr() % 16 != 0:
        grad = grad.clone()
    keys, pos = torch.sort(ids, stable=True)
    quads = cols // 4
    lib = build.load_library()
    lib.pt_gather_chunk.restype = ctypes.c_int
    chunks = -(-n // lib.pt_gather_chunk())
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    scratch = torch.empty(2 * chunks * 4 * min(quads, 4), dtype=torch.float32,
                          device=dev)
    _call("pt_gather_rows_backward", _BACKWARD_ARGTYPES, keys.data_ptr(),
          pos.data_ptr(), grad.data_ptr(), out.data_ptr(), scratch.data_ptr(),
          n, rows, quads, *_stream_args(dev))
    LAUNCHES["backward"] += 1
    return out


class _GatherRows(torch.autograd.Function):
    """(T, C) table, (N,) int32 ids -> (N, C) rows; the backward is the
    order-fixed segment sum."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return _forward(table, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return _backward(grad.contiguous(), ids, ctx.rows), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: (T, C) float32, C a multiple of 4, contiguous; ids: (...,)
    int32, contiguous, each < T, on the table's device.  Returns (..., C):
    row ``ids[i]`` of the table, zeros where it is < 0, differentiable in
    the table.  A CUDA table launches the kernel pair, or raises; a CPU
    table takes :func:`gather_rows_reference`."""
    _check(table, ids)
    if table.device.type == "cpu":
        return gather_rows_reference(table, ids)
    rows = _GatherRows.apply(table, ids.reshape(-1))
    return rows.reshape(tuple(ids.shape) + (table.shape[1],))
