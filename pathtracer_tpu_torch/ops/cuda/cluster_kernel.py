"""Cluster-traversal intersection: host wrapper and plain version.

The kernel, ``csrc/cluster_kernel.cu``, replaces
``pathtracer_tpu/ops/pallas/cluster_kernel.py::_kernel``: the nearest hit
``(t, tid)`` of a flat ray batch against a ``clusters.ClusterSet``, with a
slab test per cluster box and Möller–Trumbore over the rows of every
cluster a ray enters.

What bounds it on this card: fp32 issue (the boxes a ray opens and the
triangles of the clusters it enters) and divergence between the rays of a
warp.  Design: one thread per ray and a block of ``BLOCK_RAYS`` rays in the
part of the TPU's ray tile.  Each ray walks the set's box tree (``tree``,
the top of the SAH BVH the clusters were cut from: both children's boxes in
a node, near child first, the far one on a short stack) and tests the rows
of every cluster whose box it enters; ties go to the lower packed row and a
box opens on ``tmin <= best_t``, so the hit is the plain version's whatever
the visit order.  The kernel keeps the nodes, starts and counts in shared
memory when two blocks of them fit an SM.  The wrapper raises
``ValueError`` on a tree deeper than the kernel's stack.

On a CUDA batch ``intersect_clusters`` launches the kernel or raises; it
takes the plain version, ``intersect_clusters_reference`` (dense
Möller–Trumbore against every packed row), only when the rays lie on the
CPU.  ``clusters_for`` keeps the cluster sets of the last few scenes, so the
render driver and the differentiable path build a scene's set once.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...clusters import ClusterSet, build_clusters, cached_accel
from ...scene import Scene
from ...utils import build
from ..intersect import (MOMENT_OPS, PLUCKER_OPS, SLAB_OPS, boxes_entered,
                         intersect_packed)

BLOCK_RAYS = 256      # rays per CUDA block; csrc/cluster_kernel.cu kThreads

LAUNCHES = 0          # kernel launches since the last reset

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

_CLUSTER_CACHE = []   # [((fingerprint, device), cluster set)], newest last


def clusters_for(scene: Scene) -> ClusterSet:
    """The scene's cluster set on the scene's device, from a small cache
    keyed by the scene's bytes (``clusters.cached_accel``): the host build
    is most of a cluster render's time on a large mesh, and must not be
    paid per call."""
    return cached_accel(_CLUSTER_CACHE, scene, build_clusters)


def _check_rays(ray_o, ray_d, cs: ClusterSet):
    if (ray_o.dim() != 2 or ray_o.shape[-1] != 3
            or ray_d.shape != ray_o.shape):
        raise ValueError(f"need ray_o, ray_d of shape (R, 3), got "
                         f"{tuple(ray_o.shape)} and {tuple(ray_d.shape)}")
    if ray_o.dtype != torch.float32 or ray_d.dtype != torch.float32:
        raise ValueError(f"need float32 rays, got {ray_o.dtype}, "
                         f"{ray_d.dtype}")
    if ray_d.device != ray_o.device or cs.device != ray_o.device:
        raise ValueError(f"rays on {ray_o.device} and {ray_d.device}, "
                         f"clusters on {cs.device}")


def intersect_clusters_reference(ray_o: torch.Tensor, ray_d: torch.Tensor,
                                 cs: ClusterSet
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: dense Möller–Trumbore of every ray against
    every packed row (in chunks of rays), the nearest row by argmin-first,
    mapped to its scene triangle id."""
    _check_rays(ray_o, ray_d, cs)
    t, row = intersect_packed(ray_o, ray_d, cs.tri_data)
    tid = torch.where(row >= 0, cs.tid_map[row.clamp_min(0)], -1)
    return t, tid.to(torch.int32)


def count_work(ray_o: torch.Tensor, ray_d: torch.Tensor, cs: ClusterSet,
               t_hit: torch.Tensor, tid_hit: torch.Tensor) -> dict:
    """The work these rays need of any exact cluster traversal, from their
    nearest hits (t_hit (R,), scene triangle tid_hit (R,), -1 on a miss):
    each ray opens the cluster boxes it enters before its hit and the one
    that holds the hit, and tests the rows of those clusters.  Returns the
    box tests, the rows and their operations: SLAB_OPS a box, PLUCKER_OPS a
    row (the cheaper row test, as the trace kernel's bound counts it), and
    a ray's MOMENT_OPS and three divisions for the reciprocal
    direction."""
    rays, n = ray_o.shape[0], cs.num_clusters
    dev = ray_o.device
    # The cluster of each scene triangle: every triangle is in one cluster.
    tri_cluster = torch.empty(int(cs.tid_map.shape[0]), dtype=torch.int64,
                              device=dev)
    row_cluster = torch.repeat_interleave(torch.arange(n, device=dev),
                                          cs.count.long())
    tids = cs.tid_map[:row_cluster.shape[0]].long()
    tri_cluster[tids] = row_cluster
    ids = torch.arange(n, device=dev)
    chunk = max(1, (1 << 22) // n)
    boxes = rows = 0
    for r0 in range(0, rays, chunk):
        o, d = ray_o[r0:r0 + chunk], ray_d[r0:r0 + chunk]
        tid = tid_hit[r0:r0 + chunk].long()
        own = torch.where(tid >= 0, tri_cluster[tid.clamp_min(0)], -1)
        opened = (boxes_entered(o, 1.0 / d, t_hit[r0:r0 + chunk],
                                cs.bounds[:n]) | (ids == own[:, None]))
        boxes += int(opened.sum())
        rows += int((opened.to(torch.int64) * cs.count[:n]).sum())
    return {"box_tests": boxes, "rows": rows,
            "ops": (boxes * SLAB_OPS + rows * PLUCKER_OPS
                    + rays * (MOMENT_OPS + 3))}


def intersect_clusters(ray_o: torch.Tensor, ray_d: torch.Tensor,
                       cs: ClusterSet) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest hit of flat rays (R, 3) against the clusters: (t (R,),
    tid (R,) int32), t = FLOAT_INF and tid = -1 on a miss.

    ``cs`` lies on the rays' device.  A CUDA batch launches the kernel on
    the current stream without synchronising; a CPU batch takes the plain
    version."""
    global LAUNCHES
    _check_rays(ray_o, ray_d, cs)
    dev = ray_o.device
    if dev.type == "cpu":
        return intersect_clusters_reference(ray_o, ray_d, cs)
    if dev.type != "cuda":
        raise ValueError(f"the cluster kernel runs on CUDA, not {dev}")
    R = ray_o.shape[0]
    if R == 0:
        return intersect_clusters_reference(ray_o, ray_d, cs)
    Rp = -(-R // BLOCK_RAYS) * BLOCK_RAYS
    if Rp != R:
        # Padding rays start beyond the +x face and point +x: they can
        # enter no cluster box.
        pad_o = (cs.scene_bounds[1] + 1.0).expand(Rp - R, 3)
        pad_d = torch.zeros((Rp - R, 3), dtype=torch.float32, device=dev)
        pad_d[:, 0] = 1.0
        ray_o = torch.cat([ray_o, pad_o])
        ray_d = torch.cat([ray_d, pad_d])
    planes = torch.cat([ray_o.T, ray_d.T]).contiguous()     # (6, Rp)
    tris = cs.tri_data.contiguous()
    tree = cs.tree.contiguous()
    start = cs.start.contiguous()
    count = cs.count.contiguous()
    for name, x, dtype in (("tri_data", tris, torch.float32),
                           ("tree", tree, torch.float32),
                           ("start", start, torch.int32),
                           ("count", count, torch.int32)):
        if x.dtype != dtype:
            raise ValueError(f"{name}: need {dtype}, got {x.dtype}")
    t = torch.empty(Rp, dtype=torch.float32, device=dev)
    slot = torch.empty(Rp, dtype=torch.int32, device=dev)

    lib = build.load_library()
    build.check_tree_depth(lib, cs.tree_depth, "cluster set")
    fn = lib.pt_cluster_intersect
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = fn(planes.data_ptr(), tris.data_ptr(), tree.data_ptr(),
             start.data_ptr(), count.data_ptr(), t.data_ptr(),
             slot.data_ptr(), Rp, cs.num_clusters, cs.tree_depth,
             tris.shape[0], index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cluster kernel launch failed: "
                           f"{build.error_string(lib, err)} (cudaError {err})")
    LAUNCHES += 1
    tid = torch.where(slot >= 0, cs.tid_map[slot.clamp_min(0).long()], -1)
    return t[:R], tid[:R].to(torch.int32)
