"""Host-side SAH BVH builder, the PyTorch counterpart of
``pathtracer_tpu/bvh.py``.

Full-sweep surface-area-heuristic splits over every centroid candidate on
every axis (sorted prefix scans per node), compared against the no-split
cost ``tri_count * node_area`` with "area" the HALF surface area.  Children
are allocated contiguously (left = len(nodes), right = left + 1), so the
tree equals the JAX package's array for array.

The output is a flat, pointer-free node array (box lb/rt, left/right child,
inclusive tri_start/tri_end leaf ranges; leaf iff left == right == -1) and
the triangle permutation ``tri_idx``.  The build is host numpy work, or the
shared native builder (``utils/native.py``) when its library loads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .scene import Scene

_TENSOR_FIELDS = ("lb", "rt", "left", "right", "tri_start", "tri_end",
                  "tri_idx")


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """Flat BVH tensors on one device.  Leaf iff left == right == -1.

    The host numpy arrays ride along as ``_host`` (not a dataclass field),
    so host consumers (``clusters.py``) read them without a device copy."""
    lb: torch.Tensor         # (M, 3) float32 node box lower corner
    rt: torch.Tensor         # (M, 3) upper corner
    left: torch.Tensor       # (M,) int32 child index or -1
    right: torch.Tensor      # (M,) int32
    tri_start: torch.Tensor  # (M,) int32 inclusive range into tri_idx
    tri_end: torch.Tensor    # (M,) int32 inclusive
    tri_idx: torch.Tensor    # (T,) int32 permutation of triangle ids
    max_leaf: int            # max triangles in any leaf
    depth: int               # max tree depth (root = 1)

    @property
    def num_nodes(self) -> int:
        return int(self.left.shape[0])

    @property
    def device(self) -> torch.device:
        return self.lb.device

    def stack_size(self) -> int:
        """Safe per-ray traversal stack capacity (DFS holds <= depth + 1)."""
        return self.depth + 2

    def to(self, device) -> "FlatBVH":
        new = dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS})
        if hasattr(self, "_host"):
            object.__setattr__(new, "_host", self._host)
        return new


def _half_area(lb: np.ndarray, rt: np.ndarray) -> np.ndarray:
    """Half surface area of boxes, 0 for invalid boxes."""
    d = rt - lb
    a = d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2]
    valid = np.all(lb <= rt, axis=-1)
    return np.where(valid, a, 0.0)


def _best_split(centroids, tri_lb, tri_rt, idx):
    """(axis, pos, cost) of the cheapest SAH split of one node's triangles,
    or (-1, 0, inf) when no candidate leaves both sides non-empty."""
    m = idx.shape[0]
    best_axis, best_pos, best_cost = -1, 0.0, np.inf
    for axis in range(3):
        c = centroids[idx, axis]
        order = np.argsort(c, kind="stable")
        cs = c[order]
        lb_s = tri_lb[idx][order]
        rt_s = tri_rt[idx][order]
        pre_lb = np.minimum.accumulate(lb_s, axis=0)
        pre_rt = np.maximum.accumulate(rt_s, axis=0)
        suf_lb = np.minimum.accumulate(lb_s[::-1], axis=0)[::-1]
        suf_rt = np.maximum.accumulate(rt_s[::-1], axis=0)[::-1]
        # A split at sorted position k is pos = cs[k], left = the first k
        # entries; only strictly increasing positions are distinct.
        ks = np.nonzero(cs[1:] > cs[:-1])[0] + 1
        if ks.size == 0:
            continue
        left_area = _half_area(pre_lb[ks - 1], pre_rt[ks - 1])
        right_area = _half_area(suf_lb[ks], suf_rt[ks])
        costs = ks * left_area + (m - ks) * right_area
        j = int(np.argmin(costs))
        if costs[j] < best_cost:
            best_cost = float(costs[j])
            best_axis = axis
            best_pos = float(cs[ks[j]])
    return best_axis, best_pos, best_cost


def build_bvh(scene: Scene, use_native: Optional[bool] = None) -> FlatBVH:
    """The SAH BVH of the scene's (unpadded) triangles, on the CPU; move it
    with ``FlatBVH.to``.  ``use_native``: None tries the native builder and
    falls back to numpy, True requires it, False skips it."""
    n = scene.num_tris
    v1, v2, v3 = scene.host_verts()
    tri_lb = np.minimum(np.minimum(v1, v2), v3)
    tri_rt = np.maximum(np.maximum(v1, v2), v3)
    centroids = (v1 + v2 + v3) / 3.0

    if use_native is None or use_native:
        try:
            from .utils import native
            out = native.build_bvh(tri_lb, tri_rt, centroids)
        except Exception:
            if use_native:
                raise
            out = None
        if out is None and use_native:
            raise RuntimeError("the native BVH builder is not available")
        if out is not None:
            return _finalize(*out)

    tri_idx = np.arange(n, dtype=np.int32)
    nodes_lb, nodes_rt = [], []
    nodes_l, nodes_r, nodes_s, nodes_e = [], [], [], []

    def push_node(start, end):
        nodes_lb.append(None)
        nodes_rt.append(None)
        nodes_l.append(-1)
        nodes_r.append(-1)
        nodes_s.append(start)
        nodes_e.append(end)
        return len(nodes_l) - 1

    push_node(0, n - 1)
    stack = [0]
    while stack:
        ni = stack.pop()
        s, e = nodes_s[ni], nodes_e[ni]
        rng = tri_idx[s:e + 1]
        node_lb = tri_lb[rng].min(axis=0)
        node_rt = tri_rt[rng].max(axis=0)
        nodes_lb[ni], nodes_rt[ni] = node_lb, node_rt

        m = e - s + 1
        axis, pos, cost = _best_split(centroids, tri_lb, tri_rt, rng)
        nosplit = m * float(_half_area(node_lb, node_rt))
        if axis == -1 or cost > nosplit:
            continue  # leaf
        is_left = centroids[rng, axis] < pos
        left_cnt = int(is_left.sum())
        if left_cnt == 0 or left_cnt == m:
            continue  # degenerate split: leaf
        tri_idx[s:e + 1] = np.concatenate([rng[is_left], rng[~is_left]])
        li = push_node(s, s + left_cnt - 1)
        ri = push_node(s + left_cnt, e)
        nodes_l[ni], nodes_r[ni] = li, ri
        stack.append(li)
        stack.append(ri)

    return _finalize(
        np.stack(nodes_lb).astype(np.float32),
        np.stack(nodes_rt).astype(np.float32),
        np.asarray(nodes_l, np.int32), np.asarray(nodes_r, np.int32),
        np.asarray(nodes_s, np.int32), np.asarray(nodes_e, np.int32),
        tri_idx)


def _finalize(lb, rt, left, right, start, end, tri_idx) -> FlatBVH:
    leaf = left == -1
    host = tuple(np.ascontiguousarray(a) for a in
                 (lb, rt, left, right, start, end, tri_idx))
    bvh = FlatBVH(*(torch.from_numpy(a.copy()) for a in host),
                  max_leaf=int((end[leaf] - start[leaf] + 1).max()),
                  depth=_tree_depth(left, right))
    object.__setattr__(bvh, "_host", host)
    return bvh


def _host_arrays(bvh: FlatBVH):
    """(lb, rt, left, right, tri_start, tri_end, tri_idx) as numpy arrays,
    from the builder's host copies when present."""
    host = getattr(bvh, "_host", None)
    if host is None:
        host = tuple(getattr(bvh, f).cpu().numpy() for f in _TENSOR_FIELDS)
    return host


def _tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    depth = 0
    stack = [(0, 1)]
    while stack:
        ni, d = stack.pop()
        depth = max(depth, d)
        if left[ni] != -1:
            stack.append((int(left[ni]), d + 1))
            stack.append((int(right[ni]), d + 1))
    return depth


def print_tree(bvh: FlatBVH, node: int = 0, depth: int = 0,
               label: str = "root") -> str:
    """Debug tree dump, one line per node."""
    if node == -1:
        return ""
    lb_a, rt_a, left, right, start, end, _ = _host_arrays(bvh)
    leaf = int(left[node]) == -1
    line = (
        f"{node}:\t" + " | " * depth + (" +-" if depth else "")
        + f"{tuple(lb_a[node])} {tuple(rt_a[node])}"
        + (" leaf," if leaf else "")
        + f" tri: {int(start[node])} -> {int(end[node])}"
        + f" ({label})\n"
    )
    if not leaf:
        line += print_tree(bvh, int(left[node]), depth + 1, "left")
        line += print_tree(bvh, int(right[node]), depth + 1, "right")
    return line
