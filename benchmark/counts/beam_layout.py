"""The two-level box layout that the beam kernel's work count walks, built
here from the scene's triangles alone, so that the count reads the same
work whatever layout the program builds.

A frozen copy of the layout the port's numpy path built when the
benchmark was made (its native BVH builder, which it loads where that
library is present, splits some ties another way): the full-sweep SAH
BVH (every centroid a candidate on every axis, the no-split cost
``count * half area``), cut into superclusters of at most ``sc_tris``
triangles (``SC_TRIS``, doubled until at most ``MAX_SC`` remain) and
those into clusters of at most ``CTRIS``; a leaf over a cut size is split
at its centroid median on its longest axis.  Plain numpy on the host: a
mesh of 100k triangles takes some tens of seconds.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

CTRIS = 8          # rows a cluster
SC_TRIS = 128      # the first supercluster cut size
MAX_SC = 1008      # superclusters at most


@dataclasses.dataclass
class Layout:
    sc_bounds: np.ndarray       # (S, 6) float32 [lo, hi]
    cl_bounds: np.ndarray       # (C, 6) float32; clusters numbered
    sc_ncl: np.ndarray          # (S,) clusters of each supercluster
    cluster_of_tri: np.ndarray  # (T,) int64
    ctris: int


def _half_area(lb, rt):
    d = rt - lb
    a = d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2]
    return np.where(np.all(lb <= rt, axis=-1), a, 0.0)


def _best_split(cent, tri_lb, tri_rt, idx):
    m = idx.shape[0]
    best_axis, best_pos, best_cost = -1, 0.0, np.inf
    for axis in range(3):
        c = cent[idx, axis]
        order = np.argsort(c, kind="stable")
        cs = c[order]
        lb_s, rt_s = tri_lb[idx][order], tri_rt[idx][order]
        pre_lb = np.minimum.accumulate(lb_s, axis=0)
        pre_rt = np.maximum.accumulate(rt_s, axis=0)
        suf_lb = np.minimum.accumulate(lb_s[::-1], axis=0)[::-1]
        suf_rt = np.maximum.accumulate(rt_s[::-1], axis=0)[::-1]
        ks = np.nonzero(cs[1:] > cs[:-1])[0] + 1
        if ks.size == 0:
            continue
        costs = (ks * _half_area(pre_lb[ks - 1], pre_rt[ks - 1])
                 + (m - ks) * _half_area(suf_lb[ks], suf_rt[ks]))
        j = int(np.argmin(costs))
        if costs[j] < best_cost:
            best_axis, best_pos, best_cost = axis, float(cs[ks[j]]), float(
                costs[j])
    return best_axis, best_pos, best_cost


def sah_bvh(v1, v2, v3):
    """(left, right, start, end, tri_idx): children allocated in pairs,
    leaf iff left == -1, inclusive ranges into the permutation."""
    n = v1.shape[0]
    tri_lb = np.minimum(np.minimum(v1, v2), v3)
    tri_rt = np.maximum(np.maximum(v1, v2), v3)
    cent = (v1 + v2 + v3) / 3.0
    tri_idx = np.arange(n, dtype=np.int32)
    left, right, start, end = [-1], [-1], [0], [n - 1]
    stack = [0]
    while stack:
        ni = stack.pop()
        s, e = start[ni], end[ni]
        rng = tri_idx[s:e + 1]
        node_lb, node_rt = tri_lb[rng].min(axis=0), tri_rt[rng].max(axis=0)
        m = e - s + 1
        axis, pos, cost = _best_split(cent, tri_lb, tri_rt, rng)
        if axis == -1 or cost > m * float(_half_area(node_lb, node_rt)):
            continue
        is_left = cent[rng, axis] < pos
        k = int(is_left.sum())
        if k == 0 or k == m:
            continue
        tri_idx[s:e + 1] = np.concatenate([rng[is_left], rng[~is_left]])
        li = len(left)
        left += [-1, -1]
        right += [-1, -1]
        start += [s, s + k]
        end += [s + k - 1, e]
        left[ni], right[ni] = li, li + 1
        stack += [li, li + 1]
    return (np.asarray(left), np.asarray(right), np.asarray(start),
            np.asarray(end), tri_idx)


def _cut(node, limit, left, right, start, end) -> List[tuple]:
    """Subtree ranges of at most ``limit`` triangles in DFS order."""
    out, stack = [], [node]
    while stack:
        ni = stack.pop()
        if left[ni] == -1 or end[ni] - start[ni] + 1 <= limit:
            out.append((int(start[ni]), int(end[ni]), ni))
        else:
            stack += [int(right[ni]), int(left[ni])]
    return out


def build(v1, v2, v3, ctris: int = CTRIS) -> Layout:
    """The layout of the triangles (T, 3) float32 ``v1``, ``v2``,
    ``v3``."""
    left, right, start, end, tri_idx = sah_bvh(v1, v2, v3)
    cent = (v1 + v2 + v3) / 3.0

    def split_range(ids, limit):
        if ids.size <= limit:
            return [ids]
        c = cent[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = ids.size // 2
        return (split_range(ids[order[:half]], limit)
                + split_range(ids[order[half:]], limit))

    sc_tris = SC_TRIS
    while len(_cut(0, sc_tris, left, right, start, end)) > MAX_SC:
        sc_tris *= 2
    chunks, sc_first, sc_ncl = [], [], []
    for s, e, ni in _cut(0, sc_tris, left, right, start, end):
        sc_first.append(len(chunks))
        if left[ni] == -1 and e - s + 1 > sc_tris:
            chunks += split_range(tri_idx[s:e + 1].copy(), ctris)
        else:
            for cs, ce, _ in _cut(ni, ctris, left, right, start, end):
                chunks += split_range(tri_idx[cs:ce + 1].copy(), ctris)
        sc_ncl.append(len(chunks) - sc_first[-1])
    ids = np.concatenate(chunks).astype(np.int64)
    sizes = np.array([c.size for c in chunks])
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    lo = np.minimum.reduceat(np.minimum(np.minimum(v1[ids], v2[ids]),
                                        v3[ids]), offsets, axis=0)
    hi = np.maximum.reduceat(np.maximum(np.maximum(v1[ids], v2[ids]),
                                        v3[ids]), offsets, axis=0)
    first = np.asarray(sc_first)
    cluster_of_tri = np.empty(v1.shape[0], np.int64)
    cluster_of_tri[ids] = np.repeat(np.arange(len(chunks)), sizes)
    return Layout(
        sc_bounds=np.concatenate([np.minimum.reduceat(lo, first, axis=0),
                                  np.maximum.reduceat(hi, first, axis=0)],
                                 axis=1).astype(np.float32),
        cl_bounds=np.concatenate([lo, hi], axis=1).astype(np.float32),
        sc_ncl=np.asarray(sc_ncl, np.int64), cluster_of_tri=cluster_of_tri,
        ctris=ctris)
