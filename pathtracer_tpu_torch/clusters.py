"""Triangle clusters and the two-level beam accel, the PyTorch counterpart
of ``pathtracer_tpu/clusters.py``.

* ``build_clusters`` cuts the SAH BVH (``bvh.py``) at subtrees of at most
  ``max_tris`` triangles.  Each cut subtree is a CLUSTER: an AABB and a
  contiguous range of packed ``[v1, e1 = v2 - v1, e2 = v3 - v1]`` rows, in
  DFS order, followed by ``PACK_PAD`` degenerate rows.  Every triangle is in
  exactly one cluster, so a ray that misses a cluster's box misses its
  triangles.  ``ops/cuda/cluster_kernel.py`` traverses it.
* ``build_beam_accel`` cuts the same tree twice: at ``sc_tris`` into
  SUPERCLUSTERS, and each of those at ``ctris`` into clusters padded to
  exactly ``ctris`` rows of 16 columns (geometry, material, normal, inline
  color).  ``ops/cuda/beam_kernel.py`` traverses it.

Both builders are host numpy work and produce the JAX package's arrays
exactly; the accels hold CPU tensors and move with ``.to(device)``.  Each
also keeps the BVH nodes above its cut (clusters, superclusters) as a box
tree (``_box_tree``), which the CUDA kernels walk in place of a loop over
every leaf box; the JAX package has no such array.  ``cached_accel`` keeps
the accels of the last few scenes, so a render call does not pay the host
build again.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from . import materials as mat
from .bvh import FlatBVH, _host_arrays, build_bvh
from .scene import Scene
from .utils.profiling import trace_annotation

DEFAULT_CLUSTER_TRIS = 64   # cluster cut size
PACK_PAD = 8                # degenerate rows after the packed triangles

BEAM_CTRIS = 8              # rows per beam cluster (padded exactly to this)
BEAM_SC_TRIS = 128          # first supercluster cut size, doubled until the
                            # supercluster count fits MAX_BEAM_SC
MAX_BEAM_SC = 1008          # supercluster cap of the beam accel
MAX_BEAM_MATERIALS = 64     # above this the materials are inlined per row
MAX_SC_CLUSTERS = 2040      # clusters per supercluster cap

_PAD_BOX = np.array([[3e38, 3e38, 3e38, -3e38, -3e38, -3e38, 0, 0]],
                    np.float32)


CACHE_SIZE = 4              # accels kept per cache


def cached_accel(cache: List, scene: Scene, build: Callable[[Scene], object]):
    """``build(scene)`` moved to the scene's device, from ``cache``, a list
    of ``((fingerprint, device), accel)`` pairs, newest last.  The key is
    the scene's byte fingerprint (``Scene.fingerprint``), which the scene
    keeps per content version: a lookup of an unedited scene hashes
    nothing, and its cost is this list's scan.  The least
    recently used accel goes first: a hit moves to the newest end, so the
    accel just served is never the one evicted.  Spans: ``pt.accel.lookup``
    over the whole call, ``pt.accel.build`` over a miss's build."""
    with trace_annotation("pt.accel.lookup"):
        key = (scene.fingerprint(), str(scene.device))
        for i, (k, a) in enumerate(cache):
            if k == key:
                cache.append(cache.pop(i))
                return a
        with trace_annotation("pt.accel.build"):
            a = build(scene).to(scene.device)
        cache.append((key, a))
        del cache[:-CACHE_SIZE]
        return a


def _to(obj, fields, device):
    return dataclasses.replace(
        obj, **{f: getattr(obj, f).to(device) for f in fields})


_CLUSTER_FIELDS = ("tri_data", "tid_map", "start", "count", "bounds", "tree")


@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """Cluster tensors on one device.

    tri_data: (P, 9) float32 packed [v1, e1, e2] rows in cluster order,
        P = num_tris + PACK_PAD, the tail all zeros (degenerate).
    tid_map:  (P,) int32 scene triangle id of each row (-1 on padding).
    start, count: (C,) int32 first row and row count of each cluster.
    bounds:   (C, 8) float32 [lb(3), rt(3), 0, 0] cluster AABBs.
    tree:     (C - 1, 16) float32 the BVH above the cut, whose leaves are
        the clusters (``_box_tree``), with ``tree_depth`` levels.
    """
    tri_data: torch.Tensor
    tid_map: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    bounds: torch.Tensor
    tree: torch.Tensor
    num_clusters: int
    max_count: int
    tree_depth: int

    @property
    def device(self) -> torch.device:
        return self.tri_data.device

    @property
    def centers(self) -> torch.Tensor:
        """(C, 3) cluster AABB centers."""
        return 0.5 * (self.bounds[:, 0:3] + self.bounds[:, 3:6])

    @property
    def scene_bounds(self):
        """(lb, rt) of the union of the cluster boxes."""
        return (self.bounds[:, 0:3].amin(dim=0),
                self.bounds[:, 3:6].amax(dim=0))

    def to(self, device) -> "ClusterSet":
        return _to(self, _CLUSTER_FIELDS, device)


def _bvh_host(scene: Scene, bvh: Optional[FlatBVH]):
    return _host_arrays(bvh if bvh is not None else build_bvh(scene))


def _cut(node, limit, left, right, s_arr, e_arr, expanded=None):
    """Subtree ranges of <= limit triangles in DFS order: [(s, e, node)].
    ``expanded``, a list, receives the BVH nodes above the cut, in DFS
    order."""
    out = []
    stack = [node]
    while stack:
        ni = stack.pop()
        cnt = int(e_arr[ni]) - int(s_arr[ni]) + 1
        if left[ni] == -1 or cnt <= limit:
            out.append((int(s_arr[ni]), int(e_arr[ni]), ni))
        else:
            if expanded is not None:
                expanded.append(ni)
            # the right child first, so the left one is popped first
            stack.append(int(right[ni]))
            stack.append(int(left[ni]))
    return out


def _box_tree(expanded, cut_nodes, left, right, leaf_bounds):
    """The BVH above a cut as a node array for the kernels' tree walk.

    ``expanded``: the BVH nodes above the cut in DFS order (the root first);
    ``cut_nodes``: the BVH node of each leaf, in leaf order; ``leaf_bounds``
    (L, >= 6) the leaves' [lb, rt] boxes.  Returns (tree (N, 16) float32,
    depth): node i holds both children's boxes, [lb0(3), rt0(3), lb1(3),
    rt1(3)], then the two children as int32 bit patterns in columns 12 and
    13 (an internal node's index, or ``-1 - leaf``), then two zeros.  Node
    boxes are unions of the leaf boxes, so each child box lies inside its
    parent's.  ``depth``: internal nodes on the longest root-to-leaf path
    (0 when the root is itself a leaf, and the tree has no node), the stack
    entries a near-child-first walk needs at most."""
    index = {int(ni): i for i, ni in enumerate(expanded)}
    index.update({int(ni): -1 - j for j, ni in enumerate(cut_nodes)})
    n = len(expanded)
    tree = np.zeros((n, 16), np.float32)
    kids = tree.view(np.int32)
    boxes = np.zeros((n, 6), np.float32)
    leaf_bounds = np.asarray(leaf_bounds, np.float32)[:, :6]

    def box(child):
        return leaf_bounds[-1 - child] if child < 0 else boxes[child]

    for i in range(n - 1, -1, -1):   # children come after their parent
        ni = expanded[i]
        c0, c1 = index[int(left[ni])], index[int(right[ni])]
        b0, b1 = box(c0), box(c1)
        tree[i, 0:6], tree[i, 6:12] = b0, b1
        kids[i, 12], kids[i, 13] = c0, c1
        boxes[i] = np.concatenate([np.minimum(b0[:3], b1[:3]),
                                   np.maximum(b0[3:], b1[3:])])
    levels = np.zeros(n, np.int64)
    for i in range(n):
        for c in kids[i, 12:14]:
            if c >= 0:
                levels[c] = levels[i] + 1
    return tree, int(levels.max()) + 1 if n else 0


def build_clusters(scene: Scene, bvh: Optional[FlatBVH] = None,
                   max_tris: int = DEFAULT_CLUSTER_TRIS) -> ClusterSet:
    """Cut the scene's SAH BVH into clusters of at most ``max_tris``
    triangles (a bigger leaf stays whole; ``max_count`` is the realised
    bound).  CPU tensors."""
    lb_arr, rt_arr, left, right, s_arr, e_arr, tri_idx = _bvh_host(scene,
                                                                   bvh)
    expanded = []
    ranges = _cut(0, max_tris, left, right, s_arr, e_arr, expanded)
    n = scene.num_tris
    v1, v2, v3 = scene.host_verts()
    C = len(ranges)
    starts = np.zeros(C, np.int32)
    counts = np.zeros(C, np.int32)
    bounds = np.zeros((C, 8), np.float32)
    pos = 0
    for ci, (s, e, ni) in enumerate(ranges):
        starts[ci] = pos
        counts[ci] = e - s + 1
        bounds[ci, 0:3] = lb_arr[ni]
        bounds[ci, 3:6] = rt_arr[ni]
        pos += e - s + 1
    assert pos == n, (pos, n)
    # DFS cut ranges tile [0, n) in order, so the packed order is tri_idx.
    order = np.asarray(tri_idx, np.int32)
    tid_map = np.concatenate([order, np.full(PACK_PAD, -1, np.int32)])
    tri_data = np.zeros((n + PACK_PAD, 9), np.float32)
    tri_data[:n, 0:3] = v1[order]
    tri_data[:n, 3:6] = v2[order] - v1[order]
    tri_data[:n, 6:9] = v3[order] - v1[order]
    tree, depth = _box_tree(expanded, [ni for _, _, ni in ranges], left,
                            right, bounds)
    return ClusterSet(
        tri_data=torch.from_numpy(tri_data), tid_map=torch.from_numpy(tid_map),
        start=torch.from_numpy(starts), count=torch.from_numpy(counts),
        bounds=torch.from_numpy(bounds), tree=torch.from_numpy(tree),
        num_clusters=C, max_count=int(counts.max()) if C else 0,
        tree_depth=depth)


_BEAM_FIELDS = ("tri_cols", "tid_map", "cl_bounds", "sc_bounds", "sc_first",
                "sc_ncl", "sc_order", "mats", "sc_tree")


@dataclasses.dataclass(frozen=True)
class BeamAccel:
    """Beam accel tensors on one device.

    tri_cols: (P, 16) float32 rows [v1(3), e1(3), e2(3), mat, N(3),
        color(3)], P = (C + 1) * ctris: cluster c owns rows
        [c * ctris, (c + 1) * ctris), padded with degenerate zero rows, and
        one all-degenerate sentinel cluster ends the array.  N = e1 x e2
        (unnormalised).  ``mat`` is the row of ``mats``, or, when
        ``mats_inline``, flags * 8 + roughness with the color in cols 13:16.
    tid_map:  (P,) int32 scene triangle id of each row (-1 on padding).
    cl_bounds: (C_pad, 8) float32 [lb(3), rt(3), 0, 0] cluster AABBs,
        padded to a multiple of 8 plus 8 with inverted never-hit boxes.
    sc_bounds: (S_pad, 8) float32 supercluster AABBs, padded the same way.
    sc_first, sc_ncl: (S,) int32 first cluster and cluster count.
    sc_order: (8, S) int32 per-octant front-to-back supercluster order
        (ascending projection of the box center on the octant diagonal),
        the JAX builder's array; no kernel of the port reads it.
    mats: (M, 8) float32 [color(3), roughness, flags, 0, 0, 0] with color
        the emission for EMIT and the albedo otherwise, flags 2 (EMIT),
        1 (SPECULAR) or 0.
    sc_tree: (S - 1, 16) float32 the BVH above the supercluster cut, whose
        leaves are the superclusters (``_box_tree``), with
        ``sc_tree_depth`` levels; the kernel walks it in place of a loop
        over ``sc_bounds``.
    max_edge_product: the largest |e1| |e2| of a row, a bound on the
        determinant of its Möller–Trumbore test for a unit direction.
    """
    tri_cols: torch.Tensor
    tid_map: torch.Tensor
    cl_bounds: torch.Tensor
    sc_bounds: torch.Tensor
    sc_first: torch.Tensor
    sc_ncl: torch.Tensor
    sc_order: torch.Tensor
    mats: torch.Tensor
    sc_tree: torch.Tensor
    num_clusters: int
    num_superclusters: int
    num_materials: int
    ctris: int
    sc_tree_depth: int
    max_edge_product: float
    mats_inline: bool = False

    @property
    def device(self) -> torch.device:
        return self.tri_cols.device

    def to(self, device) -> "BeamAccel":
        return _to(self, _BEAM_FIELDS, device)


def _pad8(arr) -> np.ndarray:
    """(N, 8) boxes padded to a multiple of 8 plus 8 rows with inverted
    boxes (lb = +3e38 > rt = -3e38), which no slab test accepts."""
    arr = np.asarray(arr, np.float32).reshape(-1, 8)
    k = (-len(arr)) % 8 + 8
    return np.concatenate([arr, np.repeat(_PAD_BOX, k, 0)], axis=0)


def _material_table(scene: Scene):
    """(mat_id (n,) int32, rows (M, 8) float32): materials deduplicated on
    (type, albedo, emission, roughness) rounded to 7 decimals, numbered in
    order of first use."""
    mtype, albedo, emit, rough = scene.host_materials()
    if np.any((mtype != mat.EMIT) & (np.abs(emit).sum(-1) > 0)):
        raise ValueError(
            "scene has a non-EMIT material with nonzero emission; the "
            "packed beam kernel cannot represent it — use backend='brute'")
    # Exact duplicates first (by bit pattern), then the rounded keys of the
    # distinct rows, visited in order of first use.
    bits = np.concatenate([
        mtype[:, None].view(np.uint32), albedo.view(np.uint32),
        emit.view(np.uint32), rough[:, None].view(np.uint32)], axis=1)
    _, first, inverse = np.unique(bits, axis=0, return_index=True,
                                  return_inverse=True)
    inverse = inverse.reshape(-1)
    keys = {}
    rows = []
    raw_to_mat = np.zeros(len(first), np.int32)
    for u in np.argsort(first, kind="stable"):
        i = int(first[u])
        key = (int(mtype[i]), tuple(np.round(albedo[i], 7)),
               tuple(np.round(emit[i], 7)), round(float(rough[i]), 7))
        if key not in keys:
            color = emit[i] if mtype[i] == mat.EMIT else albedo[i]
            flag = (2.0 if mtype[i] == mat.EMIT
                    else 1.0 if mtype[i] == mat.SPECULAR else 0.0)
            keys[key] = len(rows)
            rows.append(np.concatenate(
                [color, [rough[i], flag, 0, 0, 0]]).astype(np.float32))
        raw_to_mat[u] = keys[key]
    return raw_to_mat[inverse], np.stack(rows)


def build_beam_accel(scene: Scene, bvh: Optional[FlatBVH] = None,
                     ctris: int = BEAM_CTRIS,
                     sc_tris: Optional[int] = None) -> BeamAccel:
    """Cut the SAH BVH into (supercluster, cluster) levels.  Leaves bigger
    than a cut size are split by centroid median on their longest axis.
    ``sc_tris=None`` starts at BEAM_SC_TRIS and doubles it until at most
    MAX_BEAM_SC superclusters remain.  CPU tensors.

    Raises ValueError for a non-EMIT material with emission and for a
    supercluster of more than MAX_SC_CLUSTERS clusters."""
    assert ctris % 4 == 0 and (ctris % PACK_PAD == 0 or ctris == 4)
    _, _, left, right, s_arr, e_arr, tri_idx = _bvh_host(scene, bvh)
    v1, v2, v3 = scene.host_verts()
    cent = (v1 + v2 + v3) / 3.0

    def cut(node, limit, expanded=None):
        return _cut(node, limit, left, right, s_arr, e_arr, expanded)

    def split_range(ids, limit):
        if ids.size <= limit:
            return [ids]
        c = cent[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = ids.size // 2
        return (split_range(ids[order[:half]], limit)
                + split_range(ids[order[half:]], limit))

    if sc_tris is None:
        sc_tris = BEAM_SC_TRIS
        while len(cut(0, sc_tris)) > MAX_BEAM_SC:
            sc_tris *= 2
    expanded = []
    sc_ranges = cut(0, sc_tris, expanded)
    sc_first, sc_ncl = [], []
    chunks = []
    for (s, e, ni) in sc_ranges:
        sc_first.append(len(chunks))
        if left[ni] == -1 and e - s + 1 > sc_tris:
            chunks.extend(split_range(tri_idx[s:e + 1].copy(), ctris))
        else:
            for (cs, ce, _) in cut(ni, ctris):
                chunks.extend(split_range(tri_idx[cs:ce + 1].copy(), ctris))
        sc_ncl.append(len(chunks) - sc_first[-1])

    C = len(chunks)
    S = len(sc_ranges)
    assert sum(ids.size for ids in chunks) == scene.num_tris
    if max(sc_ncl) > MAX_SC_CLUSTERS:
        raise ValueError(
            f"a supercluster holds {max(sc_ncl)} clusters "
            f"(> {MAX_SC_CLUSTERS}); raise ctris (scene has "
            f"{scene.num_tris} tris at ctris={ctris}, sc_tris={sc_tris})")

    mat_id, mat_rows = _material_table(scene)
    M = len(mat_rows)
    mats_inline = M > MAX_BEAM_MATERIALS

    # Cluster c's triangles go to rows [c * ctris, c * ctris + n_c).
    sizes = np.array([ids.size for ids in chunks])
    ids = np.concatenate(chunks).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rows = (np.repeat(np.arange(C) * ctris - offsets, sizes)
            + np.arange(ids.size))
    P = (C + 1) * ctris
    tri_cols = np.zeros((P, 16), np.float32)
    tid_map = np.full(P, -1, np.int32)
    e1 = v2[ids] - v1[ids]
    e2 = v3[ids] - v1[ids]
    tri_cols[rows, 0:3] = v1[ids]
    tri_cols[rows, 3:6] = e1
    tri_cols[rows, 6:9] = e2
    if mats_inline:
        mr = mat_rows[mat_id[ids]]
        tri_cols[rows, 9] = mr[:, 4] * 8.0 + mr[:, 3]
        tri_cols[rows, 13:16] = mr[:, 0:3]
    else:
        tri_cols[rows, 9] = mat_id[ids]
    tri_cols[rows, 10:13] = np.cross(e1, e2)
    tid_map[rows] = ids
    max_edge_product = float(np.max(
        np.linalg.norm(e1.astype(np.float64), axis=-1)
        * np.linalg.norm(e2.astype(np.float64), axis=-1)))

    # Cluster boxes (min/max are exact, so grouping does not matter), and
    # supercluster boxes as the union of their clusters' boxes.
    lo = np.minimum.reduceat(np.minimum(np.minimum(v1[ids], v2[ids]),
                                        v3[ids]), offsets, axis=0)
    hi = np.maximum.reduceat(np.maximum(np.maximum(v1[ids], v2[ids]),
                                        v3[ids]), offsets, axis=0)
    zeros2 = np.zeros((C, 2), np.float32)
    cl_bounds = np.concatenate([lo, hi, zeros2], axis=1)
    scf = np.asarray(sc_first, np.int32)
    scn = np.asarray(sc_ncl, np.int32)
    sc_bounds = np.concatenate([
        np.minimum.reduceat(lo, scf, axis=0),
        np.maximum.reduceat(hi, scf, axis=0),
        np.zeros((S, 2), np.float32)], axis=1)

    centers = 0.5 * (sc_bounds[:, 0:3] + sc_bounds[:, 3:6])
    order = np.zeros((8, S), np.int32)
    for o in range(8):
        sign = np.array([1 if o & 1 else -1, 1 if o & 2 else -1,
                         1 if o & 4 else -1], np.float32)
        order[o] = np.argsort(centers @ sign, kind="stable")

    sc_tree, sc_depth = _box_tree(expanded, [ni for _, _, ni in sc_ranges],
                                  left, right, sc_bounds)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return BeamAccel(
        tri_cols=t(tri_cols), tid_map=t(tid_map),
        cl_bounds=t(_pad8(cl_bounds)), sc_bounds=t(_pad8(sc_bounds)),
        sc_first=t(scf), sc_ncl=t(scn), sc_order=t(order),
        mats=t(mat_rows[:MAX_BEAM_MATERIALS]), sc_tree=t(sc_tree),
        num_clusters=C, num_superclusters=S,
        num_materials=min(M, MAX_BEAM_MATERIALS), ctris=ctris,
        sc_tree_depth=sc_depth, max_edge_product=max_edge_product,
        mats_inline=mats_inline)
