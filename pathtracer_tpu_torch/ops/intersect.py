"""Ray-scene intersection, the PyTorch counterpart of
``pathtracer_tpu/ops/intersect.py``.

* ``intersect_brute``: dense Möller–Trumbore of every ray against every
  triangle.  Invalid candidates are masked to FLOAT_INF and the nearest hit
  is the FIRST index of the minimum, the tie rule the CUDA kernels' strict
  ``t < best_t`` in row order reproduces.
* ``intersect_plucker``: the same hit set from precomputed Plücker
  coefficient rows, with the bounce-0 collapse: the plain version of the
  megakernel's ``"plucker"`` loop.
* ``intersect_packed``: the same test against packed ``[v1, e1, e2]`` rows,
  in chunks of rays: the plain version of the cluster and beam kernels.
* ``intersect_tree``: the walk of a box tree over clusters that the cluster
  and beam kernels make (``slab_enter``, the lower row on a tie), for the
  CPU tests and for counting the nodes a walk opens; it returns what
  ``intersect_packed`` does.
* ``intersect_bvh``: per-ray stack traversal of the flat BVH, one masked
  step of all rays with a non-empty stack per loop iteration; the CPU
  oracle for large scenes and the ``"bvh"`` render backend.

All return ``(t, id)`` with ``t = FLOAT_INF`` and ``id = -1`` on a miss.
"""

from __future__ import annotations

import torch

from ..linalg import EPS, FLOAT_INF, cross, dot

# Floating-point operations of one test, counted from the formulas below
# (comparisons not counted), for the kernels' bounds: Möller–Trumbore with
# its division (``_mt``) and the slab test (6 subtractions, 6 products,
# 6 min/max per axis pair, 4 to combine the axes: ``boxes_entered``).
# ``intersect_plucker``: a, 1/a, the u*a and v*a sums, t*a, three products
# by 1/a and u + v; with the bounce-0 collapse (``primary``) the sums are
# 3-term dots and t*a is r0; the ray moment o x d once per ray.
MT_OPS = 46
SLAB_OPS = 22
PLUCKER_OPS = 38
PLUCKER_PRIMARY_OPS = 20
MOMENT_OPS = 9


def intersect_brute(ray_o, ray_d, v1, v2, v3):
    """ray_o, ray_d: (..., 3); v1, v2, v3: (T, 3).

    Returns (t, tid): t (...,) nearest positive hit or FLOAT_INF; tid (...,)
    int32 triangle index or -1.  Degenerate (padding) triangles fail the
    |det| < EPS test.
    """
    e1 = v2 - v1
    e2 = v3 - v1
    d = ray_d[..., None, :]
    o = ray_o[..., None, :]

    h = cross(d, e2)               # (..., T, 3)
    a = dot(e1, h)
    f = 1.0 / a                    # inf where degenerate; masked below
    s = o - v1
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(d, q)
    t = f * dot(e2, q)

    valid = ((torch.abs(a) >= EPS)
             & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0)
             & (t > 0.0))
    t = torch.where(valid, t, FLOAT_INF)
    tid = torch.argmin(t, dim=-1).to(torch.int32)
    tmin = torch.amin(t, dim=-1)
    tid = torch.where(tmin < FLOAT_INF, tid, -1)
    return tmin, tid


def intersect_plucker(ray_o, ray_d, rows, primary: bool = False):
    """Nearest hit by the Plücker coefficient rows (T, 27) of
    ``ops/cuda/trace_kernel._triangle_params_plucker``: the same hit set as
    Möller–Trumbore up to float reassociation.  With the ray moment
    c = o x d, per triangle

        a = Na.d,  u*a = e2.c + kp.d,  v*a = me1.c + kq.d,  t*a = N.o + nv,

    summed left to right as written.  ``primary``: every ray starts at the
    camera position the rows were packed for (bounce 0), and the sums
    collapse to u*a = pc.d, v*a = qc.d, t*a = r0.  Exact ``1.0 / a``; the
    nearest hit is the first index of the minimum, as in
    :func:`intersect_brute`.  Returns (t, tid) as :func:`intersect_brute`.
    """
    r = [rows[:, i] for i in range(27)]
    d = ray_d[..., None, :]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = r[0] * dx + r[1] * dy + r[2] * dz
    f = 1.0 / a
    if primary:
        p = r[19] * dx + r[20] * dy + r[21] * dz
        q = r[22] * dx + r[23] * dy + r[24] * dz
        t = f * r[25]
    else:
        o = ray_o[..., None, :]
        ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
        cx = oy * dz - oz * dy
        cy = oz * dx - ox * dz
        cz = ox * dy - oy * dx
        p = (r[10] * cx + r[11] * cy + r[12] * cz
             + r[7] * dx + r[8] * dy + r[9] * dz)
        q = (r[16] * cx + r[17] * cy + r[18] * cz
             + r[13] * dx + r[14] * dy + r[15] * dz)
        t = f * (r[3] * ox + r[4] * oy + r[5] * oz + r[6])
    u = f * p
    v = f * q
    valid = ((torch.abs(a) >= EPS) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > 0.0))
    t = torch.where(valid, t, FLOAT_INF)
    tid = torch.argmin(t, dim=-1).to(torch.int32)
    tmin = torch.amin(t, dim=-1)
    tid = torch.where(tmin < FLOAT_INF, tid, -1)
    return tmin, tid


def _mt(o, d, v1, e1, e2):
    """Möller–Trumbore with precomputed edges; broadcasting (..., 3).
    Returns (t, valid); u <= 1 follows from v >= 0 and u + v <= 1."""
    h = cross(d, e2)
    a = dot(e1, h)
    f = 1.0 / a
    s = o - v1
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(d, q)
    t = f * dot(e2, q)
    valid = ((torch.abs(a) >= EPS) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > 0.0))
    return t, valid


def intersect_packed(ray_o, ray_d, rows, rays_per_chunk=None):
    """Nearest hit of flat rays (R, 3) against packed rows (P, >= 9) of
    [v1, e1, e2]: (t (R,), row (R,) int64 or -1).  Argmin-first in row
    order; rays are taken in chunks that bound the (chunk, P) temporaries
    to about 2^22 elements each."""
    tri = rows[:, :9]
    v1, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    R = ray_o.shape[0]
    if rays_per_chunk is None:
        rays_per_chunk = max(1, (1 << 22) // max(1, tri.shape[0]))
    ts, ids = [], []
    for r0 in range(0, R, rays_per_chunk):
        o = ray_o[r0:r0 + rays_per_chunk, None, :]
        d = ray_d[r0:r0 + rays_per_chunk, None, :]
        t, valid = _mt(o, d, v1, e1, e2)
        t = torch.where(valid, t, FLOAT_INF)
        row = torch.argmin(t, dim=-1)
        tmin = torch.amin(t, dim=-1)
        ts.append(tmin)
        ids.append(torch.where(tmin < FLOAT_INF, row, -1))
    if not ts:
        return (ray_o.new_empty((0,)),
                torch.empty((0,), dtype=torch.int64, device=ray_o.device))
    return torch.cat(ts), torch.cat(ids)


def intersect_one_triangle(ray_o, ray_d, v1, v2, v3):
    """Möller–Trumbore of rays against one triangle per ray, all (..., 3)
    (the BVH leaf test).  Returns (t, valid), t = FLOAT_INF where not
    valid."""
    e1 = v2 - v1
    e2 = v3 - v1
    h = cross(ray_d, e2)
    a = dot(e1, h)
    f = 1.0 / a
    s = ray_o - v1
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(ray_d, q)
    t = f * dot(e2, q)
    valid = ((torch.abs(a) >= EPS) & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0))
    return torch.where(valid, t, FLOAT_INF), valid


def aabb_hit(ray_o, inv_ray_d, lb, rt):
    """Slab test: hit iff tmin <= tmax and tmax >= 0."""
    t1 = (lb - ray_o) * inv_ray_d
    t2 = (rt - ray_o) * inv_ray_d
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    return (tmax >= 0.0) & (tmin <= tmax)


def boxes_entered(ray_o, inv_ray_d, t_hit, bounds):
    """(R, B) bool: ray r passes the slab test of box b (rows [lb, rt] of
    ``bounds``) and enters it strictly before its nearest hit ``t_hit``
    (R,): with the box that holds the hit, the boxes any exact
    front-to-back traversal has to open.  A NaN slab (0 * inf) rejects
    here, so the count is never above the kernels'."""
    t1 = (bounds[None, :, 0:3] - ray_o[:, None]) * inv_ray_d[:, None]
    t2 = (bounds[None, :, 3:6] - ray_o[:, None]) * inv_ray_d[:, None]
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    return (tmax >= 0.0) & (tmin <= tmax) & (tmin < t_hit[:, None])


def slab_enter(ray_o, inv_ray_d, lb, rt, best_t):
    """(opened, tmin) of the kernels' box test, all (..., 3) or (...,):
    tmax >= 0, tmin <= tmax and tmin <= best_t.  ``fmin``/``fmax`` ignore a
    NaN slab (0 * inf), as the kernels' ``fminf``/``fmaxf`` do; a box whose
    face holds the current best is opened, so an exact tie there is seen."""
    t1 = (lb - ray_o) * inv_ray_d
    t2 = (rt - ray_o) * inv_ray_d
    lo, hi = torch.fmin(t1, t2), torch.fmax(t1, t2)
    tmin = torch.fmax(torch.fmax(lo[..., 0], lo[..., 1]), lo[..., 2])
    tmax = torch.fmin(torch.fmin(hi[..., 0], hi[..., 1]), hi[..., 2])
    return (tmax >= 0.0) & (tmin <= tmax) & (tmin <= best_t), tmin


def intersect_tree(ray_o, ray_d, tree, depth: int, leaf_start, leaf_count,
                   rows, opened: bool = False):
    """Nearest hit of flat rays (R, 3) by a walk of a box tree
    (``clusters._box_tree``) whose leaf ``j`` holds the packed rows
    [leaf_start[j], leaf_start[j] + leaf_count[j]) of ``rows`` (P, >= 9).

    The kernels' walk, vectorised over rays with a per-ray stack: each loop
    iteration pops one entry of every ray whose stack is not empty and
    skips it when its entry distance is beyond the ray's best ``t``; an
    internal node tests both child boxes (``slab_enter``) and pushes the
    hit ones, the nearer on top; a leaf tests its rows and keeps a row on
    ``t < best_t`` or on ``t == best_t`` with a lower row.  So the result
    is the dense ``intersect_packed``'s (t (R,), row (R,) int64 or -1)
    whatever the visit order.  ``opened``: also return the internal nodes
    and the leaves each ray opened, (R,) int64 each."""
    R, dev = ray_o.shape[0], ray_o.device
    inv_d = 1.0 / ray_d
    kids = tree.view(torch.int32)[:, 12:14].long()
    start, count = leaf_start.long(), leaf_count.long()
    tri = rows[:, :9]
    size = depth + 1
    stack = torch.zeros((R, size), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((R, size), dtype=torch.float32, device=dev)
    stack[:, 0] = 0 if tree.shape[0] else -1   # the root, or the one leaf
    stack_t[:, 0] = -FLOAT_INF
    sp = torch.ones(R, dtype=torch.int64, device=dev)
    best_t = torch.full((R,), FLOAT_INF, dtype=torch.float32, device=dev)
    best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    nodes = torch.zeros(R, dtype=torch.int64, device=dev)
    leaves = torch.zeros(R, dtype=torch.int64, device=dev)
    ks = torch.arange(int(count.max()), device=dev)
    chunk = max(1, (1 << 22) // ks.numel())

    def push(r, entry, t):
        stack[r, sp[r]] = entry
        stack_t[r, sp[r]] = t
        sp[r] += 1

    while True:
        rays = torch.nonzero(sp > 0).squeeze(1)
        if rays.numel() == 0:
            break
        sp[rays] -= 1
        entry = stack[rays, sp[rays]]
        keep = stack_t[rays, sp[rays]] <= best_t[rays]
        rays, entry = rays[keep], entry[keep]

        inner = entry >= 0
        r, nd = rays[inner], entry[inner]
        if r.numel():
            nodes[r] += 1
            o, inv, bt = ray_o[r], inv_d[r], best_t[r]
            h0, t0 = slab_enter(o, inv, tree[nd, 0:3], tree[nd, 3:6], bt)
            h1, t1 = slab_enter(o, inv, tree[nd, 6:9], tree[nd, 9:12], bt)
            swap = t1 < t0           # the nearer child goes on top
            far_h = torch.where(swap, h0, h1)
            far = torch.where(swap, kids[nd, 0], kids[nd, 1])
            far_t = torch.where(swap, t0, t1)
            near_h = torch.where(swap, h1, h0)
            near = torch.where(swap, kids[nd, 1], kids[nd, 0])
            near_t = torch.where(swap, t1, t0)
            push(r[far_h], far[far_h], far_t[far_h])
            push(r[near_h], near[near_h], near_t[near_h])

        r_all, lf_all = rays[~inner], -1 - entry[~inner]
        for c0 in range(0, r_all.numel(), chunk):
            r, lf = r_all[c0:c0 + chunk], lf_all[c0:c0 + chunk]
            leaves[r] += 1
            idx = start[lf][:, None] + ks
            valid = ks < count[lf][:, None]
            idx = torch.where(valid, idx, 0)
            t, ok = _mt(ray_o[r][:, None], ray_d[r][:, None], tri[idx, 0:3],
                        tri[idx, 3:6], tri[idx, 6:9])
            t = torch.where(ok & valid, t, FLOAT_INF)
            k = torch.argmin(t, dim=1, keepdim=True)   # the lowest row
            tk, row = t.gather(1, k)[:, 0], idx.gather(1, k)[:, 0]
            bt, br = best_t[r], best[r]
            better = (tk < bt) | ((tk == bt) & (row < br) & (tk < FLOAT_INF))
            best_t[r] = torch.where(better, tk, bt)
            best[r] = torch.where(better, row, br)
    if opened:
        return best_t, best, nodes, leaves
    return best_t, best


def intersect_bvh(ray_o, ray_d, flat, v1, v2, v3, max_leaf: int,
                  stack_size: int):
    """Per-ray stack traversal of a ``bvh.FlatBVH``.

    ray_o, ray_d: (R, 3); flat on the rays' device; max_leaf: the largest
    leaf; stack_size: per-ray stack capacity (>= depth + 1).  Each loop
    iteration pops one node for every ray whose stack is not empty: a hit
    leaf tests its triangles in range order (strict ``t < best_t``), a hit
    interior node pushes its left, then its right child.  The visit order
    and tie rule are those of the JAX package's ``intersect_bvh``.
    """
    R = ray_o.shape[0]
    dev = ray_o.device
    inv_d = 1.0 / ray_d
    stack = torch.zeros((R, stack_size), dtype=torch.int64, device=dev)
    sp = torch.ones(R, dtype=torch.int64, device=dev)  # root pre-seeded
    best_t = torch.full((R,), FLOAT_INF, dtype=torch.float32, device=dev)
    best_tid = torch.full((R,), -1, dtype=torch.int32, device=dev)
    left, right = flat.left.long(), flat.right.long()
    tri_start, tri_end = flat.tri_start.long(), flat.tri_end.long()
    tri_idx = flat.tri_idx.long()
    ks = torch.arange(max_leaf, device=dev)
    top_slot = stack_size - 1
    while True:
        rays = torch.nonzero(sp > 0).squeeze(1)
        if rays.numel() == 0:
            break
        top = sp[rays] - 1
        node = stack[rays, top]
        sp[rays] = top
        hit = aabb_hit(ray_o[rays], inv_d[rays], flat.lb[node],
                       flat.rt[node])
        is_leaf = left[node] == -1

        leaf = hit & is_leaf
        lr, ln = rays[leaf], node[leaf]
        if lr.numel():
            # All of a leaf's triangles at once; the first minimum in range
            # order that beats best_t wins, as a sequential strict-< scan.
            slot = tri_start[ln][:, None] + ks
            in_range = slot <= tri_end[ln][:, None]
            tri = tri_idx[torch.where(in_range, slot, 0)]
            t, valid = intersect_one_triangle(
                ray_o[lr][:, None, :], ray_d[lr][:, None, :], v1[tri],
                v2[tri], v3[tri])
            t = torch.where(in_range & valid, t, FLOAT_INF)
            k = torch.argmin(t, dim=1, keepdim=True)
            tk = t.gather(1, k)[:, 0]
            better = tk < best_t[lr]
            best_t[lr] = torch.where(better, tk, best_t[lr])
            best_tid[lr] = torch.where(better, tri.gather(1, k)[:, 0].int(),
                                       best_tid[lr])

        push = hit & ~is_leaf
        pr, pn = rays[push], node[push]
        if pr.numel():
            s = sp[pr]
            stack[pr, s.clamp(max=top_slot)] = left[pn]
            stack[pr, (s + 1).clamp(max=top_slot)] = right[pn]
            sp[pr] = s + 2
    return best_t, best_tid
