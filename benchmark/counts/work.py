"""Frozen work counts: the floating-point operations a render needs,
whatever implements it, for the kernels' roofline shares.

Counted from the plain formulas, comparisons not counted:
  * a Plücker row test: a, 1/a, the u*a and v*a sums, t*a, three products
    by 1/a and u + v: 38 operations, 20 with the bounce-0 collapse (every
    ray at the camera); the ray moment o x d: 9, once a segment;
  * a slab test of a box: 22;
  * a diffuse bounce that goes on: 48; a camera ray: 29.

These are computed counts, not measurements: the live segments come from
the plain reference's paths on a seeded sample of the work (``sample``),
scaled to the whole work.
"""

from __future__ import annotations

import numpy as np
import torch

PLUCKER_OPS = 38
PLUCKER_PRIMARY_OPS = 20
MOMENT_OPS = 9
SLAB_OPS = 22
SHADE_OPS = 48
CAMERA_OPS = 29


def trace_ops(num_tris: int, live_segments: int, paths: int) -> int:
    """Operations of a render of ``paths`` paths that trace
    ``live_segments`` segments while alive, against every one of
    ``num_tris`` triangles: each path's first segment with the bounce-0
    collapse, every later one with the full test after its moment; every
    segment but a path's last bounces on; every path starts with a camera
    ray."""
    later = live_segments - paths
    return (paths * num_tris * PLUCKER_PRIMARY_OPS
            + later * (num_tris * PLUCKER_OPS + MOMENT_OPS)
            + later * SHADE_OPS + paths * CAMERA_OPS)


def sample(rng: np.random.Generator, width: int, height: int, samples: int,
           n: int):
    """``n`` (pixel, sample) paths drawn uniformly from a job: (w, h, sidx)
    int64 numpy arrays."""
    pix = rng.integers(0, width * height, n)
    return pix % width, pix // width, rng.integers(0, samples, n)


def boxes_entered(o, inv_d, t_hit, bounds):
    """(R, B): ray r passes the slab test of box b and enters it strictly
    before its nearest hit."""
    t1 = (bounds[None, :, 0:3] - o[:, None]) * inv_d[:, None]
    t2 = (bounds[None, :, 3:6] - o[:, None]) * inv_d[:, None]
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    return (tmax >= 0.0) & (tmin <= tmax) & (tmin < t_hit[:, None])


def beam_work(segments, layout, chunk_boxes: int = 1 << 22) -> dict:
    """The work of an exact two-level traversal of ``layout``
    (``beam_layout.Layout``: boxes over superclusters, then over their
    clusters, then the rows of each cluster) for the live segments
    ``[(o, d, t, tid)]``: each segment opens the supercluster boxes it
    enters before its nearest hit and the one that holds the hit, in those
    the cluster boxes it enters before the hit and the one that holds it,
    and tests ``ctris`` rows in each cluster so counted.  Operations:
    SLAB_OPS a box, PLUCKER_OPS a row, and a segment's MOMENT_OPS,
    SHADE_OPS and three divisions for its reciprocal direction."""
    dev = segments[0][0].device if segments else torch.device("cpu")
    sc_bounds = torch.from_numpy(layout.sc_bounds).to(dev)
    cl_bounds = torch.from_numpy(layout.cl_bounds).to(dev)
    sc_ncl = torch.from_numpy(layout.sc_ncl).to(dev)
    cluster_of_tri = torch.from_numpy(layout.cluster_of_tri).to(dev)
    S, C = sc_ncl.shape[0], int(sc_ncl.sum())
    cl_sc = torch.repeat_interleave(torch.arange(S, device=dev), sc_ncl)
    sc_ids = torch.arange(S, device=dev)
    cl_ids = torch.arange(C, device=dev)
    live = sc_boxes = cl_boxes = 0
    chunk = max(1, chunk_boxes // max(C, 1))
    for o_all, d_all, t_all, tid_all in segments:
        live += o_all.shape[0]
        for r0 in range(0, o_all.shape[0], chunk):
            o, d = o_all[r0:r0 + chunk], d_all[r0:r0 + chunk]
            t, inv = t_all[r0:r0 + chunk], 1.0 / d
            tid = tid_all[r0:r0 + chunk].long()
            hit_cl = torch.where(tid >= 0, cluster_of_tri[tid.clamp_min(0)],
                                 -1)
            hit_sc = torch.where(tid >= 0, cl_sc[hit_cl.clamp_min(0)], -1)
            sc_in = (boxes_entered(o, inv, t, sc_bounds)
                     | (sc_ids == hit_sc[:, None]))
            cl_in = ((boxes_entered(o, inv, t, cl_bounds)
                      & sc_in[:, cl_sc]) | (cl_ids == hit_cl[:, None]))
            sc_boxes += int(sc_in.sum())
            cl_boxes += int(cl_in.sum())
    rows = cl_boxes * layout.ctris
    return {"live_segments": live, "sc_box_tests": sc_boxes,
            "cluster_box_tests": cl_boxes, "rows": rows,
            "ops": ((sc_boxes + cl_boxes) * SLAB_OPS + rows * PLUCKER_OPS
                    + live * (MOMENT_OPS + SHADE_OPS + 3))}
