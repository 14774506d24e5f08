#!/usr/bin/env python3
"""What a walk of the box trees saves the port's large-scene kernels
(csrc/beam_kernel.cu, csrc/cluster_kernel.cu), counted from plain-version
traversals.

    python3 bench_torch_large.py predict [--device cpu] [--res 64]

``predict`` traces sphere_in_box(50, 100) (9,812 triangles) and
mesh_garden() (105,708) with the plain beam version at RES^2, 1 spp, depth
5 (the camera keeps its 512^2 pixel size, so this is the view's RES^2
corner, which sees more misses than the whole film), and walks every live ray segment through the beam accel's tree over its
superclusters (``ops/intersect.intersect_tree``): the nodes and the
superclusters a segment opens, against the supercluster boxes a loop over
all of them tests.  It does the same for camera rays of the 512^2 film
against the cluster set's tree over its clusters.  From those counts and
the issue slots assumed below it prints the box and row work per segment
or ray of each design and the predicted kernel speed-up.  The counts are
exact for the plain walk; the slot costs are assumptions, to be checked
against the SASS figures chip_smoke.py prints (phase 2).  Any device will
do; it takes about a minute on a CPU.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import pathtracer_tpu_torch as pt  # noqa: E402
from pathtracer_tpu_torch.camera import get_rays  # noqa: E402
from pathtracer_tpu_torch.ops import intersect as isect  # noqa: E402
from pathtracer_tpu_torch.ops.cuda import beam_kernel as bk  # noqa: E402

DEPTH = 5
CAMERA_RAYS = 1 << 16
# Issue slots assumed per unit of work (thread-instructions): a box of a
# flat loop (load, slab test, branch), a tree node (two box tests, the near
# child's choice, a push or a pop), a row test (Möller–Trumbore with the
# reciprocal's fast path in the beam kernel, the IEEE division in the
# cluster kernel: 55-61 and 73 slots in the trace kernel's SASS) and
# a segment's shading and set-up.
SLOTS = {"box": 30, "node": 80, "row_beam": 60, "row_cluster": 73,
         "segment": 400}

SCENES = {"sphere9812": lambda dev: pt.meshes.sphere_in_box(50, 100,
                                                             device=dev),
          "garden105708": lambda dev: pt.meshes.mesh_garden(device=dev)}


def beam_counts(cam, scene, res):
    """Per live segment at res^2, 1 spp: the flat loop's box tests, the
    tree walk's nodes and the superclusters it opens, the rows both test."""
    cam = dataclasses.replace(cam, res=(res, res))
    accel = bk._accel_for(scene)
    segments = []
    bk.render_tiles_beam_reference(cam, scene, 0, 1, DEPTH, accel=accel,
                                   segments=segments)
    S, ctris = accel.num_superclusters, accel.ctris
    start = accel.sc_first * ctris
    count = accel.sc_ncl * ctris
    work = bk.count_work(cam, scene, 0, 1, DEPTH)
    live = work["live_segments"]
    nodes = leaves = 0
    for o, d, _, _ in segments:
        _, _, n, lv = isect.intersect_tree(
            o, d, accel.sc_tree, accel.sc_tree_depth, start, count,
            accel.tri_cols, opened=True)
        nodes += int(n.sum())
        leaves += int(lv.sum())
    mean_ncl = float(accel.sc_ncl.float().mean())
    return {"superclusters": S, "tree_depth": accel.sc_tree_depth,
            "live_segments": live,
            "flat_sc_boxes": S,
            "needed_sc_boxes": work["sc_box_tests"] / live,
            "needed_cluster_boxes": work["cluster_box_tests"] / live,
            "rows": work["rows"] / live,
            "tree_nodes": nodes / live, "tree_leaves": leaves / live,
            "tree_cluster_boxes": leaves / live * mean_ncl}


def cluster_counts(cam, scene):
    """Per camera ray of the 512^2 film: the flat loop's box tests and the
    tree walk's nodes and clusters, the rows both test."""
    cs = pt.build_clusters(scene)
    gen = np.random.default_rng(9)
    n = CAMERA_RAYS
    w = torch.from_numpy(gen.integers(0, 512, n))
    h = torch.from_numpy(gen.integers(0, 512, n))
    u = torch.from_numpy(gen.random((2, n), np.float32))
    o, d = get_rays(cam, w, h, u[0], u[1])
    _, _, nodes, leaves = isect.intersect_tree(
        o, d, cs.tree, cs.tree_depth, cs.start, cs.count, cs.tri_data,
        opened=True)
    mean_count = float(cs.count.float().mean())
    return {"clusters": cs.num_clusters, "tree_depth": cs.tree_depth,
            "flat_boxes": cs.num_clusters,
            "tree_nodes": float(nodes.float().mean()),
            "tree_clusters": float(leaves.float().mean()),
            "rows": float(leaves.float().mean()) * mean_count}


def predict(device: str, res: int) -> dict:
    out = {}
    for name, make in SCENES.items():
        cam, sb = make(device)
        scene = sb.build(device=device)
        b = beam_counts(cam, scene, res)
        flat = ((b["flat_sc_boxes"] + b["tree_cluster_boxes"]) * SLOTS["box"]
                + b["rows"] * SLOTS["row_beam"] + SLOTS["segment"])
        tree = (b["tree_nodes"] * SLOTS["node"]
                + b["tree_cluster_boxes"] * SLOTS["box"]
                + b["rows"] * SLOTS["row_beam"] + SLOTS["segment"])
        b.update(flat_slots=flat, tree_slots=tree, speedup=flat / tree)
        c = cluster_counts(cam, scene)
        flat = c["flat_boxes"] * SLOTS["box"] + c["rows"] * SLOTS[
            "row_cluster"]
        tree = c["tree_nodes"] * SLOTS["node"] + c["rows"] * SLOTS[
            "row_cluster"]
        c.update(flat_slots=flat, tree_slots=tree, speedup=flat / tree)
        out[name] = {"beam": b, "cluster": c}
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("predict")
    p.add_argument("--device", default="cuda")
    p.add_argument("--res", type=int, default=64)
    args = ap.parse_args()
    print(json.dumps({"slots": SLOTS, "predict": predict(args.device,
                                                         args.res)}),
          flush=True)


if __name__ == "__main__":
    main()
