"""The box trees over clusters and superclusters, and the plain tree walk,
on the CPU.

The cluster and beam kernels walk these trees (``clusters._box_tree``) in
place of a loop over every leaf box; ``ops/intersect.intersect_tree`` is
the same walk in plain PyTorch.  Here the trees are held to their shape
(exact boxes, every leaf once, the recorded depth) and the walk to the
dense ``intersect_packed``, ties included.
"""

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch.ops import intersect as tisect

from test_torch_cuda import _tie_scene

SCENES = {
    "sphere10x20": lambda: tpt.meshes.sphere_in_box(10, 20, device="cpu"),
    "garden2": lambda: tpt.meshes.mesh_garden(grid=2, device="cpu"),
}


def _scene(name):
    return SCENES[name]()[1].build(device="cpu")


def _trees(scene):
    """{kind: (tree, depth, leaf boxes (L, 6), leaf start, leaf count,
    rows)}: the cluster set's tree over its clusters and the beam accel's
    over its superclusters (each supercluster's rows are its clusters')."""
    cs = tpt.build_clusters(scene, max_tris=16)
    acc = tpt.build_beam_accel(scene)
    S = acc.num_superclusters
    return {
        "clusters": (cs.tree, cs.tree_depth, cs.bounds[:, :6], cs.start,
                     cs.count, cs.tri_data),
        "superclusters": (acc.sc_tree, acc.sc_tree_depth,
                          acc.sc_bounds[:S, :6], acc.sc_first * acc.ctris,
                          acc.sc_ncl * acc.ctris, acc.tri_cols),
    }


def _children(tree):
    return tree.view(torch.int32)[:, 12:14].long()


def _random_rays(lo, hi, n, seed):
    """Rays from inside the box [lo, hi], the first tenth parallel to the
    x = const planes (an inverse direction of inf)."""
    gen = np.random.default_rng(seed)
    o = gen.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = gen.normal(size=(n, 3)).astype(np.float32)
    d[: n // 10, 0] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("kind", ["clusters", "superclusters"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_tree_boxes_contain_their_children_exactly(name, kind):
    """A node's box of an internal child is the union of that child's two
    boxes, and its box of a leaf is the leaf's own, bit for bit."""
    tree, _, leaf_boxes, *_ = _trees(_scene(name))[kind]
    kids = _children(tree)
    for slot in (0, 1):
        box = tree[:, 6 * slot:6 * slot + 6]
        c = kids[:, slot]
        inner = c >= 0
        sub = tree[c[inner]]
        union = torch.cat([torch.minimum(sub[:, 0:3], sub[:, 6:9]),
                           torch.maximum(sub[:, 3:6], sub[:, 9:12])], dim=1)
        assert torch.equal(box[inner], union)
        assert torch.equal(box[~inner], leaf_boxes[-1 - c[~inner]])
        # so every box lies inside the one above it
        assert bool((box[inner, 0:3] <= sub[:, 0:3]).all()
                    and (box[inner, 3:6] >= sub[:, 9:12]).all())


@pytest.mark.parametrize("kind", ["clusters", "superclusters"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_every_leaf_is_a_child_once(name, kind):
    tree, _, leaf_boxes, *_ = _trees(_scene(name))[kind]
    kids = _children(tree).reshape(-1)
    L = leaf_boxes.shape[0]
    assert tree.shape == (L - 1, 16)
    assert sorted((-1 - kids[kids < 0]).tolist()) == list(range(L))
    # every internal node but the root is the child of exactly one node
    assert sorted(kids[kids >= 0].tolist()) == list(range(1, L - 1))
    assert bool((tree[:, 14:16] == 0).all())


@pytest.mark.parametrize("kind", ["clusters", "superclusters"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_tree_depth_is_recorded(name, kind):
    """The depth is the internal nodes on the longest root-to-leaf path:
    the stack entries a near-child-first walk needs at most."""
    tree, depth, *_ = _trees(_scene(name))[kind]
    kids = _children(tree)
    level, frontier = 0, [0]
    while frontier:
        level += 1
        frontier = [int(c) for n in frontier for c in kids[n] if c >= 0]
    assert depth == level > 0


def test_one_leaf_has_no_node():
    """A scene of one cluster (and one supercluster): the root is a leaf,
    the tree is empty and its depth 0; the walk tests that leaf alone."""
    _, scene = tpt.cornell_box(res=(8, 8), device="cpu")
    cs = tpt.build_clusters(scene, max_tris=64)
    acc = tpt.build_beam_accel(scene)
    assert cs.num_clusters == acc.num_superclusters == 1
    assert cs.tree.shape == (0, 16) and cs.tree_depth == 0
    assert acc.sc_tree.shape == (0, 16) and acc.sc_tree_depth == 0
    o, d = _random_rays(0.0, 500.0, 300, seed=3)
    o = o + torch.tensor([27.0, 0.0, 0.0])    # inside the box
    t, row = tisect.intersect_tree(o, d, cs.tree, 0, cs.start, cs.count,
                                   cs.tri_data)
    t_p, row_p = tisect.intersect_packed(o, d, cs.tri_data)
    assert torch.equal(t, t_p) and torch.equal(row, row_p)


@pytest.mark.parametrize("kind", ["clusters", "superclusters"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_intersect_tree_matches_dense(name, kind):
    """The walk's (t, row) is the dense argmin's on random rays, rays
    parallel to a slab included; it opens each node at most once, and a
    ray that hits opens at least one leaf."""
    scene = _scene(name)
    tree, depth, leaf_boxes, start, count, rows = _trees(scene)[kind]
    lo = leaf_boxes[:, 0:3].amin(0).numpy()
    hi = leaf_boxes[:, 3:6].amax(0).numpy()
    o, d = _random_rays(lo, hi, 1500, seed=7)
    t, row, nodes, leaves = tisect.intersect_tree(
        o, d, tree, depth, start, count, rows, opened=True)
    t_p, row_p = tisect.intersect_packed(o, d, rows)
    assert int((row_p >= 0).sum()) > 1000
    assert torch.equal(t, t_p) and torch.equal(row, row_p)
    hit = row >= 0
    assert bool((leaves[hit] >= 1).all())
    assert bool((nodes <= tree.shape[0]).all())


def test_intersect_tree_tie_takes_the_lower_row():
    """A triangle duplicated into two clusters: the walk enters the copy of
    the higher row first, and still returns the lower row, as the dense
    argmin does."""
    cam, scene, bvh = _tie_scene("cpu")
    cs = tpt.build_clusters(scene, bvh=bvh, max_tris=1)
    assert cs.num_clusters == 2 and cs.tid_map[:4].tolist() == [0, 1, 2, 3]
    n = 64 * 64
    idx = torch.arange(n)
    half = torch.full((n,), 0.5)
    o, d = tpt.get_rays(cam, idx % 64, idx // 64, half, half)
    t, row = tisect.intersect_tree(o, d, cs.tree, cs.tree_depth, cs.start,
                                   cs.count, cs.tri_data)
    t_p, row_p = tisect.intersect_packed(o, d, cs.tri_data)
    assert torch.equal(t, t_p) and torch.equal(row, row_p)
    assert int((row == 0).sum()) > 100 and int((row == 2).sum()) == 0
    # the green copy's leaf is the nearer one: a walk meets it first
    _, t_near = tisect.slab_enter(o[:1], 1.0 / d[:1], cs.tree[0, 6:9],
                                  cs.tree[0, 9:12], torch.tensor([1e30]))
    _, t_far = tisect.slab_enter(o[:1], 1.0 / d[:1], cs.tree[0, 0:3],
                                 cs.tree[0, 3:6], torch.tensor([1e30]))
    assert float(t_near) < float(t_far)


def test_tree_fields_move_with_the_accels():
    scene = _scene("sphere10x20")
    cs = tpt.build_clusters(scene).to("cpu")
    acc = tpt.build_beam_accel(scene).to("cpu")
    assert cs.tree.dtype == acc.sc_tree.dtype == torch.float32
    assert cs.tree.shape[0] == cs.num_clusters - 1
    assert acc.sc_tree.shape[0] == acc.num_superclusters - 1
