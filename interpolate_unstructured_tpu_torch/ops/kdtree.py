"""Implicit-layout batched kd-tree: exact 1-NN over cell centers.

The port of the JAX package's ``ops/kdtree.py``, the parity component
for the reference's L0 spatial index (kdtree2 submodule; usage
m_interp_unstructured.f90:251-288).  It seeds the cold walks of
``seed_mode="kdtree"`` grids only; the default cold start is the bin
seed table.

* **left-balanced implicit layout** built on the host (numpy): node
  ``i``'s children are ``2i+1`` / ``2i+2``, the split dimension cycles
  with depth, so traversal needs no pointers and the whole tree is two
  flat tensors;
* **fixed-size explicit stack** per query (depth <= ceil(log2 n)+2),
  batched over queries in a loop with an active mask and best-distance
  pruning.  The JAX package ran this loop in XLA, not in a Pallas
  kernel, so its port is plain torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..utils import timing


@dataclass(frozen=True)
class KdTree:
    """Implicit left-balanced kd-tree over a point set."""

    node_points: Any  # (M, 3) point coordinates per tree node
    node_ids: Any  # (M,) int32 original point index per node
    n_nodes: int  # number of real nodes (== n_points)
    max_depth: int  # stack bound for traversal


def _left_subtree_size(n: int) -> int:
    """Nodes in the left subtree of a left-balanced tree of n nodes."""
    if n <= 1:
        return 0
    h = n.bit_length() - 1  # complete-tree height
    last_row = n - (2**h - 1)
    return 2 ** (h - 1) - 1 + min(last_row, 2 ** (h - 1))


def build_kdtree(points: np.ndarray, dtype=torch.float64,
                 device=None) -> KdTree:
    """Host-side construction (numpy): median splits on cycling dims,
    the JAX package's tree node for node.  The node tensors land on
    ``device`` — by default the CUDA device, and a process without one
    raises (pass ``"cpu"`` for the host) — the coordinates in
    ``dtype``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_kdtree puts the tree on the CUDA device by default, "
                "and torch.cuda.is_available() is false; pass device='cpu' "
                "to build on the host"
            )
        device = "cuda"
    points = np.asarray(points, dtype=np.float64)
    n, k = points.shape
    if k != 3:
        raise ValueError("kd-tree expects (n, 3) points")
    node_ids = np.full(n, -1, dtype=np.int32)

    # Iterative construction: (node, ids, depth)
    stack = [(0, np.arange(n, dtype=np.int64), 0)]
    max_depth = 1
    while stack:
        node, ids, depth = stack.pop()
        m = len(ids)
        if m == 0:
            continue
        max_depth = max(max_depth, depth + 1)
        if m == 1:
            node_ids[node] = ids[0]
            continue
        dim = depth % 3
        s = _left_subtree_size(m)
        part = np.argpartition(points[ids, dim], s)
        ids = ids[part]
        node_ids[node] = ids[s]
        stack.append((2 * node + 1, ids[:s], depth + 1))
        stack.append((2 * node + 2, ids[s + 1:], depth + 1))

    return KdTree(
        node_points=torch.from_numpy(points[node_ids]).to(
            device=device, dtype=dtype
        ),
        node_ids=torch.from_numpy(node_ids).to(device),
        n_nodes=n,
        max_depth=max_depth + 1,
    )


def nearest(tree: KdTree, r):
    """Batched exact 1-NN query (kdtree2_n_nearest(tree, r, 1, res),
    find_nearby_cell_kdtree, :272-288).

    Args:
      r: (B, 3) query points, on the tree's device and in its dtype.
    Returns:
      (idx, dist2): (B,) int32 original point index of the nearest
      neighbor and its squared distance.

    Each pass of the loop reads back whether any stack is left: host
    read ``kdtree_nearest`` (``utils/timing.host_read``).
    """
    b = r.shape[0]
    n = tree.n_nodes
    dev = r.device
    # Sentinel in the QUERY dtype: an f32-max sentinel in f64 would
    # return node 0 whenever all true distances exceed ~3.4e38
    big = torch.finfo(r.dtype).max
    # every node is pushed at most once, so pops <= pushes <= 2n + 1
    max_iters = 2 * n + 2

    width = tree.max_depth + 2  # one slack column above the DFS depth
    rows = torch.arange(b, device=dev)
    stack_node = torch.zeros((b, width), dtype=torch.int64, device=dev)
    stack_pd2 = torch.zeros((b, width), dtype=r.dtype, device=dev)
    sp = torch.ones(b, dtype=torch.int64, device=dev)  # root, pd2 = 0
    best_idx = torch.zeros(b, dtype=torch.int32, device=dev)
    best_d2 = torch.full((b,), big, dtype=r.dtype, device=dev)

    def push(sp, do, node_val, pd2_val):
        sel = torch.nonzero(do).squeeze(1)
        stack_node[sel, sp[sel]] = node_val[sel]
        stack_pd2[sel, sp[sel]] = pd2_val[sel]
        return sp + do.to(sp.dtype)

    it = 0
    while it < max_iters:
        with timing.host_read("kdtree_nearest", sp):
            if not bool((sp > 0).any()):
                break
        active = sp > 0
        top = (sp - 1).clamp_min(0)
        node = stack_node[rows, top]
        pd2 = stack_pd2[rows, top]
        sp = torch.where(active, sp - 1, sp)

        # Prune subtrees that cannot contain a closer point
        visit = active & (pd2 < best_d2) & (node < n)

        node_c = node.clamp_max(n - 1)
        diff = r - tree.node_points[node_c]
        d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + (
            diff[:, 2] * diff[:, 2]
        )
        closer = visit & (d2 < best_d2)
        best_d2 = torch.where(closer, d2, best_d2)
        best_idx = torch.where(closer, tree.node_ids[node_c], best_idx)

        # Split plane: dim cycles with depth = floor(log2(node + 1)),
        # exact through frexp's integer exponent
        _, expo = torch.frexp((node + 1).to(torch.float64))
        dim = (expo.to(torch.int64) - 1) % 3
        delta = diff.gather(1, dim[:, None])[:, 0]
        near = torch.where(delta < 0, 2 * node + 1, 2 * node + 2)
        far = torch.where(delta < 0, 2 * node + 2, 2 * node + 1)

        # Push the far child (pruned later by its plane distance), then
        # the near child
        sp = push(sp, visit & (far < n), far, delta * delta)
        sp = push(sp, visit & (near < n), near, torch.zeros_like(delta))
        it += 1
    return best_idx, best_d2
