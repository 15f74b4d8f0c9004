"""Mesh generator ``tet_box``: a box of tetrahedra.

``tet_box(n)`` cuts [0, 1]^3 into n^3 cubes and each cube into the six
tetrahedra of the Kuhn (Freudenthal) subdivision, the box mesh of
``bench.py`` and ``BASELINE.md`` (n = 55: 998,250 tets, 175,616
points).  Vertex order and orientation follow the upstream library's
convention: every tet has a positive signed volume, and face ``k`` of a
cell is made of its vertices ``k, k+1, k+2`` (cyclic).

Configuration keys (``mesh``): ``cubes_per_side``.
"""

from __future__ import annotations

import itertools

import numpy as np

CELL_TYPE = "tetra"
SMALL = {"cubes_per_side": 8}  # what a CPU test can hold


def make(params: dict):
    return tet_box(int(params["cubes_per_side"]))


def tet_box(n: int):
    """(points (P, 3) float64, cells (C, 4) int64) of the n^3-cube box."""
    g = np.linspace(0.0, 1.0, n + 1)
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    points = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    strides = np.array([(n + 1) * (n + 1), n + 1, 1], dtype=np.int64)
    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                          indexing="ij")
    base = (i.ravel() * strides[0] + j.ravel() * strides[1]
            + k.ravel()).astype(np.int64)
    blocks = []
    for perm in itertools.permutations(range(3)):
        # the path (0,0,0) -> (1,1,1) through the axes in the order perm
        offs = np.concatenate([[0], np.cumsum(strides[list(perm)])])
        tet = base[:, None] + offs[None, :]
        p = points[tet[0]]
        if np.dot(p[1] - p[0], np.cross(p[2] - p[0], p[3] - p[0])) < 0:
            tet = tet[:, [0, 1, 3, 2]]
        blocks.append(tet)
    return points, np.concatenate(blocks, axis=0)
