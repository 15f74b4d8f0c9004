"""The benchmark's own mesh generator: a box of tetrahedra.

``tet_box(n)`` cuts [0, 1]^3 into n^3 cubes and each cube into the six
tetrahedra of the Kuhn (Freudenthal) subdivision, the box mesh of
``bench.py`` and ``BASELINE.md`` (n = 55: 998,250 tets, 175,616
points).  Vertex order and orientation follow the upstream library's
convention: every tet has a positive signed volume, and face ``k`` of a
cell is made of its vertices ``k, k+1, k+2`` (cyclic), so
``neighbors[c, k]`` is the cell across that face, or -1 on the boundary
(m_interp_unstructured.f90:327-349).

This file belongs to the yardstick: the benchmark makes the mesh and
hands the same arrays to the system under test and to the reference.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


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


def face_neighbors(cells: np.ndarray, device="cpu") -> np.ndarray:
    """(C, nv) int32 cell across each face (vertices k..k+nv-2 cyclic), -1
    on the boundary; faces matched by one sort of packed vertex keys."""
    c = torch.as_tensor(cells, dtype=torch.int64, device=device)
    n_cells, nv = c.shape
    if nv != 4:
        raise ValueError("face_neighbors takes tetrahedra")
    faces = torch.stack([c[:, [(k + j) % nv for j in range(3)]]
                         for k in range(nv)], dim=1)  # (C, 4, 3)
    faces = faces.sort(dim=2).values
    key = (faces[..., 0] << 42) | (faces[..., 1] << 21) | faces[..., 2]
    key = key.reshape(-1)
    order = torch.argsort(key)
    ks = key[order]
    same = ks[1:] == ks[:-1]
    a, b = order[:-1][same], order[1:][same]
    nb = torch.full((n_cells * nv,), -1, dtype=torch.int64, device=device)
    nb[a] = b // nv
    nb[b] = a // nv
    return nb.reshape(n_cells, nv).to(torch.int32).cpu().numpy()
