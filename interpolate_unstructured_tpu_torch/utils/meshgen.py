"""Synthetic structured-topology mesh generators (host-side, numpy).

The port's copy of the JAX package's ``utils/meshgen.py``: the same
meshes, vertex order and neighbor tables, so that tests can hand one
mesh to both packages and ``chip_smoke.py`` can build the 998,250-tet
mesh of ``bench.py`` without mesh files or jax.
"""

from __future__ import annotations

import numpy as np

from ..io.convert import get_cell_neighbors


def triangle_rect_mesh(nx: int, ny: int, extent=(2.0, 2.0)):
    """(nx x ny)-cell rectangle triangulated into 2*nx*ny triangles.

    Returns (points (P,3), cells (C,3), neighbors (C,3)).
    """
    xs = np.linspace(0.0, extent[0], nx + 1)
    ys = np.linspace(0.0, extent[1], ny + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    points = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = vid(i, j).ravel()
    v10 = vid(i + 1, j).ravel()
    v01 = vid(i, j + 1).ravel()
    v11 = vid(i + 1, j + 1).ravel()
    # Split each square along the v00-v11 diagonal
    tris = np.concatenate(
        [
            np.stack([v00, v10, v11], axis=1),
            np.stack([v00, v11, v01], axis=1),
        ],
        axis=0,
    ).astype(np.int64)
    neighbors = get_cell_neighbors(tris, points, 2)
    return points, tris, neighbors


def quad_rect_mesh(nx: int, ny: int, extent=(2.0, 2.0)):
    """(nx x ny)-cell structured quad mesh."""
    xs = np.linspace(0.0, extent[0], nx + 1)
    ys = np.linspace(0.0, extent[1], ny + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    points = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    quads = np.stack(
        [
            vid(i, j).ravel(),
            vid(i + 1, j).ravel(),
            vid(i + 1, j + 1).ravel(),
            vid(i, j + 1).ravel(),
        ],
        axis=1,
    ).astype(np.int64)
    neighbors = get_cell_neighbors(quads, points, 2)
    return points, quads, neighbors


def tet_box_mesh(nx: int, ny: int, nz: int, extent=(1.0, 1.0, 1.0)):
    """Box meshed with 6 tetrahedra per cube (Kuhn/Freudenthal
    subdivision — conforming across cube faces).

    Returns (points (P,3), cells (C,4), neighbors (C,4)); all tets have
    positive orientation (positive signed volume), which the volume
    computation assumes (m_interp_unstructured.f90:400-408).
    """
    import itertools

    xs = np.linspace(0.0, extent[0], nx + 1)
    ys = np.linspace(0.0, extent[1], ny + 1)
    zs = np.linspace(0.0, extent[2], nz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    points = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)

    # Flat vertex id of each cube's (0,0,0) corner + per-axis strides
    strides = np.array([(ny + 1) * (nz + 1), nz + 1, 1], dtype=np.int64)
    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    base = (
        i.ravel() * strides[0] + j.ravel() * strides[1] + k.ravel()
    ).astype(np.int64)

    cells = []
    for perm in itertools.permutations(range(3)):
        # Path from corner (0,0,0) to (1,1,1) through axis order `perm`:
        # vertex offsets are prefix sums of the axis strides, so the
        # whole permutation block is one broadcast add over `base`
        offs = np.concatenate([[0], np.cumsum(strides[list(perm)])])
        tet = base[:, None] + offs[None, :]  # (n_cubes, 4)
        # All cubes are congruent and axis-aligned: orientation is a
        # per-permutation constant — test one representative tet and
        # swap two vertices for the whole block when negative
        p = points[tet[0]]
        vol = np.dot(
            p[1] - p[0], np.cross(p[2] - p[0], p[3] - p[0])
        )
        if vol < 0:
            tet = tet[:, [0, 1, 3, 2]]
        cells.append(tet)
    cells = np.concatenate(cells, axis=0)
    neighbors = get_cell_neighbors(cells, points, 3)
    return points, cells, neighbors
