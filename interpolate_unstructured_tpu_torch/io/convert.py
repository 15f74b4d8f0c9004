"""Face-adjacency tables for meshes (host-side, numpy).

The port's copy of ``get_cell_neighbors`` from the JAX package's
``io/convert.py`` (the converter itself and the mesh readers come in a
later slice).  It is numpy; it lives here so that the port never
imports the JAX package, whose ``__init__`` imports jax.

The neighbor computation is vectorized (lexsorted face keys instead of a
Python dict): O(F log F) in numpy instead of a per-face dict loop.
"""

from __future__ import annotations

import numpy as np


def get_cell_neighbors(
    cells: np.ndarray, points: np.ndarray, n_points_face: int
) -> np.ndarray:
    """Face-adjacency table: ``neighbors[i_cell, k]`` is the cell across
    face ``k`` (vertices ``(k, .., k+n_points_face-1)`` cyclic), or -1.

    Mirrors the face convention of convert_to_binary.py:139-162 /
    m_interp_unstructured.f90:327-349: face k of a cell consists of
    vertices ``(cell[(k+j) % n_vertices] for j < n_points_face)``.
    Duplicate points are merged first for robustness (:130-136).
    """
    cells = np.asarray(cells)
    n_cells, n_vertices = cells.shape

    # Merge duplicate points so faces match across duplicated vertices
    _, idx = np.unique(points, axis=0, return_inverse=True)
    cells_uniq = idx.reshape(-1)[cells.reshape(-1)].reshape(cells.shape)

    # Group identical faces with ONE argsort over packed scalar keys; a
    # run of exactly two equal keys links the pair of owner cells
    # (convert_to_binary.py:157; degenerate >2-owner faces stay
    # boundary, like the reference).  Keys are built column-wise with a
    # min/max sorting network — no (C, nv, npf) materialization, no
    # row-wise np.sort (both are scattered-access patterns this path
    # used to spend ~80% of its time in).
    n_unique_points = int(cells_uniq.max(initial=0)) + 1
    if n_points_face in (2, 3) and n_unique_points < (1 << 21):
        keys2d = np.empty((n_cells, n_vertices), dtype=np.int64)
        for f in range(n_vertices):
            a = cells_uniq[:, f].astype(np.int64)
            b = cells_uniq[:, (f + 1) % n_vertices].astype(np.int64)
            if n_points_face == 2:
                lo = np.minimum(a, b)
                hi = np.maximum(a, b)
                keys2d[:, f] = (lo << 21) | hi
            else:
                c = cells_uniq[:, (f + 2) % n_vertices].astype(np.int64)
                lo = np.minimum(np.minimum(a, b), c)
                hi = np.maximum(np.maximum(a, b), c)
                mid = a + b + c - lo - hi
                keys2d[:, f] = (lo << 42) | (mid << 21) | hi
        keys = keys2d.reshape(-1)
    else:
        # Generic fallback: sorted face tuples via a void byte view
        fidx = (
            np.arange(n_vertices)[:, None]
            + np.arange(n_points_face)[None, :]
        ) % n_vertices
        faces = np.sort(
            cells_uniq[:, fidx].reshape(-1, n_points_face), axis=1
        )
        faces_c = np.ascontiguousarray(faces)
        keys = faces_c.view(
            np.dtype((np.void, faces_c.dtype.itemsize * n_points_face))
        ).reshape(-1)

    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    same_next = np.zeros(len(sk), dtype=bool)
    same_next[:-1] = sk[:-1] == sk[1:]
    same_prev = np.zeros(len(sk), dtype=bool)
    same_prev[1:] = same_next[:-1]
    run_continues = np.zeros(len(sk), dtype=bool)  # sk[i+1] == sk[i+2]
    run_continues[:-1] = same_next[1:]
    pos = np.flatnonzero(same_next & ~same_prev & ~run_continues)

    neighbors = np.full((n_cells, n_vertices), -1, dtype=np.int32)
    flat = neighbors.reshape(-1)
    # order[] is the flat (cell * n_vertices + face_k) slot of each face
    slot_a = order[pos]
    slot_b = order[pos + 1]
    flat[slot_a] = slot_b // n_vertices
    flat[slot_b] = slot_a // n_vertices
    return neighbors
