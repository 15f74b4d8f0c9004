"""The benchmark's meshes: the generator contract and face matching.

A configuration's ``mesh.generator`` names a module
``iubench/meshes/<generator>.py`` that exposes:

* ``CELL_TYPE``: ``"triangle"``, ``"quad"`` or ``"tetra"``, which must be
  the configuration's ``cell_type``;
* ``make(params) -> (points (P, 3) float64, cells (C, nv) int64)``,
  ``params`` being the configuration's ``mesh`` object; a 2D mesh lies
  in the plane z = 0;
* ``SMALL``: the ``mesh`` keys that shrink it to what a CPU test holds.

Cells follow the upstream library's convention: face ``k`` of a cell is
made of its vertices ``k .. k+npf-1`` (cyclic), ``npf`` being 2 for
triangles and quads and 3 for tets, so ``neighbors[c, k]`` is the cell
across that face, or -1 on the boundary (m_interp_unstructured.f90:
327-349).

This file belongs to the yardstick: the benchmark makes the mesh and
hands the same arrays to the system under test and to the reference.
"""

from __future__ import annotations

import numpy as np
import torch

POINTS_PER_FACE = {"triangle": 2, "quad": 2, "tetra": 3}
ID_BITS = 21  # bits of one vertex id in a face's packed key


def face_neighbors(cells: np.ndarray, cell_type: str,
                   device="cpu") -> np.ndarray:
    """(C, nv) int32 cell across each face, -1 on the boundary; faces
    matched by one sort of packed vertex keys."""
    c = torch.as_tensor(cells, dtype=torch.int64, device=device)
    n_cells, nv = c.shape
    npf = POINTS_PER_FACE[cell_type]
    if int(c.max()) >= 1 << ID_BITS:
        raise ValueError(f"face keys hold vertex ids below 2**{ID_BITS}")
    faces = torch.stack([c[:, [(k + j) % nv for j in range(npf)]]
                         for k in range(nv)], dim=1)  # (C, nv, npf)
    faces = faces.sort(dim=2).values
    key = faces[..., 0]
    for j in range(1, npf):
        key = (key << ID_BITS) | faces[..., j]
    key = key.reshape(-1)
    order = torch.argsort(key)
    ks = key[order]
    same = ks[1:] == ks[:-1]
    a, b = order[:-1][same], order[1:][same]
    nb = torch.full((n_cells * nv,), -1, dtype=torch.int64, device=device)
    nb[a] = b // nv
    nb[b] = a // nv
    return nb.reshape(n_cells, nv).to(torch.int32).cpu().numpy()
