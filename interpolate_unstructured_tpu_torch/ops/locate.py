"""Batched cold point location (torch).

The port of the JAX package's ``ops/locate.py`` for the cold path:

* ``_containment_margins`` — margins of every query against every cell,
  the brute-force inside test (m_interp_unstructured.f90:766-786);
* ``_candidates_query`` — the per-bin candidate rows: one row per query
  answers "which cell contains r" and, for fused variables, the
  interpolated values (kernel B2, ``ops/cand_kernel.py``); overflow
  bins probe their extension row.

The warm path (``get_cell`` with a guess, the neighbor walk) and the
residual walk of grids whose extension rows do not cover every bin come
with a later slice and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import torch

from . import cand_kernel, geometry


def _containment_margins(grid, r):
    """margins[b, c] = min over faces k of (d[c,k] - r_b . n[c,k]), the
    dot product in the brute-force kernel's order ((x + y) + z).  A
    point is inside cell c iff margins[b, c] >= -eps."""
    n = grid.face_normals
    rx, ry, rz = (r[:, d, None, None] for d in range(3))
    m = grid.face_offsets[None] - (
        (n[None, :, :, 0] * rx + n[None, :, :, 1] * ry) + n[None, :, :, 2] * rz
    )
    return m.amin(dim=2)


def _cand_bin_ijk(grid, r):
    """Clipped integer candidate-bin coordinates of (B, 3) queries —
    floor((r - rmin) * inv_h) per axis, as the JAX package computes
    them (clipped before the integer conversion)."""
    return [
        torch.clamp(
            torch.floor((r[:, d] - grid.cand_rmin[d]) * grid.cand_inv_h[d]),
            0, grid.cand_shape[d] - 1,
        ).to(torch.int32)
        for d in range(3)
    ]


def _cand_bin_flat(grid, ijk):
    """Flat candidate-bin index from integer coordinates — THE encode
    (inverse: geometry.cand_bin_decode)."""
    _, nby, nbz = grid.cand_shape
    return (ijk[0] * nby + ijk[1]) * nbz + ijk[2]


def _cand_local(grid, r, ijk):
    """(B, 3) queries in their bin's local frame (bin centers via the
    shared geometry.cand_bin_center_cols, bitwise-matching the packer)."""
    cx, cy, cz = geometry.cand_bin_center_cols(
        grid.cand_rmin, grid.cand_inv_h, ijk[0], ijk[1], ijk[2]
    )
    return torch.stack([r[:, 0] - cx, r[:, 1] - cy, r[:, 2] - cz], dim=1)


def _cand_chunk(grid, table=None) -> int:
    """Queries per chunk of the plain probe: the gathered rows
    (chunk x row bytes) stay near ``config.cand_chunk_bytes``; rounded
    to a multiple of 8192; ``config.cand_chunk_queries`` overrides."""
    cfg = grid.config
    if cfg.cand_chunk_queries is not None:
        return cfg.cand_chunk_queries
    tab = grid.cand_table if table is None else table
    row_b = tab.shape[1] * tab.element_size()
    return max(1 << 13, (cfg.cand_chunk_bytes // row_b) >> 13 << 13)


def _row_layout(grid, k, var_slots) -> cand_kernel.RowLayout:
    """The :class:`cand_kernel.RowLayout` of this grid's rows with ``k``
    candidates per row (main table: K; extension table: k_ext)."""
    from ..models.grid import (
        _qcand_floats_per,
        cand_fused_nv,
        cand_is_quantized,
    )

    nf = npc = grid.n_faces_per_cell
    nv = cand_fused_nv(grid)
    if any(not 0 <= s < nv for s in var_slots):
        raise ValueError("var_slots outside the fused variable range")
    if cand_is_quantized(grid.cell_type, grid.dtype, grid.config):
        base = -(-3 * nf // 2) + -(-nf // 2)
        return cand_kernel.RowLayout(
            kind="quantized", nf=nf, k=k, id_role=base + 4 * nv,
            count_col=k * _qcand_floats_per(grid.cell_type, nv),
            var_roles=tuple(base + 4 * s for s in var_slots),
        )
    is_quad = grid.cell_type == "quad"
    id_role = 4 * nf + (3 * npc if is_quad else 0)
    return cand_kernel.RowLayout(
        kind="quad" if is_quad else "simplex", nf=nf, k=k, id_role=id_role,
        count_col=k * (id_role + 1 + npc * nv),
        var_roles=tuple(id_role + 1 + s * npc for s in var_slots),
    )


def _cand_eps(grid) -> float:
    """Inside tolerance of the probe: int16 rounding makes quantized
    planes fuzzy within grid.cand_qeps of the true faces, so the
    tolerance widens by it and interior points are never lost."""
    return grid.config.eps_inside + grid.cand_qeps


def _cand_probe_inputs(grid, r):
    """(idx (B,) int32, rq (B, 3)) of the main-table probe: each
    query's bin, and the query in that bin's local frame when the rows
    are quantized."""
    ijk = _cand_bin_ijk(grid, r)
    idx = _cand_bin_flat(grid, ijk)
    from ..models.grid import cand_is_quantized

    if cand_is_quantized(grid.cell_type, grid.dtype, grid.config):
        return idx, _cand_local(grid, r, ijk)
    return idx, r.contiguous()


def _candidates_query(grid, r, var_slots):
    """Cold containment and fused interpolation via per-bin candidate
    rows (the JAX package's ``_candidates_query``, ops/locate.py:769).

    One row per query carries the face planes (and fused values) of
    every cell intersecting the query's bin.  Where the bin's list is
    complete, a miss is exact: the point is outside the mesh.  Queries
    of overflow bins that no stored candidate contains probe the bin's
    extension row (candidates K..K+k_ext, same layout, same kernel);
    they are found with ``torch.nonzero``.

    Returns (i_cell (B,) int32, found (B,) bool, values (B, V)).
    """
    if not grid.cand_ext_covers:
        raise NotImplementedError(
            "this grid has bins whose candidates exceed K + k_ext and "
            "needs the residual walk, which comes with the warm-path "
            "slice of the port (raise cand_ext_max_k to cover them)"
        )
    var_slots = tuple(var_slots)
    k_max = grid.cand_ids.shape[1]
    eps = _cand_eps(grid)
    idx, rq = _cand_probe_inputs(grid, r)
    id_best, aux, values = cand_kernel.cand_rows_query(
        grid.cand_table, idx, rq, _row_layout(grid, k_max, var_slots),
        eps, k_max, _cand_chunk(grid),
    )
    found = aux == -2
    ic = torch.where(found, id_best, -1)
    if grid.cand_ext_table is None:
        # every bin's complete list fits its row: a miss is exact
        return ic, found, values

    # aux >= 0 marks overflow-bin misses; aux is the extension slot
    sel = torch.nonzero(aux >= 0).squeeze(1)
    if sel.numel():
        k_ext = grid.cand_ext_ids.shape[1]
        id2, aux2, vals2 = cand_kernel.cand_rows_query(
            grid.cand_ext_table, aux[sel].contiguous(), rq[sel],
            _row_layout(grid, k_ext, var_slots), eps, k_max + k_ext,
            _cand_chunk(grid, grid.cand_ext_table),
        )
        found2 = aux2 == -2
        ic[sel] = torch.where(found2, id2, -1)
        values[sel] = torch.where(found2[:, None], vals2, values[sel])
    return ic, ic >= 0, values
