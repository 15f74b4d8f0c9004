"""Accurate (compensated-f32) interpolation: accurate mode (torch).

The port of the JAX package's ``ops/interp_acc.py``.  Accurate mode keeps
the float32 machinery for point location and recomputes the weights and
values in double-float arithmetic (:mod:`.df32`, ~48 mantissa bits) from
a packed per-cell row holding the original float64 geometry and data
split into (hi, lo) float32 pairs:

    row = [vhi (npc*3) | vlo (npc*3) | dhi (nv*npc) | dlo (nv*npc)]

padded to 512 bytes, so that both packages build identical tables.  The
weight formulas are the reference's (m_interp_unstructured.f90:529-551
triangle, :553-586 tetra, :588-641 quad) in df32 (``ops/wkern.py`` with
the ``DF`` trait); simplex weights are normalized by their df32 sum.
The values come back as (hi, lo) float32 pairs whose float64 sum holds
~1e-13 on unit-scale meshes, the reference's f64 answers from a float32
grid.

Routes of :func:`interpolate_at_acc`:

* a cold call on a grid with df-plane candidate rows (``cand_df_table``)
  and every slot fused: locate and df32 evaluation from one row per
  query, kernel B2's df-plane branch in bin order
  (``ops/locate._candidates_query_df``), which on the card takes the
  queries as given (float64, or a float32 hi/lo pair) and splits them
  itself;
* everything else: ``get_cell`` (B2 / B3), then
  :func:`interpolate_at_icell_acc`, kernel B5 (``ops/acc_kernel.py``),
  which reads each query's cell row itself.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from . import acc_kernel, locate
from .df32 import split_queries
from .interp import _static_slots
from ..models import cand_table

ACC_ROW_ALIGN = 128  # floats; 512-byte rows, the JAX package's layout


def acc_row_width(npc: int, nv: int) -> int:
    used = npc * 6 + 2 * nv * npc
    return -(-used // ACC_ROW_ALIGN) * ACC_ROW_ALIGN


def supported(grid) -> bool:
    return (
        grid.dtype == torch.float32
        and grid.acc_table is not None
        and grid.cell_type in ("triangle", "quad", "tetra")
    )


def _pack_acc_rows(points, points_lo, cells, pd, pd_lo, *, npc, nv, width):
    """Rows of the cells ``cells`` (n, npc): vertex hi | vertex lo |
    data hi (var-major) | data lo, zero-padded to ``width``."""
    n = cells.shape[0]
    c = cells.long()
    cols = [points[c].reshape(n, npc * 3), points_lo[c].reshape(n, npc * 3)]
    if nv:
        cols.append(pd[c][:, :, :nv].transpose(1, 2).reshape(n, nv * npc))
        cols.append(pd_lo[c][:, :, :nv].transpose(1, 2).reshape(n, nv * npc))
    row = torch.cat(cols, dim=1)
    return torch.nn.functional.pad(row, (0, width - row.shape[1]))


def update_acc_table_column(grid, i_var: int):
    """The acc table with ONE point-data variable's hi/lo slots
    refreshed from ``grid.point_data`` / ``point_data_lo`` (which must
    already hold the new values): two column-slice writes instead of a
    full rebuild.  The grid's old table is left as it was."""
    npc = grid.n_points_per_cell
    nv = grid.n_point_data
    t = grid.acc_table.clone()
    base = 6 * npc
    c = grid.cells.long()
    t[:, base + i_var * npc: base + (i_var + 1) * npc] = (
        grid.point_data[:, i_var][c].to(t.dtype)
    )
    off = base + nv * npc
    if grid.point_data_lo is not None:
        lo = grid.point_data_lo[:, i_var][c].to(t.dtype)
    else:
        lo = torch.zeros((grid.n_cells, npc), dtype=t.dtype, device=t.device)
    t[:, off + i_var * npc: off + (i_var + 1) * npc] = lo
    return t


def build_acc_table(grid):
    """Assemble the packed accurate rows on the grid's device, in chunks
    written into one table."""
    npc = grid.n_points_per_cell
    nv = grid.n_point_data
    width = acc_row_width(npc, nv)
    lo = grid.points_lo
    if lo is None:
        # No stored float64 residuals: the geometry is the float32
        # arrays exactly; accuracy is then limited by the float32
        # representation of the mesh, not by the arithmetic.
        lo = torch.zeros_like(grid.points)
    pd = grid.point_data
    pd_lo = grid.point_data_lo
    if pd_lo is None:
        pd_lo = torch.zeros_like(pd)
    n = grid.n_cells
    out = torch.empty((n, width), dtype=torch.float32, device=grid.device)
    chunk = 1 << 18
    for i in range(0, n, chunk):
        out[i: i + chunk] = _pack_acc_rows(
            grid.points, lo, grid.cells[i: i + chunk], pd, pd_lo,
            npc=npc, nv=nv, width=width,
        )
    return out


def prepare_accurate(grid, build_df: bool = True, timings: dict | None = None):
    """A grid with the accurate-mode tables built (the grid itself when
    they are already there).

    * ``acc_table`` — per-cell (hi, lo) geometry and data rows for
      :func:`interpolate_at_icell_acc` (kernel B5);
    * ``cand_df_table`` (float32 simplex grids whose candidate rows
      cover every bin) — df32 value planes fused into the quantized
      candidate rows, so that a cold accurate query is one row read
      (kernel B2's df-plane branch) instead of locate + a second row
      read + the df32 weights.

    ``build_df=False`` skips the second table (a host float64 plane
    solve over every cell and ~1.3x the candidate table's bytes on the
    device); :func:`interpolate_at_acc` then locates and reads the acc
    rows.

    ``timings``, when given, gets ``acc_table_s``, ``plane_solve_s`` and
    ``df_pack_s`` for the tables this call builds.
    """
    from ..models.grid import _sync

    updates = {}
    if grid.acc_table is None:
        t0 = time.perf_counter()
        updates["acc_table"] = build_acc_table(grid)
        if timings is not None:
            _sync(grid.device)
            timings["acc_table_s"] = time.perf_counter() - t0
    if (build_df and grid.cand_df_table is None
            and cand_table.df_supported(grid)):
        updates["cand_df_table"] = cand_table.build_df_table(grid, timings)
    if not updates:
        return grid
    return dataclasses.replace(grid, **updates)


def interpolate_at_icell_acc(grid, r_hi, i_vars, i_cell, r_lo=None):
    """df32 interpolation at known cells (kernel B5 on CUDA tensors).

    Args:
      grid: float32 grid with ``acc_table`` (see :func:`prepare_accurate`).
      r_hi, r_lo: (B, 3) float32 query split (``r_lo`` zeros if omitted).
      i_vars: point-data variable slots (negative slots wrap).
      i_cell: (B,) located cells; negative cells read cell 0's row.

    Returns (vals_hi, vals_lo): (B, V) float32 pairs whose float64 sum
    carries ~1e-13 accuracy.
    """
    if not supported(grid):
        raise ValueError(
            "grid is not prepared for accurate mode — call "
            "prepare_accurate on a float32 triangle/quad/tetra grid first"
        )
    nv = grid.n_point_data
    slots = _static_slots(i_vars)
    if any(v >= nv or v < -nv for v in slots):
        raise ValueError("i_vars outside the live point-data range")
    slots = tuple(v % max(nv, 1) for v in slots)  # python-style wrap
    r_hi = torch.as_tensor(r_hi, dtype=torch.float32, device=grid.device)
    if r_lo is None:
        r_lo = torch.zeros_like(r_hi)
    r_lo = torch.as_tensor(r_lo, dtype=torch.float32, device=grid.device)
    i_cell = torch.as_tensor(i_cell, device=grid.device).to(torch.int32)
    return acc_kernel.interp_acc(
        grid.acc_table, i_cell, r_hi, r_lo, grid.cell_type,
        grid.n_points_per_cell, nv, slots,
    )


def interpolate_at_acc(grid, r, i_vars, guess=None, r_lo=None):
    """Accurate-mode public entry: float32 locate + df32 interpolate.

    ``r`` may be float64 (split into float32 hi/lo pairs on the grid's
    device: by the kernels themselves on a cold call on the df-plane rows
    on the card) or float32 (pass ``r_lo`` when the queries carry known
    float64 residuals).

    Returns (vals_hi (B, V), vals_lo (B, V), found (B,), i_cell (B,));
    missed queries keep the values of their best candidate or walk end,
    with ``found`` False.
    """
    r = torch.as_tensor(r)
    if r_lo is not None:
        r = r.to(torch.float32)
        r_lo = torch.as_tensor(r_lo, dtype=torch.float32).to(grid.device)
    elif r.dtype != torch.float64:
        r = r.to(torch.float32)
    r = r.to(grid.device)

    # Fused cold path: df-plane candidate rows answer locate AND df32
    # interpolation from one row per query
    slots = _static_slots(i_vars)
    if (
        guess is None
        and grid.cand_df_table is not None
        and cand_table.fuses(grid, slots)
    ):
        ic, found, vh, vl = locate._candidates_query_df(
            grid, r, slots, r_lo=r_lo
        )
        return vh, vl, found, ic

    if r_lo is None:
        r_hi, r_lo = split_queries(r)
    else:
        r_hi = r
    ic, found = locate.get_cell(grid, r_hi, guess=guess)
    vh, vl = interpolate_at_icell_acc(
        grid, r_hi, i_vars, ic.clamp_min(0), r_lo=r_lo
    )
    return vh, vl, found, ic
