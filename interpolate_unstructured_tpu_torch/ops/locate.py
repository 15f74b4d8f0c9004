"""Batched point location: which cell contains each query point? (torch)

The port of the JAX package's ``ops/locate.py``
(m_interp_unstructured.f90:272-288, :412-434, :664-786):

* ``bin_seed`` / ``kd_seed`` — cold-start seed cells: one lookup in the
  per-bin seed table, or the exact nearest cell center (kd-tree);
* ``locate_bruteforce`` — exact containment against every cell (small
  meshes);
* ``walk`` — the face-to-face neighbor walk (kernel B3,
  ``ops/walk_kernel.walk_rows``);
* ``_candidates_query`` — the per-bin candidate rows: one row per query
  answers "which cell contains r" and, for fused variables, the
  interpolated values (kernel B2 in bin order on the main table,
  ``ops/cand_kernel.py``); overflow bins probe their extension row, and
  bins whose candidates exceed even that resume with a walk;
* ``_candidates_query_df`` — accurate mode's cold query on the df-plane
  rows: the same probe, values in df32 (B2's df-plane branch);
* ``get_cell`` — the warm/cold dispatch (:412-434); its walks, from the
  start cells or seed bins to (ic, found), run in one launch of B3's
  ``ops/walk_kernel.get_cell_walk``.

Cells are 0-based; "no cell" is a negative index.  Status codes follow
the reference: 0 arrived, -1 left the domain, 1 icell-mask value changed
(:664-667), plus 2 for a walk stopped by the step cap.  Subsets of a
batch (stragglers, misses) are picked with ``torch.nonzero``; the JAX
package's top-k compaction was a TPU workaround.
"""

from __future__ import annotations

import math

import torch

from . import cand_kernel, walk_kernel
from ..models import cand_table
from ..utils import timing
from ..utils.config import huge_distance, tiny_distance

STATUS_ARRIVED = walk_kernel.STATUS_ARRIVED
STATUS_MASK_CHANGED = walk_kernel.STATUS_MASK_CHANGED
STATUS_BOUNDARY = walk_kernel.STATUS_BOUNDARY
STATUS_STEP_CAP = walk_kernel.STATUS_STEP_CAP


def _queries(grid, r):
    """Queries as a (B, 3) tensor on the grid's device, in its dtype."""
    r = torch.as_tensor(r, dtype=grid.dtype, device=grid.device)
    if r.ndim != 2 or r.shape[1] != 3:
        raise ValueError(f"queries must be (B, 3), got {tuple(r.shape)}")
    return r


def _cells(grid, ic):
    """Cell indices as an int32 tensor on the grid's device."""
    return torch.as_tensor(ic, device=grid.device).to(torch.int32)


def bin_seed(grid, r):
    """Cold-start seed cell for each query: one lookup in the per-bin
    nearest-cell table built with the grid.

    Args:
      r: (B, 3) query positions.
    Returns:
      (B,) int32 seed cell indices (always valid cells).
    """
    return grid.bin_table[walk_kernel.seed_bins(grid, _queries(grid, r))]


def kd_seed(grid, r):
    """Cold-start seed via the exact nearest cell center — the kd-tree
    backend (seed_mode="kdtree"), find_nearby_cell_kdtree (:272-288).

    Returns (B,) int32 seed cell indices."""
    from . import kdtree

    tree = kdtree.KdTree(grid.kd_node_points, grid.kd_node_ids,
                         grid.n_cells, grid.kd_max_depth)
    idx, _ = kdtree.nearest(tree, r)
    return idx


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


def locate_bruteforce(grid, r):
    """Exact containment over all cells (small meshes).

    Returns (i_cell, found): the most-interior containing cell per query
    (first-occurrence argmax of the margins), -1 where no cell contains
    the point.  Tiled so the (tile, C, nf) margins stay bounded."""
    r = _queries(grid, r)
    neg_eps = -grid.config.eps_inside
    tile = max(1024, (1 << 26) // max(grid.face_offsets.numel(), 1))
    ics, founds = [], []
    for lo in range(0, r.shape[0], tile):
        m = _containment_margins(grid, r[lo: lo + tile])
        best = torch.argmax(m, dim=1)
        found = m.gather(1, best[:, None])[:, 0] >= neg_eps
        ics.append(torch.where(found, best, -1).to(torch.int32))
        founds.append(found)
    if not ics:
        z = torch.zeros(0, dtype=torch.int32, device=grid.device)
        return z, z.bool()
    return torch.cat(ics), torch.cat(founds)


def point_is_inside_cell(grid, r, i_cell):
    """Batched inside test (iu_point_is_inside_cell, :766-786)."""
    r = _queries(grid, r)
    i_cell = _cells(grid, i_cell)
    ic = i_cell.clamp_min(0).long()
    n = grid.face_normals[ic]  # (B, nf, 3)
    rx, ry, rz = (r[:, d, None] for d in range(3))
    margin = (
        grid.face_offsets[ic]
        - ((n[..., 0] * rx + n[..., 1] * ry) + n[..., 2] * rz)
    ).amin(dim=1)
    return (margin >= -grid.config.eps_inside) & (i_cell >= 0)


def walk(grid, r0, r1, ic0, max_steps=None, i_icell_mask=None, table=None):
    """Batched neighbor walk from r0 (inside cell ic0) towards r1.

    The reference's iu_get_cell_through_neighbors +
    get_cell_intersection (:664-764): per step, the exit face is the
    least positive ray-plane distance over faces whose outward normal
    has a positive dot with the direction; the walk hops across it and
    stops per query on arrival, at the domain boundary or where the
    icell mask changes.  The rounds run in kernel B3
    (``ops/walk_kernel.walk_rows``).

    Args:
      r0, r1: (B, 3) start/end positions.
      ic0: (B,) int32 start cells (must contain r0 for exact parity).
      max_steps: step cap (the reference walks unbounded, :431); default
        ``config.max_walk_steps``.
      i_icell_mask: optional icell-data column; a hop into a cell whose
        value there differs from the start cell's stops on the face with
        ``STATUS_MASK_CHANGED`` (:712-719), in the cell entered.
      table: optional per-cell row table to walk instead of
        ``grid.walk_table``, with the same leading ``normals | offsets |
        neighbors`` columns (the tracer's ``build_trace_table`` rows).

    Returns:
      ic1: (B,) final cell (negative if walked out of the domain)
      r_p: (B, 3) final position — the last face intersection when the
        walk stopped early
      n_steps: (B,) int32 steps taken
      status: (B,) int32 status code
    """
    mask = None
    if i_icell_mask is not None:
        mask = grid.icell_data[:, i_icell_mask].to(torch.int32).contiguous()
    return walk_kernel.walk_rows(
        *_walk_args(grid, r0, r1, ic0, max_steps, table), mask
    )


def _walk_args(grid, r0, r1, ic0, max_steps=None, table=None):
    """The arguments of ``walk_kernel.walk_rows`` for a walk from r0 to
    r1 over ``table`` (default: the walk rows): starts, targets, start
    cells and the dtype-scaled tolerances, the grid's own
    (``Grid.walk_tol``; walks shorter than the dtype's tiny distance
    stay put)."""
    if max_steps is None:
        max_steps = grid.config.max_walk_steps
    if table is None:
        table = grid.walk_table
    r0 = _queries(grid, r0)
    r1 = _queries(grid, r1)
    dtype = torch.empty((), dtype=r0.dtype).numpy().dtype
    nudge, eps_arrive = grid.walk_tol
    return (table, r0, r1, _cells(grid, ic0), nudge, eps_arrive,
            huge_distance(dtype), tiny_distance(dtype), max_steps,
            grid.n_faces_per_cell)


def _candidates_query(grid, r, var_slots, max_steps=None, fill=None):
    """Cold containment and fused interpolation via per-bin candidate
    rows (the JAX package's ``_candidates_query``, ops/locate.py:769).

    One row per query carries the face planes (and fused values) of
    every cell intersecting the query's bin.  Where the bin's list is
    complete, a miss is exact: the point is outside the mesh.  Queries
    of overflow bins that no stored candidate contains probe the bin's
    extension row (candidates K..K+k_ext, same layout) in the same
    probe.  Bins whose count exceeds K + k_ext (or grids without
    extension rows) leave a residual: those misses (``aux >= 0``) walk
    from their best main candidate's center (kernel B3's get_cell walk)
    and interpolate in the cell they reach.  The rows are probed in bin
    order (``cand_kernel.cand_rows_binned_query``), so on a grid whose
    rows cover every bin nothing between the probe and the values reads
    back to the host.

    ``fill``: a scalar that the values take where not found, or None:
    there they are the best candidate's (or the walk's cell's).

    Returns (i_cell (B,) int32, found (B,) bool, values (B, V)).
    """
    if max_steps is None:
        max_steps = grid.config.max_walk_steps
    var_slots = tuple(var_slots)
    k_max = grid.cand_ids.shape[1]
    ext = None
    if grid.cand_ext_table is not None:
        ext = (grid.cand_ext_table, cand_table.layout(
            grid, grid.cand_ext_ids.shape[1], var_slots))
    args = (grid.cand_table, r, grid.cand_rmin, grid.cand_inv_h,
            grid.cand_shape, cand_table.layout(grid, k_max, var_slots),
            cand_table.probe_eps(grid), k_max, cand_table.probe_chunk(grid),
            ext)
    if grid.cand_ext_covers and fill is not None:
        # every bin's complete list fits its row or its extension row: a
        # miss is exact, and the probe's unsort writes the outputs
        return cand_kernel.cand_rows_found_query(*args, fill)
    id_best, aux, values = cand_kernel.cand_rows_binned_query(*args)
    found = aux == -2
    ic = torch.where(found, id_best, -1)
    if grid.cand_ext_covers:
        return ic, found, values
    with timing.span("iu.locate.miss_walk", grid.device):
        # aux >= 0: a bin beyond K (no extension rows) or K + k_ext
        # candidates
        with timing.host_read("cand_residual", aux):
            sel = torch.nonzero(aux >= 0).squeeze(1)
        if sel.numel() == 0:
            return ic, found, values
        ic_w, found_w = walk_kernel.get_cell_walk(
            grid, r[sel], id_best[sel].clamp_min(0), max_steps, 0)
        ic[sel] = torch.where(found_w, ic_w, -1)
        if var_slots:
            from .interp import interpolate_at_icell

            vals_w = interpolate_at_icell(grid, r[sel], var_slots,
                                          ic_w.clamp_min(0))
            values[sel] = torch.where(found_w[:, None], vals_w, values[sel])
    found = ic >= 0
    if fill is not None:
        values = torch.where(found[:, None], values, float(fill))
    return ic, found, values


def _candidates_query_df(grid, r, var_slots, r_lo=None):
    """Accurate-mode fused cold query: one row of the df-plane candidate
    table (``grid.cand_df_table``) per query answers containment AND the
    ~1e-13 interpolation (kernel B2's df-plane branch, in bin order).

    ``r``: (B, 3) float64 queries, or float32 ones with their lo parts
    ``r_lo`` (None: zeros), on the grid's device; on the card the kernels
    split them and form the hi/lo local frame themselves.

    Only built for simplex grids whose rows cover every bin
    (``models.cand_table.df_supported``), so a probe miss is exact.

    Returns (ic (B,) int32, found (B,), vals_hi (B, V), vals_lo (B, V));
    missed queries carry their best candidate's plane values with found
    False.
    """
    lay = cand_table.df_layout(grid, tuple(var_slots))
    id_best, aux, vh, vl = cand_kernel.cand_rows_df_query(
        grid.cand_df_table, r, r_lo, grid.cand_rmin, grid.cand_inv_h,
        grid.cand_shape, lay, cand_table.probe_eps(grid), lay.k,
        cand_table.probe_chunk(grid, grid.cand_df_table),
    )
    found = aux == -2
    return torch.where(found, id_best, -1), found, vh, vl


def locate_candidates(grid, r, max_steps=None):
    """Cold containment via per-bin candidate rows (see
    _candidates_query).  Returns (i_cell, found) with get_cell's
    contract."""
    ic, found, _ = _candidates_query(grid, _queries(grid, r), (), max_steps,
                                     math.nan)
    return ic, found


def _get_cell_warm(grid, r, guess, max_steps):
    """Warm-start location on candidate-table grids.

    Every query takes the one-row candidate probe; the guess buys
    reference parity where it matters: candidate MISSES with a guess
    replay the reference walk from the guess cell
    (iu_get_cell_through_neighbors, :664-725), so off-domain queries
    report the boundary code of the face that walk exits through
    (:712-719) instead of a bare "not found".
    """
    # Out-of-range guesses fall back to a cold start (the reference
    # error-stops on guess > n_cells, :490)
    guess = torch.where(guess >= grid.n_cells, -1, guess)
    ic, found, _ = _candidates_query(grid, r, (), max_steps, math.nan)
    with timing.span("iu.locate.miss_walk", grid.device):
        with timing.host_read("warm_miss", found):
            sel = torch.nonzero(~found & (guess >= 0)).squeeze(1)
        if sel.numel():
            ic[sel], found[sel] = walk_kernel.get_cell_walk(
                grid, r[sel], guess[sel], max_steps, 0)
    return ic, found


@timing.spanned("iu.locate", timed=True)
def get_cell(grid, r, guess=None, max_steps=None):
    """Find the cell containing each query point (iu_get_cell, :412-434).

    Warm start: where ``guess >= 0`` the walk starts from the guess
    cell's center; otherwise from the cold-start seed.  In
    ``bruteforce`` mode the guess is irrelevant — containment is
    computed exactly in one shot.  Grids with candidate tables answer
    cold queries from the rows, and warm ones too, walking from the
    guess only where the rows miss.

    Batches of at least ``config.walk_compact_min_batch`` queries walk
    in two phases: ``config.walk_phase1_steps`` steps on the full batch,
    then the stragglers resume from where they stopped (which restarts
    their direction and distance from there, as in the JAX package).
    Both phases run in one launch of ``walk_kernel.get_cell_walk``.

    While tracing (``utils/timing.py``) the call is span ``iu.locate``.

    Returns (i_cell, found): i_cell is -1 (or the off-domain neighbor
    code) where the point is in no cell.
    """
    r = _queries(grid, r)
    if grid.locate_mode == "bruteforce":
        return locate_bruteforce(grid, r)

    cfg = grid.config
    if max_steps is None:
        max_steps = cfg.max_walk_steps
    if guess is not None:
        guess = _cells(grid, guess)

    if guess is None and grid.cand_table is not None:
        # Pure cold batch: one-row candidate containment
        return locate_candidates(grid, r, max_steps=max_steps)

    if guess is not None and grid.cand_table is not None:
        return _get_cell_warm(grid, r, guess, max_steps)

    use_kd = cfg.seed_mode == "kdtree" and grid.kd_node_points is not None
    if use_kd:
        # Out-of-range guesses fall back to a cold start (the reference
        # error-stops on guess > n_cells, :490)
        start = kd_seed(grid, r)
        if guess is not None:
            ok = (guess >= 0) & (guess < grid.n_cells)
            start = torch.where(ok, guess, start)
    elif guess is not None:
        start = guess  # out-of-range guesses reseed from the bin table
    elif grid.bin_pack is None:
        start = bin_seed(grid, r)
    else:
        start = None  # pure cold start: id + origin from one packed row

    p1 = min(cfg.walk_phase1_steps, max_steps)
    if r.shape[0] < cfg.walk_compact_min_batch or max_steps <= p1:
        p1 = 0
    return walk_kernel.get_cell_walk(grid, r, start, max_steps, p1)
