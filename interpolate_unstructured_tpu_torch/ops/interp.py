"""Batched interpolation weights and the public query API (torch).

The port of the JAX package's ``ops/interp.py``: barycentric
triangle, scalar-triple tetrahedron and inverse-bilinear quad weights
(m_interp_unstructured.f90:529-641, math in ``ops/wkern.py``),
``interpolate_at_icell`` and the cell-data lookups, and
``interpolate_at`` / ``interpolate_scalar_at``, which send a call down
one of three routes:

* brute-force grids -> kernel B1 (``ops/interp_kernel.py``);
* cold calls on walk grids with candidate tables, every variable fused
  -> the candidate-row probe, kernel B2 (``ops/locate._candidates_query``);
* everything else (a warm guess, an unfused variable, a grid without
  candidate tables) -> ``ops/locate.get_cell`` (walks run kernel B3),
  then ``interpolate_at_icell`` (kernel E1, ``ops/icell_kernel.py``);
  on the card a large batch on a grid without candidate tables takes
  both in bin order (``ops/order_kernel.py``) and comes back in query
  order, bit for bit the same.

Values are (B, V), as at the public API of the JAX package; the (V, B)
layout its internals used for the TPU is not carried over.  Every
query returns a ``found`` mask, and values carry ``fill_value`` where
nothing contains the query.

While tracing (``utils/timing.py``) ``interpolate_at`` is the entry span
``iu.interpolate_at``; the location inside it is ``iu.locate``,
``interpolate_at_icell`` is ``iu.icell`` and the fill ``iu.fill``; the
bin order is ``iu.order`` (before the location) and ``iu.unorder``
(after the interpolation), and counts ``order.calls`` and
``order.queries``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import wkern
from ..models import cand_table
from ..utils import timing


def _vq_components(cell_points, r, npc):
    """(B, npc, 3) vertices + (B, 3) query -> per-component lists for
    the shared weight kernels (ops/wkern.py)."""
    v = [[cell_points[:, k, d] for d in range(3)] for k in range(npc)]
    q = [r[:, d] for d in range(3)]
    return v, q


def triangle_weights(cell_points, area, r):
    """(B,3,3) vertices, (B,) area, (B,3) query -> (B,3) weights.

    Opposite sub-triangle areas over the cell area (:529-551),
    normalized by one reciprocal and a multiply per weight — the form
    of the brute-force kernel (pallas_interp.py:53-63 in the JAX
    package, csrc/interp_bruteforce.cu here)."""
    v, q = _vq_components(cell_points, r, 3)
    a2 = wkern.triangle_areas2(v, q, wkern.Plain(r.dtype))
    inv = 0.5 / area
    return torch.stack([a * inv for a in a2], dim=1)


def tetra_weights(cell_points, volume, r):
    """(B,4,3) vertices, (B,) signed volume, (B,3) query -> (B,4)
    weights: signed triple products times 1 / (6 * volume) (:553-586)."""
    v, q = _vq_components(cell_points, r, 4)
    w = wkern.tetra_triples(v, q, wkern.Plain(r.dtype))
    inv = 1.0 / (6.0 * volume)
    return torch.stack([t * inv for t in w], dim=1)


def quad_weights(cell_points, r):
    """(B,4,3) vertices, (B,3) query -> (B,4) inverse-bilinear weights
    (:588-641); the quad is assumed planar, parallel to z."""
    v, q = _vq_components(cell_points, r, 4)
    w = wkern.quad_weights_generic(v, q, wkern.Plain(r.dtype))
    return torch.stack(w, dim=1)


def _weights_from_geometry(cell_type, cp, vol, r):
    """Weight-kernel dispatch on pre-gathered per-query geometry."""
    if cell_type == "triangle":
        return triangle_weights(cp, vol, r)
    if cell_type == "quad":
        return quad_weights(cp, r)
    if cell_type == "tetra":
        return tetra_weights(cp, vol, r)
    raise ValueError(f"Unsupported cell type {cell_type!r}")


def cell_weights(grid, r, i_cell):
    """Interpolation weights of each query in its (assumed) cell.

    Returns (B, npc) weights; dispatch on the grid's cell type
    (iu_interpolate_at_icell, :497-527)."""
    ic = torch.as_tensor(i_cell, device=grid.device).long().clamp_min(0)
    r = torch.as_tensor(r, dtype=grid.dtype, device=grid.device)
    return _weights_from_geometry(
        grid.cell_type, grid.cell_points[ic], grid.cell_volume[ic], r
    )


@timing.spanned("iu.icell", timed=True)
def interpolate_at_icell(grid, r, i_vars, i_cell):
    """Interpolate point-data variables inside known cells (:497-527).

    A CUDA grid runs kernel E1 (``ops/icell_kernel.py``), a CPU grid the
    plain version, :func:`interpolate_at_icell_plain`; the two give the
    same values.  A CUDA grid whose kernel cannot build or launch raises.

    Args:
      r: (B, 3) positions (moved to the grid's device and dtype).
      i_vars: (V,) point-data variable indices.
      i_cell: (B,) containing cell per position (not validated; a
        negative one reads cell 0; on a CUDA grid one of ``n_cells`` or
        more reads the last cell, where the plain version raises).
    Returns:
      (B, V) interpolated values.
    """
    r = torch.as_tensor(r, dtype=grid.dtype, device=grid.device)
    if grid.device.type == "cuda":
        from . import icell_kernel

        return icell_kernel.interpolate_at_icell_cuda(
            grid, r, _static_slots(i_vars), i_cell)
    if grid.device.type == "cpu":
        return interpolate_at_icell_plain(grid, r, i_vars, i_cell)
    raise ValueError(f"no known-cell interpolation for device {grid.device}")


def interpolate_at_icell_plain(grid, r, i_vars, i_cell):
    """Plain PyTorch version of :func:`interpolate_at_icell` (and of
    kernel E1), on any device.

    Two gather routes, as in the JAX package: a batch of at least a
    quarter as many queries as cells assembles a per-call row table
    (vertex coords | volume | vertex data) and reads one row per query;
    a smaller one reads the geometry from the walk rows (on a grid
    without them, from ``cell_points`` and ``cell_volume``) and the
    vertex data through the connectivity.  All give the same values.  No
    variables give (B, 0) (the JAX package's row-table route raises
    there: it cannot reshape zero data columns).
    """
    r = torch.as_tensor(r, dtype=grid.dtype, device=grid.device)
    i_vars = torch.as_tensor(_static_slots(i_vars), dtype=torch.long,
                             device=grid.device)
    ic = torch.as_tensor(i_cell, device=grid.device).long().clamp_min(0)
    b = r.shape[0]
    n_cells = grid.n_cells
    npc = grid.n_points_per_cell
    nf = grid.n_faces_per_cell
    v = i_vars.shape[0]
    pd_sel = grid.point_data[:, i_vars]  # (P, V)
    if v == 0:
        return r.new_zeros((b, 0))

    k_cols = npc * 3 + 1 + npc * v
    if b * 4 >= n_cells and k_cols <= 512 // grid.dtype.itemsize:
        ftab = torch.cat(
            [
                grid.cell_points.reshape(n_cells, npc * 3),
                grid.cell_volume[:, None],
                pd_sel[grid.cells.long()].reshape(n_cells, npc * v),
            ],
            dim=1,
        )
        g = ftab[ic]
        cp = g[:, : npc * 3].reshape(-1, npc, 3)
        w = _weights_from_geometry(grid.cell_type, cp, g[:, npc * 3], r)
        vertex_vals = g[:, npc * 3 + 1:].reshape(-1, npc, v)
    else:
        if grid.walk_table is not None:
            g = grid.walk_table[ic, nf * 5: nf * 5 + npc * 3 + 1]
            cp = g[:, : npc * 3].reshape(-1, npc, 3)
            w = _weights_from_geometry(grid.cell_type, cp, g[:, npc * 3], r)
        else:
            w = cell_weights(grid, r, ic)
        vertex_vals = pd_sel[grid.cells[ic].long()]  # (B, npc, V)
    acc = w[:, 0, None] * vertex_vals[:, 0]
    for k in range(1, npc):
        acc = acc + w[:, k, None] * vertex_vals[:, k]
    return acc


def _static_slots(i_vars):
    """Variable indices as a tuple of ints."""
    if isinstance(i_vars, torch.Tensor):
        with timing.host_read("static_slots", i_vars):
            return tuple(int(v) for v in i_vars.reshape(-1).tolist())
    return tuple(int(v) for v in np.asarray(i_vars).reshape(-1))


@timing.spanned("iu.fill")
def _fill(values, found, fill_value):
    """Values where found, else ``fill_value`` (a scalar, or anything
    that broadcasts to (B, V), such as the previous values).  A Python
    scalar goes to ``torch.where`` as it is, with no tensor made of it
    (on the card that would be a host-to-device copy per call)."""
    if isinstance(fill_value, (int, float)):
        return torch.where(found[:, None], values, float(fill_value))
    fill = torch.as_tensor(fill_value, dtype=values.dtype,
                           device=values.device)
    return torch.where(found[:, None], values, fill.broadcast_to(values.shape))


def _takes_bin_order(grid, n_queries):
    """Whether ``interpolate_at``'s get_cell and interpolate_at_icell
    take a batch of ``n_queries`` in bin order: on the card, on a walk
    grid without candidate tables, for a batch that
    ``order_kernel.engages``."""
    from . import order_kernel

    return (grid.device.type == "cuda" and grid.locate_mode == "walk"
            and grid.cand_table is None and grid.bin_rmin is not None
            and grid.walk_table is not None
            and order_kernel.engages(n_queries, grid.n_cells,
                                     grid.walk_table.nbytes,
                                     order_kernel.l2_bytes(grid.device),
                                     grid.cell_type))


def _in_bin_order(grid, r, slots, guess):
    """``get_cell`` then ``interpolate_at_icell`` of the (B, 3) queries
    ``r`` in bin order (``ops/order_kernel.py``).  Returns
    (i_cell, found, values) in query order, as the two calls give them
    on ``r``."""
    from . import locate, order_kernel

    if timing.tracing():
        timing.metrics.count("order.calls", 1)
        timing.metrics.count("order.queries", r.shape[0])
    with timing.span("iu.order", grid.device):
        start = None if guess is None else locate._cells(grid, guess)
        r_o, start_o, back = order_kernel.order(grid, r, start)
    i_cell, found = locate.get_cell(grid, r_o, start_o)
    values = interpolate_at_icell(grid, r_o, slots, i_cell)
    with timing.span("iu.unorder", grid.device):
        return order_kernel.unsort(back, i_cell, found, values)


@timing.spanned("iu.interpolate_at", entry=True)
def interpolate_at(grid, r, i_vars, guess=None, fill_value=math.nan):
    """Locate + interpolate (iu_interpolate_at, :480-495), batched.

    The route is the JAX package's ``_interpolate_at_T``
    (ops/interp.py:254-314): brute force; the candidate rows for a cold
    call whose variables are all fused into them; else ``get_cell``
    then ``interpolate_at_icell``, in bin order where
    :func:`_takes_bin_order`.

    Args:
      r: (B, 3) positions (tensor or array; moved to the grid's device
        and dtype).
      i_vars: (V,) point-data variable indices.
      guess: optional (B,) warm-start cells (negative = cold).
      fill_value: value for queries outside the mesh: a scalar, or an
        array that broadcasts to (B, V).
    Returns:
      values: (B, V)
      i_cell: (B,) int32 containing cell, -1 if not found
      found: (B,) bool
    """
    from . import interp_kernel, locate

    r = torch.as_tensor(r, dtype=grid.dtype, device=grid.device)
    if r.ndim != 2 or r.shape[1] != 3:
        raise ValueError(f"queries must be (B, 3), got {tuple(r.shape)}")
    slots = _static_slots(i_vars)

    if grid.locate_mode == "bruteforce":
        # containment is exact in one shot: the guess is irrelevant
        values, i_cell, found = interp_kernel.interpolate_bruteforce(
            grid, r, list(slots)
        )
        return _fill(values, found, fill_value), i_cell, found

    if (
        guess is None
        and grid.cand_table is not None
        and cand_table.fuses(grid, slots)
    ):
        # a scalar fill the probe writes itself
        scalar = isinstance(fill_value, (int, float))
        with timing.span("iu.locate", grid.device, timed=True):
            i_cell, found, values = locate._candidates_query(
                grid, r, slots, fill=fill_value if scalar else None)
        if scalar:
            return values, i_cell, found
        return _fill(values, found, fill_value), i_cell, found

    if _takes_bin_order(grid, r.shape[0]):
        i_cell, found, values = _in_bin_order(grid, r, slots, guess)
    else:
        i_cell, found = locate.get_cell(grid, r, guess)
        values = interpolate_at_icell(grid, r, slots, i_cell)
    return _fill(values, found, fill_value), i_cell, found


def interpolate_scalar_at(grid, r, i_var, guess=None, fill_value=math.nan):
    """Single-variable wrapper (iu_interpolate_scalar_at, :464-477).

    ``fill_value`` is a scalar or a (B,) array.  Returns (values (B,),
    i_cell (B,), found (B,))."""
    fv = fill_value
    if np.ndim(fv) != 0:
        fv = torch.as_tensor(fv)[:, None]
    vals, i_cell, found = interpolate_at(grid, r, [i_var], guess, fv)
    return vals[:, 0], i_cell, found


def _fill_1d(vals, found, fill_value):
    fill = torch.as_tensor(fill_value, dtype=vals.dtype, device=vals.device)
    return torch.where(found, vals, fill.broadcast_to(vals.shape))


def get_cell_scalar_at(grid, r, i_var, guess=None, fill_value=math.nan):
    """Piecewise-constant cell-data lookup (iu_get_cell_scalar_at,
    :436-448): locate, then read cell_data directly — no interpolation.
    Returns (values (B,), i_cell (B,), found (B,))."""
    from . import locate

    i_cell, found = locate.get_cell(grid, r, guess)
    vals = grid.cell_data[i_cell.clamp_min(0).long(), i_var]
    return _fill_1d(vals, found, fill_value), i_cell, found


def get_icell_scalar_at(grid, r, i_var, guess=None, fill_value=-1):
    """Integer cell-data lookup (iu_get_icell_scalar_at, :450-462).
    Returns (values (B,) int32, i_cell (B,), found (B,))."""
    from . import locate

    i_cell, found = locate.get_cell(grid, r, guess)
    vals = grid.icell_data[i_cell.clamp_min(0).long(), i_var]
    return _fill_1d(vals, found, fill_value), i_cell, found
