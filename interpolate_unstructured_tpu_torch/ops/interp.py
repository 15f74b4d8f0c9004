"""Batched interpolation weights and the public query API (torch).

The port of the JAX package's ``ops/interp.py`` for the cold path:
barycentric triangle, scalar-triple tetrahedron and inverse-bilinear
quad weights (m_interp_unstructured.f90:529-641, math in
``ops/wkern.py``), and ``interpolate_at`` / ``interpolate_scalar_at``,
which send a call down one of two routes:

* brute-force grids -> kernel B1 (``ops/interp_kernel.py``);
* walk grids with candidate tables and fused variables -> the
  candidate-row probe, kernel B2 (``ops/locate._candidates_query``).

Values are (B, V), as at the public API of the JAX package; the (V, B)
layout its internals used for the TPU is not carried over.  Every
query returns a ``found`` mask, and values carry ``fill_value`` where
nothing contains the query.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import wkern


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


def _static_slots(i_vars):
    """Variable indices as a tuple of ints."""
    if isinstance(i_vars, torch.Tensor):
        return tuple(int(v) for v in i_vars.reshape(-1).tolist())
    return tuple(int(v) for v in np.asarray(i_vars).reshape(-1))


def _fill(values, found, fill_value):
    """Values where found, else ``fill_value`` (a scalar, or anything
    that broadcasts to (B, V), such as the previous values)."""
    fill = torch.as_tensor(fill_value, dtype=values.dtype,
                           device=values.device)
    return torch.where(found[:, None], values, fill.broadcast_to(values.shape))


def interpolate_at(grid, r, i_vars, guess=None, fill_value=math.nan):
    """Locate + interpolate (iu_interpolate_at, :480-495), batched.

    The route is the JAX package's ``_interpolate_at_T``
    (ops/interp.py:254-314): brute force, or the candidate rows when
    every requested variable is fused into them.

    Args:
      r: (B, 3) positions (tensor or array; moved to the grid's device
        and dtype).
      i_vars: (V,) point-data variable indices.
      guess: optional (B,) warm-start cells; only brute-force grids
        take one so far (and ignore it).
      fill_value: value for queries outside the mesh: a scalar, or an
        array that broadcasts to (B, V).
    Returns:
      values: (B, V)
      i_cell: (B,) int32 containing cell, -1 if not found
      found: (B,) bool
    """
    from . import interp_kernel, locate
    from ..models.grid import cand_fused_nv

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
        and slots
        and all(0 <= s < cand_fused_nv(grid) for s in slots)
    ):
        i_cell, found, values = locate._candidates_query(grid, r, slots)
        return _fill(values, found, fill_value), i_cell, found

    raise NotImplementedError(
        "this walk-grid query needs get_cell + interpolate_at_icell "
        "(a warm guess, an unfused variable, or a grid without candidate "
        "tables); they come with the warm-path slice of the port"
    )


def interpolate_scalar_at(grid, r, i_var, guess=None, fill_value=math.nan):
    """Single-variable wrapper (iu_interpolate_scalar_at, :464-477).

    ``fill_value`` is a scalar or a (B,) array.  Returns (values (B,),
    i_cell (B,), found (B,))."""
    fv = fill_value
    if np.ndim(fv) != 0:
        fv = torch.as_tensor(fv)[:, None]
    vals, i_cell, found = interpolate_at(grid, r, [i_var], guess, fv)
    return vals[:, 0], i_cell, found
