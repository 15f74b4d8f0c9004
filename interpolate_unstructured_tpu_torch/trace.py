"""Field-line tracing: adaptive Bogacki–Shampine RK23 along an
interpolated vector field (torch).

The port of the JAX package's ``trace.py``, itself a batched re-design
of ``iu_integrate_along_field`` (m_interp_unstructured.f90:987-1217): one
host loop over RK iterations advances every trajectory of the batch,
with explicit active-lane masks and fixed-shape output buffers.
Control-flow parity with the reference:

* integrates along the *unit vector* of the interpolated field
  (arc-length parameterization, get_unitvec :1193-1201, optional
  ``reverse``), plus ``nvar`` user ODE variables through a per-point
  callback batched with ``torch.func.vmap`` (integrate_sub_t, :61-74);
* embedded 2nd-order error estimate with
  ``scales = atol + max(|y3|,|y2|)*rtol`` and
  ``err = sqrt(sum(((y3-y2)/scales)^2)/3)`` (:1162-1163); accept when
  ``err <= 1`` or ``dx < 2*min_dx`` (:1165);
* step-size update ``dx*min(max_growth, 0.8*err**(-1/3))`` clamped to
  ``[min_dx, max_dx]``, growth capped at 1x right after a rejection
  else 2x (:1178-1188);
* boundary handling: when a sub-step's neighbor walk stops early, shrink
  ``dx`` to the distance to the intersection (:1084) and retry;
  terminate when ``dx < min_dx``, reporting ``boundary_material`` (-1
  physical boundary, else the mask value of the cell entered,
  :1086-1096);
* optional ``axisymmetric`` clamps the first coordinate >= 1e-12
  (:1120/:1133/:1147/:1171); an optional icell mask restricts
  integration to a region (:1055-1068).

Stages 2-4 of an iteration take one of two paths.  The fused path
(float32, no mask, ``nvar == 0``) runs them in kernel B4
(``ops/trace_kernel.py``): each lane walks, interpolates on arrival from
the trace table and advances its own stage machine.  The generic path
walks each stage with kernel B3 on the trace table
(``ops/locate.walk(..., table=)``) and interpolates in torch.  A lane
whose earlier sub-step failed (or that is done) aims its later walks at
their own start, which makes them no-ops, so one pass through the body
computes what the reference's goto-laden loop does.  Vectors are (B, D)
inside; the JAX package's (D, B) row layout was a TPU layout.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .ops import interp, locate, trace_kernel
from .utils.config import huge_distance, tiny_distance, walk_tolerances

SAFETY_FAC = 0.8
MIN_RADIUS = 1e-12
# boundary_material sentinel: trace still running / buffer exhausted
BM_NOT_REACHED = -2
# A sub-step walk hit config.trace_walk_max_steps even at dx ~ min_dx:
# a min_dx segment crosses more cells than the cap allows.  The reference
# walks unbounded (:431), so it has no analog; reporting a boundary (-1)
# would be wrong mid-domain.  Raise trace_walk_max_steps or min_dx.
BM_STEP_CAP = -3


def _shrink_eps(dtype):
    """Boundary shrink factor: dx -> (1-eps)*|r_p - r0| (:1084).

    The reference's 1e-8 assumes float64; in float32, (1 - 1e-8) == 1
    exactly, so dx would never decrease and the shrink-and-retry loop
    would livelock at domain boundaries.  Use ~sqrt(machine eps)."""
    if np.dtype(dtype) == np.float32:
        return 3e-4
    return 1e-8


class TraceResult(NamedTuple):
    """Batched trace output (shapes lead with the trajectory batch B)."""

    y: Any  # (B, max_steps, ndim+nvar) solution curve; [i, 0] = y0
    y_field: Any  # (B, max_steps, ndim) field samples along the curve
    n_steps: Any  # (B,) int32: valid points; max_steps+1 = not reached
    boundary_material: Any  # (B,) int32: -1 physical boundary, mask value,
    #                         BM_NOT_REACHED if the buffer filled first,
    #                         or BM_STEP_CAP (walk cap at min_dx)
    n_iterations: Any  # (B,) int32: RK iterations spent (diagnostics)
    n_rounds: Any = None  # () int32: B4 rounds, summed over iterations of
    #                       the largest lane count (0 on the generic path)


def build_trace_table(grid, i_field):
    """Per-cell row table of the tracer: the walk-row layout (face
    normals | offsets | neighbor ids) extended with the cell vertices,
    the volume and the traced field's vertex values, zero-padded to a
    multiple of 16 columns, at least 64 — the JAX package's layout, so
    both packages build equal tables for one grid.

    One row then serves a walk round and the whole interpolation at the
    cell reached.  Build it once and pass it as ``trace_table=`` to
    repeated traces over the same field; ``i_field`` must be the order
    later passed to :func:`integrate_along_field`."""
    slots = list(interp._static_slots(i_field))
    n_cells = grid.n_cells
    nf = grid.n_faces_per_cell
    npc = grid.n_points_per_cell
    pd = grid.point_data[:, slots]  # (P, ndim)
    cols = torch.cat(
        [
            grid.face_normals.reshape(n_cells, nf * 3),
            grid.face_offsets,
            grid.neighbors.to(grid.dtype),
            grid.cell_points.reshape(n_cells, npc * 3),
            grid.cell_volume[:, None],
            pd[grid.cells.long()].reshape(n_cells, npc * len(slots)),
        ],
        dim=1,
    )
    row_width = max(64, -(-cols.shape[1] // 16) * 16)
    return torch.nn.functional.pad(
        cols, (0, row_width - cols.shape[1])).contiguous()


def integrate_along_field(
    grid,
    y0,
    i_field,
    *,
    nvar: int = 0,
    sub_int=None,
    min_dx: float,
    max_dx: float,
    max_steps: int,
    rtol: float,
    atol: float,
    reverse: bool = False,
    axisymmetric: bool = False,
    i_icell_mask: int | None = None,
    mask_value: int | None = None,
    max_iterations: int | None = None,
    trace_table=None,
) -> TraceResult:
    """Trace field lines from a batch of seed states, on the grid's device.

    Args:
      grid: Grid with the field stored as point data.
      y0: (B, ndim+nvar) initial positions + extra variable values.
      i_field: sequence of ndim point-data indices of the field
        components to trace.
      nvar: number of extra ODE variables (trailing entries of y0).
      sub_int: callback ``(field (ndim,), y (ndim+nvar,)) -> (nvar,)``
        giving the arc-length derivatives of the extra variables
        (integrate_sub_t, :61-74), batched with ``torch.func.vmap``.
      min_dx/max_dx/max_steps/rtol/atol/reverse/axisymmetric: see the
        module docstring.
      i_icell_mask/mask_value: integrate only where
        ``icell_data[:, i_icell_mask] == mask_value`` (:1055-1068).
      max_iterations: cap on RK iterations (the reference loops
        unbounded, :1078); defaults to ``50 * max_steps + 1000``.
      trace_table: optional prebuilt :func:`build_trace_table` result
        for this (grid, i_field); built per call when None.

    Returns:
      TraceResult with per-trajectory curves, field samples, step
      counts, and boundary codes.
    """
    if max_dx < min_dx:
        raise ValueError("max_dx < min_dx")
    if max_steps < 1:
        raise ValueError("max_steps < 1")
    if (i_icell_mask is None) != (mask_value is None):
        raise ValueError("i_icell_mask and mask_value must be given together")
    i_field = interp._static_slots(i_field)
    ndim = len(i_field)
    if ndim != grid.ndim:
        raise ValueError(f"i_field has {ndim} entries, grid is {grid.ndim}D")
    if max_iterations is None:
        max_iterations = 50 * max_steps + 1000
    dtype, dev = grid.dtype, grid.device
    if dev.type == "cuda" and dtype != torch.float32:
        raise TypeError(
            f"the tracer's CUDA kernels take float32 grids, got {dtype}")
    y0 = torch.as_tensor(y0).to(dtype=dtype, device=dev)
    if y0.ndim != 2 or y0.shape[1] != ndim + nvar:
        raise ValueError(f"y0 must have shape (B, {ndim + nvar})")
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    shrink_eps = _shrink_eps(np_dtype)
    tiny = tiny_distance(np_dtype)
    b = y0.shape[0]
    i32 = torch.int32

    if trace_table is None:
        trace_table = build_trace_table(grid, i_field)
    use_fused = trace_kernel.supported(grid, i_icell_mask, nvar)
    sub_int_b = torch.func.vmap(sub_int) if nvar else None
    walk_cap = grid.config.trace_walk_max_steps

    def pad3(r):
        """(B, ndim) -> (B, 3) with zero-filled unused coordinates."""
        return torch.nn.functional.pad(r, (0, 3 - ndim))

    def clamp_axi(r):
        if axisymmetric:
            return torch.cat([r[:, :1].clamp_min(MIN_RADIUS), r[:, 1:]], 1)
        return r

    def derivs(field, y):
        """(B, D) derivatives: the unit field vector, guarded by ``tiny``
        (a zero field steps in place and ends as BM_NOT_REACHED; the
        reference divides by zero, :1199), then the extra variables'."""
        norm = trace_kernel.norm3(field)
        u = field[:, :ndim] / norm.clamp_min(tiny)[:, None]
        if reverse:
            u = -u
        if not nvar:
            return u
        return torch.cat([u, sub_int_b(field[:, :ndim], y)], dim=1)

    def boundary_code(ic):
        """-1 for a physical boundary, else the mask value of the cell
        that ended the trace (:1086-1096)."""
        if i_icell_mask is None:
            return torch.full_like(ic, -1)
        masked = grid.icell_data[ic.clamp_min(0).long(), i_icell_mask]
        return torch.where(ic < 0, -1, masked.to(i32))

    def rk_stage(anchor, k_prev, coeff, r_start, ic_start, ok):
        """One batched walk + interpolate sub-step (generic path).  Lanes
        with ``ok`` False aim at their own start, a no-op walk.  The walk
        starts from the previous sub-step's end point and cell, as the
        reference threads i_cell between sub-steps (:1122-1150).

        Returns (ys (B, D), field (B, 3), k (B, D), ic, r_p (B, 3),
        tgt (B, 3), failed, capped): ``capped`` flags failures that are
        walk step-cap artifacts, not boundary or mask stops."""
        ys = anchor + coeff[:, None] * k_prev
        tgt = torch.where(ok[:, None], clamp_axi(pad3(ys[:, :ndim])), r_start)
        ic, r_p, _, st = locate.walk(
            grid, r_start, tgt, ic_start, max_steps=walk_cap,
            i_icell_mask=i_icell_mask, table=trace_table,
        )
        failed = ok & (st != locate.STATUS_ARRIVED)
        capped = ok & (st == locate.STATUS_STEP_CAP)
        field = trace_kernel.field_at_rows(
            trace_table[ic.clamp_min(0).long()], grid.cell_type, ndim, tgt)
        return ys, field, derivs(field, ys), ic, r_p, tgt, failed, capped

    if use_fused:
        nudge, eps_arrive = walk_tolerances(np_dtype, grid.rmin, grid.rmax)
        fused_kw = dict(
            cell_type=grid.cell_type, ndim=ndim, nudge=nudge,
            eps_arrive=eps_arrive, tiny=tiny, big=huge_distance(np_dtype),
            reverse=reverse, axisymmetric=axisymmetric, max_steps=walk_cap,
            min_radius=MIN_RADIUS,
        )

    # ---- initialization (:1045-1073) ----
    r0_3 = pad3(y0[:, :ndim])
    ic0, found0 = locate.get_cell(grid, r0_3)
    ic0 = torch.where(found0, ic0, -1).to(i32)
    field0 = interp.interpolate_at_icell(grid, r0_3, i_field,
                                         ic0.clamp_min(0))
    in_region = found0
    if mask_value is not None:
        in_region = found0 & (
            grid.icell_data[ic0.clamp_min(0).long(), i_icell_mask]
            == mask_value
        )
    done = ~in_region
    bm = torch.where(done, boundary_code(ic0), BM_NOT_REACHED).to(i32)
    field0 = torch.where(in_region[:, None], field0, 0.0)

    # One scratch row past max_steps takes the writes of lanes that do
    # not store a point
    y_buf = torch.zeros((b, max_steps + 1, ndim + nvar), dtype=dtype,
                        device=dev)
    y_buf[:, 0] = y0
    yf_buf = torch.zeros((b, max_steps + 1, ndim), dtype=dtype, device=dev)
    yf_buf[:, 0] = field0
    rows = torch.arange(b, device=dev)

    anchor = y0  # (B, D) current accepted state
    field_a = pad3(field0)  # (B, 3) field at the anchor
    n_idx = torch.zeros(b, dtype=i32, device=dev)
    i_cell_prev = ic0
    dx = torch.full((b,), max_dx, dtype=dtype, device=dev)
    last_rejected = torch.full((b,), -100, dtype=i32, device=dev)
    iteration = torch.zeros(b, dtype=i32, device=dev)
    overflow = torch.zeros(b, dtype=torch.bool, device=dev)
    n_rounds = torch.zeros((), dtype=i32, device=dev)

    it = 0
    while it < max_iterations and bool((~done).any()):
        act = ~done
        r0 = pad3(anchor[:, :ndim])
        # k1 reuses the stored field sample (:1109-1115)
        k1 = derivs(field_a, anchor)

        if use_fused:
            st = trace_kernel.trace_stages(
                trace_table, r0, pad3(k1), dx, i_cell_prev, act, **fused_kw)
            k2, k3, k4 = (k[:, :ndim] for k in (st.k2, st.k3, st.k4))
            field4, ic4, r_p, ic_fail = st.field4, st.ic, st.rp_fail, st.ic_fail
            n_rounds = n_rounds + st.rounds.max()
            ok = act & ~st.fail
            failed = act & st.fail
            # The fused path never runs with an icell mask, so a failure
            # that ends INSIDE the domain can only be the walk step cap
            cap_fail = failed & (ic_fail >= 0)
            k123 = trace_kernel.k123(k1, k2, k3)
            ys3 = anchor + dx[:, None] * k123
        else:
            ok = act
            _, _, k2, ic2, rp2, tgt2, f2, c2 = rk_stage(
                anchor, k1, 0.5 * dx, r0, i_cell_prev, ok)
            ok = ok & ~f2
            # Carry the sub-step end point and cell into the next walk
            # (:1122-1150); failed or done lanes keep the anchor start
            start3 = torch.where(ok[:, None], tgt2, r0)
            ics3 = torch.where(ok, ic2, i_cell_prev)
            _, _, k3, ic3, rp3, tgt3, f3, c3 = rk_stage(
                anchor, k2, 0.75 * dx, start3, ics3, ok)
            ok = ok & ~f3
            # 3rd-order update + 4th sub-step at the updated point
            # (:1144-1156)
            k123 = trace_kernel.k123(k1, k2, k3)
            start4 = torch.where(ok[:, None], tgt3, r0)
            ics4 = torch.where(ok, ic3, i_cell_prev)
            ys3, field4, k4, ic4, rp4, _, f4, c4 = rk_stage(
                anchor, k123, dx, start4, ics4, ok)
            ok = ok & ~f4
            failed = act & ~ok
            # The first failing stage supplies (r_p, i_cell) for the shrink
            r_p = torch.where(f2[:, None], rp2,
                              torch.where(f3[:, None], rp3, rp4))
            ic_fail = torch.where(f2, ic2, torch.where(f3, ic3, ic4))
            cap_fail = torch.where(f2, c2, torch.where(f3, c3, c4))

        # Embedded 2nd-order estimate and error norm (:1159-1163)
        y2nd = anchor + dx[:, None] * (
            7.0 * k1 + 6.0 * k2 + 8.0 * k3 + 3.0 * k4
        ) / 24.0
        scales = atol + torch.maximum(ys3.abs(), y2nd.abs()) * rtol
        err = torch.sqrt((((ys3 - y2nd) / scales) ** 2).sum(dim=1) / 3.0)
        accept = ok & ((err <= 1.0) | (dx < 2.0 * min_dx))

        # ---- failure path: shrink dx to the boundary distance ----
        # Capped at 0.75*dx: a trajectory hugging a wall fails right at
        # the step end, and the (1-eps) factor alone would decay dx by
        # ~eps per retry
        d_boundary = trace_kernel.norm3(r_p - r0)
        dx_fail = torch.minimum((1.0 - shrink_eps) * d_boundary, 0.75 * dx)
        hit_boundary = failed & (dx_fail < min_dx)

        # ---- accept path: store the new point ----
        n_new = torch.where(accept, n_idx + 1, n_idx)
        overflow_now = accept & (n_new >= max_steps)
        write = accept & ~overflow_now
        ys_store = clamp_axi(ys3)
        slot = torch.where(write, n_new, max_steps).long()
        y_buf[rows, slot] = ys_store
        yf_buf[rows, slot] = field4[:, :ndim]
        anchor = torch.where(write[:, None], ys_store, anchor)
        field_a = torch.where(write[:, None], field4, field_a)
        i_cell_prev = torch.where(accept, ic4, i_cell_prev)

        # ---- step-size control (:1178-1188) ----
        last_rejected = torch.where(act & (failed | ~accept), it,
                                    last_rejected)
        max_growth = torch.where(last_rejected > it - 2, 1.0, 2.0).to(dtype)
        dx_factor = torch.minimum(
            max_growth, SAFETY_FAC * (1.0 / err) ** (1.0 / 3.0))
        dx_ok = torch.clamp(dx * dx_factor, min_dx, max_dx)
        dx = torch.where(act, torch.where(failed, dx_fail, dx_ok), dx)

        done = done | hit_boundary | overflow_now
        # A step-cap failure at min_dx is a walk-budget artifact, not a
        # boundary or mask stop: it is reported distinctly
        bm = torch.where(
            hit_boundary,
            torch.where(cap_fail, BM_STEP_CAP, boundary_code(ic_fail)),
            bm,
        ).to(i32)
        n_idx = torch.where(write, n_new, n_idx)
        iteration = torch.where(act, it + 1, iteration).to(i32)
        overflow = overflow | overflow_now
        it += 1

    # n_steps: points stored; max_steps+1 flags 'boundary not reached
    # before the buffer filled' (:1167-1168)
    n_steps = torch.where(overflow, max_steps + 1, n_idx + 1).to(i32)
    return TraceResult(
        y=y_buf[:, :max_steps],
        y_field=yf_buf[:, :max_steps],
        n_steps=n_steps,
        boundary_material=bm,
        n_iterations=iteration,
        n_rounds=n_rounds,
    )

