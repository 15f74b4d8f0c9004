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

After the setup (start cells by ``get_cell``, the field there, the
buffers) the loop takes one of two paths.  The fused path (float32, no
mask, ``nvar == 0``) is one call of ``ops/trace_kernel.trace_loop``:
kernel B4, one launch in which each line runs all its RK iterations
(stages 2-4 walk, interpolate on arrival from the trace table and
advance the line's stage machine).  The generic path keeps a host loop
over RK iterations: it walks each stage with kernel B3 on the trace
table (``ops/locate.walk(..., table=)``) and interpolates in torch.  A
float64 grid takes the generic path, as in the JAX package, its walks
in B3's double instantiation.  A
lane whose earlier sub-step failed (or that is done) aims its later
walks at their own start, which makes them no-ops, so one pass through
the body computes what the reference's goto-laden loop does.  Both paths
end each iteration with ``trace_kernel.step_control``.  Vectors are
(B, D) inside; the JAX package's (D, B) row layout was a TPU layout.
On the card a fused trace replays its start cells and start field as
one CUDA graph from the second call with the same grid, fields and batch
size on (:func:`_graphed_start`): the host issues one replay where it
issued some twenty launches and ops.

While tracing (``utils/timing.py``) a call is the entry span
``iu.integrate_along_field``, holding ``iu.trace.setup`` (the table when
built per call, the start cells and the start field, or their graph's
input copy and replay) and ``iu.trace.loop`` (B4's buffers and launch,
or the generic loop: an ``iu.trace.iteration`` span and a host read
each iteration), and counts ``trace.lines``, ``trace.iterations``,
``trace.steps`` and ``trace.rounds`` from its result, and on the fused
path on the card one of ``trace.graph_eager``,
``trace.graph_captures`` and ``trace.graph_replays``.  A replayed
set-up holds no ``iu.locate`` or ``iu.icell`` span: the graph was
captured with the spans off.
"""

from __future__ import annotations

import weakref
from typing import Any, NamedTuple

import numpy as np
import torch

from .ops import interp, locate, trace_kernel
from .ops.trace_kernel import (  # noqa: F401
    BM_NOT_REACHED,
    BM_STEP_CAP,
    MIN_RADIUS,
    SAFETY_FAC,
)
from .utils import timing
from .utils.config import huge_distance, tiny_distance

# Captured set-ups of the fused path kept a grid (_graphed_start), the
# least recently used dropped first: each holds its graph's memory
GRAPHS_KEPT = 4


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
    n_rounds: Any = None  # () int32: B4's stage rounds, summed over
    #                       iterations of the largest lane count (0 on the
    #                       generic path)


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


@timing.spanned("iu.integrate_along_field", entry=True)
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
    y0 = torch.as_tensor(y0).to(dtype=dtype, device=dev)
    if y0.ndim != 2 or y0.shape[1] != ndim + nvar:
        raise ValueError(f"y0 must have shape (B, {ndim + nvar})")
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    shrink_eps = _shrink_eps(np_dtype)
    tiny = tiny_distance(np_dtype)
    i32 = torch.int32

    use_fused = trace_kernel.supported(grid, i_icell_mask, nvar)
    sub_int_b = torch.func.vmap(sub_int) if nvar else None
    walk_cap = grid.config.trace_walk_max_steps

    pad3 = trace_kernel.pad3

    def derivs(field, y):
        """(B, D) derivatives: the unit field vector, then the extra
        variables'."""
        u = trace_kernel.unit_field(field, ndim, tiny, reverse)
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
        tgt = torch.where(ok[:, None], trace_kernel.clamp_axi(
            pad3(ys[:, :ndim]), axisymmetric, MIN_RADIUS), r_start)
        ic, r_p, _, st = locate.walk(
            grid, r_start, tgt, ic_start, max_steps=walk_cap,
            i_icell_mask=i_icell_mask, table=trace_table,
        )
        failed = ok & (st != locate.STATUS_ARRIVED)
        capped = ok & (st == locate.STATUS_STEP_CAP)
        field = trace_kernel.field_at_rows(
            trace_table[ic.clamp_min(0).long()], grid.cell_type, ndim, tgt)
        return ys, field, derivs(field, ys), ic, r_p, tgt, failed, capped

    def iteration(s, it):
        """One RK iteration of the generic path over every line."""
        act = ~s.done
        anchor = s.anchor
        r0 = pad3(anchor[:, :ndim])
        # k1 reuses the stored field sample (:1109-1115)
        k1 = derivs(s.field_a, anchor)
        dx = s.dx
        ok = act
        _, _, k2, ic2, rp2, tgt2, f2, c2 = rk_stage(
            anchor, k1, 0.5 * dx, r0, s.i_cell_prev, ok)
        ok = ok & ~f2
        # Carry the sub-step end point and cell into the next walk
        # (:1122-1150); failed or done lanes keep the anchor start
        start3 = torch.where(ok[:, None], tgt2, r0)
        ics3 = torch.where(ok, ic2, s.i_cell_prev)
        _, _, k3, ic3, rp3, tgt3, f3, c3 = rk_stage(
            anchor, k2, 0.75 * dx, start3, ics3, ok)
        ok = ok & ~f3
        # 3rd-order update + 4th sub-step at the updated point
        # (:1144-1156)
        k123 = trace_kernel.k123(k1, k2, k3)
        start4 = torch.where(ok[:, None], tgt3, r0)
        ics4 = torch.where(ok, ic3, s.i_cell_prev)
        ys3, field4, k4, ic4, rp4, _, f4, c4 = rk_stage(
            anchor, k123, dx, start4, ics4, ok)
        ok = ok & ~f4
        # The first failing stage supplies (r_p, i_cell) for the shrink
        r_p = torch.where(f2[:, None], rp2,
                          torch.where(f3[:, None], rp3, rp4))
        ic_fail = torch.where(f2, ic2, torch.where(f3, ic3, ic4))
        cap_fail = torch.where(f2, c2, torch.where(f3, c3, c4))
        trace_kernel.step_control(
            s, it, act, (k1, k2, k3, k4), ys3, field4, ic4, r_p, ok,
            act & ~ok, ic_fail, cap_fail, boundary_code, ndim=ndim,
            min_radius=MIN_RADIUS, **loop_kw)

    def start(y0):
        """(ic0, field0, done, bm) of the lines from ``y0``: start cells,
        the field there, the lines that do not start and their codes
        (:1045-1073)."""
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
        field0 = pad3(torch.where(in_region[:, None], field0, 0.0))
        return ic0, field0, done, bm

    # ---- initialization (:1045-1073) ----
    with timing.span("iu.trace.setup", dev):
        if trace_table is None:
            trace_table = build_trace_table(grid, i_field)
        if use_fused and dev.type == "cuda" and y0.shape[0]:
            key = (y0.shape[0], i_field,
                   torch.cuda.current_stream(dev).cuda_stream)
            ic0, field0, done, bm = _graphed_start(grid, key, start, y0)
        else:
            ic0, field0, done, bm = start(y0)
        loop_kw = dict(min_dx=min_dx, max_dx=max_dx, max_steps=max_steps,
                       rtol=rtol, atol=atol, shrink_eps=shrink_eps,
                       axisymmetric=axisymmetric)
        if not use_fused:
            s = trace_kernel.RKState(y0, field0, ic0, done, bm, max_dx,
                                     max_steps, ndim)

    with timing.span("iu.trace.loop", dev):
        if use_fused:
            # Every line's whole RK loop in one launch of B4
            nudge, eps_arrive = grid.walk_tol
            res = TraceResult(*trace_kernel.trace_loop(
                trace_table, y0, field0, ic0, done, bm,
                cell_type=grid.cell_type, ndim=ndim, nudge=nudge,
                eps_arrive=eps_arrive, tiny=tiny,
                big=huge_distance(np_dtype), reverse=reverse,
                walk_steps=walk_cap, min_radius=MIN_RADIUS,
                max_iterations=max_iterations, **loop_kw))
        else:
            it = 0
            while it < max_iterations:
                with timing.host_read("trace_loop", s.done):
                    if not bool((~s.done).any()):
                        break
                with timing.span("iu.trace.iteration", dev):
                    iteration(s, it)
                it += 1
            res = TraceResult(*s.result(max_steps))
    _count_trace(res, max_steps)
    return res


class _SetupGraph:
    """The fused path's set-up for one key of :func:`_graphed_start`: the
    key's calls so far, and from its second call on a CUDA graph of the
    set-up with its static input ``y0`` and outputs ``out`` (``graph``
    stays None where the set-up cannot be captured)."""

    __slots__ = ("calls", "graph", "y0", "out")

    def __init__(self):
        self.calls, self.graph, self.y0, self.out = 0, None, None, None

    def capture(self, start, y0):
        """Run ``start`` once on a side stream, which does every launch's
        first-use set-up outside the capture, then capture it there on a
        copy of ``y0``, with the port's spans and counters off and in
        this thread's capture mode, so that other threads' CUDA work
        does not void it.  Unlike ``torch.cuda.graph`` it neither
        synchronizes the device nor empties the allocator's cache, which
        would make the next calls allocate afresh.  Raises
        ``timing.HostReadInCapture`` where ``start`` reaches a host-read
        site, and CUDA's error where the capture fails."""
        dev = y0.device
        y0 = y0.clone()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with timing.capturing(), torch.cuda.device(dev), \
                torch.cuda.stream(side):
            start(y0)
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = start(y0)
            finally:
                graph.capture_end()
        main.wait_stream(side)
        self.graph, self.y0, self.out = graph, y0, out


# The captured set-ups of each grid: id(grid) -> {key: _SetupGraph},
# least recently used first, dropped with the grid
_GRAPHS = {}


def _graphs_of(grid):
    """The set-ups :func:`_graphed_start` keeps for ``grid``."""
    graphs = _GRAPHS.get(id(grid))
    if graphs is None:
        graphs = _GRAPHS[id(grid)] = {}
        weakref.finalize(grid, _GRAPHS.pop, id(grid), None)
    return graphs


def _graphed_start(grid, key, start, y0):
    """``start(y0)`` of a fused trace on the card, as a CUDA graph replay
    from the key's second call on (key: the batch size, the traced
    fields and the stream, what ``start`` reads besides the grid; the
    graphs are kept by grid, ``GRAPHS_KEPT`` keys each).  A key's first
    call runs eagerly, so a caller who changes the batch every call
    never pays for a capture; its second captures (and replays); later
    ones copy ``y0`` into the static input and replay.  A set-up that
    cannot be captured (one that reads the device back, as a candidate
    residual or a kd-tree seed does, or a capture CUDA refuses) runs
    eagerly for good.  The outputs are the graph's own buffers,
    rewritten by the key's next replay on the same stream: they feed B4
    and are never returned.  While tracing it counts
    ``trace.graph_eager``, ``trace.graph_captures`` or
    ``trace.graph_replays``."""
    graphs = _graphs_of(grid)
    ent = graphs.pop(key, None) or _SetupGraph()
    graphs[key] = ent
    while len(graphs) > GRAPHS_KEPT:
        graphs.pop(next(iter(graphs)))
    ent.calls += 1
    if ent.graph is None:
        if ent.calls != 2:
            _count("trace.graph_eager")
            return start(y0)
        try:
            ent.capture(start, y0)
        except RuntimeError:  # HostReadInCapture, or CUDA's
            _count("trace.graph_eager")
            return start(y0)
        _count("trace.graph_captures")
    else:
        _count("trace.graph_replays")
    ent.y0.copy_(y0)
    ent.graph.replay()
    return ent.out


def _count(name):
    """Count one ``name`` while tracing."""
    if timing.tracing():
        timing.metrics.count(name)


def _count_trace(res, max_steps):
    """While tracing, count a trace's lines, RK iterations, stored points
    (capped at ``max_steps``) and B4's stage rounds, summed on the
    device from its result."""
    if not timing.tracing():
        return
    count = timing.metrics.count
    count("trace.lines", res.n_steps.shape[0])
    count("trace.iterations", res.n_iterations.sum())
    count("trace.steps", res.n_steps.clamp_max(max_steps).sum())
    if res.n_rounds is not None:
        count("trace.rounds", res.n_rounds.sum())


def write_trace_vtk(result: TraceResult, filename, ndim: int = None,
                    min_points: int = 2):
    """Export traced field lines as VTK polylines (.vtu), the same bytes
    as the JAX package's ``write_trace_vtk`` of the same result.

    Each trajectory becomes one VTK_POLY_LINE cell over its valid
    points; extra ODE variables ("var0", ...), the sampled field
    components ("field_0", ...), per-vertex arc index ("step") and the
    trajectory id ("trajectory") ride along as point data.  Beyond the
    reference (iu_write_vtk exports only the grid) — load next to the
    grid's .vtu to visualize traces through the mesh.

    Trajectories storing fewer than ``min_points`` points are omitted.
    The default (2) drops both invalid starts (seed outside the
    mesh/mask — these store only their seed) and legitimate one-point
    traces that hit the boundary on their very first step; the two are
    indistinguishable in a ``TraceResult``.  Pass ``min_points=1`` to
    keep the latter (they render as single-vertex polylines, i.e.
    orphan points — including any invalid starts in the batch).
    """
    from .io.vtk import write_vtu_polylines
    from .models.grid import host_array as host

    y = host(result.y)
    yf = host(result.y_field)
    b, max_steps, d = y.shape
    if ndim is None:
        ndim = yf.shape[2]
    # n_steps == max_steps + 1 flags an overflowed buffer (:1167-1168)
    n = np.minimum(host(result.n_steps), max_steps)
    keep = np.flatnonzero(n >= min_points)
    n = n[keep]

    idx = [ik * max_steps + np.arange(nk) for ik, nk in zip(keep, n)]
    idx = (
        np.concatenate(idx) if idx else np.zeros(0, dtype=np.int64)
    )
    pts = y.reshape(b * max_steps, d)[idx][:, :ndim]
    if ndim < 3:
        pts = np.pad(pts, ((0, 0), (0, 3 - ndim)))
    point_data = {
        f"var{i}": y.reshape(b * max_steps, d)[idx][:, ndim + i]
        for i in range(d - ndim)
    }
    for c in range(yf.shape[2]):
        point_data[f"field_{c}"] = yf.reshape(b * max_steps, -1)[idx][:, c]
    ipoint_data = {
        "trajectory": np.repeat(keep.astype(np.int32), n),
        "step": np.concatenate(
            [np.arange(nk, dtype=np.int32) for nk in n]
        )
        if len(n)
        else np.zeros(0, np.int32),
    }
    write_vtu_polylines(
        filename, pts, np.cumsum(n).astype(np.int32),
        point_data, ipoint_data,
    )
