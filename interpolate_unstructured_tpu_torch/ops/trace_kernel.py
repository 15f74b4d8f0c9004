"""Kernel B4: every field line's whole RK23 loop of the tracer.

Counterpart of the JAX package's ``ops/pallas_trace.py``, whose kernel
runs one round of the fused stages 2-4 of an iteration, looped by
``trace._fused_stages`` inside the ``lax.while_loop`` of
``integrate_along_field``.  Here one launch runs each line's whole loop
(``trace.integrate_along_field`` on the fused path; the reference's
m_interp_unstructured.f90:1078-1190): per RK iteration, k1 from the
stored field sample, stages 2-4 (walk from the anchor to the stage-2
target, interpolate the field on arrival from the same trace-table row,
take k2 and aim at the stage-3 target, and so on to k4 and the field at
the stage-4 point; a walk that leaves the domain, or is still walking
after ``max_steps`` rounds of one stage, fails the iteration with its
position and cell recorded for the boundary shrink), then the embedded
error estimate, the accept test, the boundary shrink, the store of the
new point and the step-size control (:func:`step_control`).

Each round of a stage is: one neighbor-walk round (``walk_kernel.
_face_round``); on arrival the field at the target from the row's vertex,
volume and field columns (``trace.build_trace_table``), k = +-field /
|field| and the stage machine.  A line's state depends on itself only,
and a finished line is left as it is, so one thread per line can run it
to its end.

:func:`trace_loop` launches the CUDA kernel (``csrc/trace.cu``, one
thread per line) on CUDA tensors and runs :func:`trace_loop_plain`, the
plain PyTorch version (a host loop over RK iterations whose stages are
:func:`trace_plain`, a round loop over the still-active lanes), on CPU
tensors.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _kernels, interp, walk_kernel

launches = 0

SAFETY_FAC = 0.8
MIN_RADIUS = 1e-12
# boundary_material sentinel: trace still running / buffer exhausted
BM_NOT_REACHED = -2
# A sub-step walk hit config.trace_walk_max_steps even at dx ~ min_dx:
# a min_dx segment crosses more cells than the cap allows.  The reference
# walks unbounded (:431), so it has no analog; reporting a boundary (-1)
# would be wrong mid-domain.  Raise trace_walk_max_steps or min_dx.
BM_STEP_CAP = -3

CELL_CODES = {"triangle": 0, "quad": 1, "tetra": 2}
_NPC = {"triangle": 3, "quad": 4, "tetra": 4}


class Stages(NamedTuple):
    """Per-lane results of one call; vectors are (B, 3), zero-padded
    past the grid's dimension."""

    k2: torch.Tensor
    k3: torch.Tensor
    k4: torch.Tensor
    field4: torch.Tensor  # field at the stage-4 point
    rp_fail: torch.Tensor  # walk position where a stage failed
    ic: torch.Tensor  # (B,) int32 cell at the end of the lane's walks
    fail: torch.Tensor  # (B,) bool: a stage failed
    ic_fail: torch.Tensor  # (B,) int32 cell where it failed (-1: none)
    rounds: torch.Tensor  # (B,) int32 rounds the lane was active


def supported(grid, i_icell_mask, nvar) -> bool:
    """Whether ``integrate_along_field`` takes the fused stages: float32
    grids of the three cell types, no icell mask, no extra variables."""
    return (
        grid.dtype == torch.float32
        and i_icell_mask is None
        and nvar == 0
        and grid.cell_type in CELL_CODES
    )


def round_cap(max_steps: int) -> int:
    """Rounds after which a lane stops (never reached: each of the three
    stages ends within ``max_steps`` rounds)."""
    return 3 * (max_steps + 2) + 4


def field_at_rows(g, cell_type, ndim, r):
    """Field at (n, 3) positions ``r`` from gathered trace rows ``g``
    (n, W): weights of the row's cell (``interp._weights_from_geometry``)
    over its vertex field values, summed in vertex order.  Returns
    (n, 3), zero past ``ndim``."""
    npc = _NPC[cell_type]
    cp_off = npc * 5  # nf == npc for every supported cell type
    vol_off = cp_off + npc * 3
    cp = g[:, cp_off:vol_off].reshape(-1, npc, 3)
    w = interp._weights_from_geometry(cell_type, cp, g[:, vol_off], r)
    fv = g[:, vol_off + 1: vol_off + 1 + npc * ndim].reshape(-1, npc, ndim)
    acc = w[:, 0, None] * fv[:, 0]
    for k in range(1, npc):
        acc = acc + w[:, k, None] * fv[:, k]
    return torch.nn.functional.pad(acc, (0, 3 - ndim))


def _div(a, c):
    """a / c for a Python number c, as a division by a tensor: torch
    turns division by a Python scalar on CUDA into a multiply by its
    rounded reciprocal, and the kernel divides."""
    return a / torch.full_like(a, c)


def k123(k1, k2, k3):
    """The third-order direction (2 k1 + 3 k2 + 4 k3) / 9 (:1144)."""
    return _div(2.0 * k1 + 3.0 * k2 + 4.0 * k3, 9.0)


def norm3(a):
    """Lengths of the (n, 3) rows of ``a``, summed as (x + y) + z like
    the kernel's."""
    return torch.sqrt((a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1])
                      + a[:, 2] * a[:, 2])


def _unit_or_zero(delta, tiny):
    """(unit direction, length): direction 0 where the length is at most
    ``tiny``."""
    total = norm3(delta)
    pos = total > tiny
    invt = torch.where(pos, 1.0 / torch.where(pos, total, 1.0), 0.0)
    return delta * invt[:, None], total


def clamp_axi(t, axisymmetric, min_radius):
    """(B, n) points with the first coordinate clamped at ``min_radius``
    when ``axisymmetric`` (:1120/:1133/:1147/:1171)."""
    if not axisymmetric:
        return t
    return torch.cat([t[:, :1].clamp_min(min_radius), t[:, 1:]], dim=1)


def trace_plain(table, anchor, k1, dx, ic_start, act, *, cell_type, ndim,
                nudge, eps_arrive, tiny, big, reverse, axisymmetric,
                max_steps, min_radius):
    """Plain PyTorch version of B4 (model: the round body of the JAX
    package's ``ops/pallas_trace._kernel`` looped as
    ``trace._fused_stages`` loops it), on any device.  Each round works
    on the still-active lanes only (``torch.nonzero``).

    Args:
      table: (n_rows, W) trace rows (``trace.build_trace_table``).
      anchor, k1: (B, 3) iteration start and stage-1 derivative,
        zero-padded past ``ndim``.
      dx: (B,) step sizes.
      ic_start: (B,) int32 cells containing the anchors (negative: 0).
      act: (B,) bool, the lanes that integrate.
      nudge, eps_arrive, tiny, big: walk tolerances, the degenerate
        length and the no-hit distance.
      max_steps: walk rounds a stage may take before it fails.
    Returns :class:`Stages`.
    """
    b = anchor.shape[0]
    dev = anchor.device
    nf = _NPC[cell_type]
    n_rows = table.shape[0]
    i32 = torch.int32

    # Stage-2 walk: from the anchor to anchor + dx/2 k1
    tgt = clamp_axi(anchor + (0.5 * dx)[:, None] * k1, axisymmetric,
                    min_radius)
    u, dl = _unit_or_zero(tgt - anchor, tiny)
    rp = anchor.clone()
    rpf = anchor.clone()
    k2, k3, k4, fld4 = (torch.zeros_like(anchor) for _ in range(4))
    ic = ic_start.to(i32).clamp_min(0)
    prev = torch.full((b,), -1, dtype=i32, device=dev)
    steps = torch.zeros(b, dtype=i32, device=dev)
    stage = torch.where(act, 2, 5).to(i32)
    fail = torch.zeros(b, dtype=torch.bool, device=dev)
    icf = torch.full((b,), -1, dtype=i32, device=dev)
    rounds = torch.zeros(b, dtype=i32, device=dev)
    nudge_t = torch.tensor(nudge, dtype=anchor.dtype, device=dev)
    zero = torch.zeros((), dtype=anchor.dtype, device=dev)

    lanes = torch.nonzero(act).squeeze(1)
    for _ in range(round_cap(max_steps)):
        if lanes.numel() == 0:
            break
        rounds[lanes] += 1
        ic_a = ic[lanes]
        g = table[ic_a.clamp(0, n_rows - 1).long()]
        p, ua, tg = rp[lanes], u[lanes], tgt[lanes]
        prev_a = prev[lanes]

        # walk round
        face_dist, ic_next, hit = walk_kernel._face_round(g, nf, ua, p, prev_a,
                                                          big)
        d = dl[lanes]
        crossing = hit & (d - face_dist > eps_arrive)
        out_of_domain = ic_next < 0
        continuing = crossing & ~out_of_domain
        advance = face_dist + torch.where(continuing, nudge_t, zero)
        rp_n = torch.where(hit[:, None], p + advance[:, None] * ua, p)
        dl_n = torch.where(hit, d - advance, d)
        steps_n = steps[lanes] + 1
        prev_n = torch.where(continuing, ic_a, prev_a)
        ic_n = torch.where(crossing, ic_next, ic_a)
        capped = continuing & (steps_n >= max_steps)
        arrived = ~crossing
        failednow = (crossing & out_of_domain) | capped

        # field at the target from the same row, for arriving lanes
        fld = field_at_rows(g, cell_type, ndim, tg)
        fn = norm3(fld).clamp_min(tiny)
        k_new = (-fld if reverse else fld) / fn[:, None]

        # stage machine
        st = stage[lanes]
        ent3 = arrived & (st == 2)
        ent4 = arrived & (st == 3)
        fin = arrived & (st == 4)
        k2a = torch.where(ent3[:, None], k_new, k2[lanes])
        k3a = torch.where(ent4[:, None], k_new, k3[lanes])
        k2[lanes] = k2a
        k3[lanes] = k3a
        k4[lanes] = torch.where(fin[:, None], k_new, k4[lanes])
        fld4[lanes] = torch.where(fin[:, None], fld, fld4[lanes])
        stage[lanes] = torch.where(arrived, st + 1,
                                   torch.where(failednow, 5, st)).to(i32)
        fail[lanes] = fail[lanes] | failednow
        rpf[lanes] = torch.where(failednow[:, None], rp_n, rpf[lanes])
        icf[lanes] = torch.where(failednow, ic_n, icf[lanes])

        # next-stage target: anchor + 0.75 dx k2, or anchor + dx k123
        enter = ent3 | ent4
        dxa = dx[lanes]
        t = anchor[lanes] + torch.where(ent3[:, None],
                                        (0.75 * dxa)[:, None] * k2a,
                                        dxa[:, None] * k123(k1[lanes], k2a,
                                                            k3a))
        tgt_n = torch.where(enter[:, None],
                            clamp_axi(t, axisymmetric, min_radius), tg)
        u_n, total = _unit_or_zero(tgt_n - tg, tiny)

        rp[lanes] = torch.where(enter[:, None], tg, rp_n)
        tgt[lanes] = tgt_n
        u[lanes] = torch.where(enter[:, None], u_n, ua)
        dl[lanes] = torch.where(enter, total, dl_n)
        prev[lanes] = torch.where(enter, -1, prev_n).to(i32)
        steps[lanes] = torch.where(enter, 0, steps_n).to(i32)
        ic[lanes] = ic_n
        lanes = lanes[enter | (continuing & ~capped)]
    return Stages(k2, k3, k4, fld4, rpf, ic, fail, icf, rounds)


def pad3(r):
    """(B, n) -> (B, 3) with zero-filled coordinates past n."""
    return torch.nn.functional.pad(r, (0, 3 - r.shape[1]))


def unit_field(field, ndim, tiny, reverse):
    """(B, ndim) unit vectors of the (B, 3) field samples, guarded by
    ``tiny`` (a zero field steps in place and ends as BM_NOT_REACHED;
    the reference divides by zero, :1199), negated when ``reverse``."""
    u = field[:, :ndim] / norm3(field).clamp_min(tiny)[:, None]
    return -u if reverse else u


def out_buffers(y0, field0, max_steps, ndim):
    """The zeroed (B, max_steps + 1, D) curve and (B, max_steps + 1,
    ndim) field buffers with the start points and fields in row 0."""
    b = y0.shape[0]
    y_buf = y0.new_zeros((b, max_steps + 1, y0.shape[1]))
    y_buf[:, 0] = y0
    yf_buf = y0.new_zeros((b, max_steps + 1, ndim))
    yf_buf[:, 0] = field0[:, :ndim]
    return y_buf, yf_buf


class RKState:
    """The per-line state of the RK loop (:1045-1073): output buffers
    (B, max_steps + 1, ·), whose last row takes the writes of lines that
    store no point; the accepted state ``anchor`` (B, D) and its field
    sample ``field_a`` (B, 3); step counters, step size and flags."""

    def __init__(self, y0, field0, ic0, done, bm, max_dx, max_steps, ndim):
        b, dev, dtype = y0.shape[0], y0.device, y0.dtype
        i32 = torch.int32
        self.y_buf, self.yf_buf = out_buffers(y0, field0, max_steps, ndim)
        self.anchor = y0
        self.field_a = field0
        self.n_idx = torch.zeros(b, dtype=i32, device=dev)
        self.i_cell_prev = ic0
        self.dx = torch.full((b,), max_dx, dtype=dtype, device=dev)
        self.last_rejected = torch.full((b,), -100, dtype=i32, device=dev)
        self.iteration = torch.zeros(b, dtype=i32, device=dev)
        self.overflow = torch.zeros(b, dtype=torch.bool, device=dev)
        self.done = done
        self.bm = bm
        self.n_rounds = torch.zeros((), dtype=i32, device=dev)

    def result(self, max_steps):
        """(y, y_field, n_steps, boundary_material, n_iterations,
        n_rounds): n_steps counts the points stored, max_steps + 1 flags
        'boundary not reached before the buffer filled' (:1167-1168)."""
        n_steps = torch.where(self.overflow, max_steps + 1,
                              self.n_idx + 1).to(torch.int32)
        return (self.y_buf[:, :max_steps], self.yf_buf[:, :max_steps],
                n_steps, self.bm, self.iteration, self.n_rounds)


def step_control(s, it, act, k, ys3, field4, ic4, r_p, ok, failed, ic_fail,
                 cap_fail, boundary_code, *, ndim, min_dx, max_dx, max_steps,
                 rtol, atol, shrink_eps, axisymmetric, min_radius=MIN_RADIUS):
    """What follows the stages of RK iteration ``it`` (both paths of
    ``trace.integrate_along_field``), updating the :class:`RKState` ``s``
    in place: the embedded error estimate (:1159-1163), the accept test,
    the boundary shrink (:1084), the store of the new point, the step-size
    control (:1178-1188) and the ends.  ``k`` = (k1, k2, k3, k4), each
    (B, D); ``ys3`` the third-order point; ``field4``, ``ic4`` the field
    and cell at the stage-4 point; ``r_p`` (B, 3) and ``ic_fail`` the
    position and cell of a failed walk; ``boundary_code(ic)`` the code of
    a boundary end.  Divisions are by tensors and sums run left to right,
    as the kernel computes them."""
    k1, k2, k3, k4 = k
    dx = s.dx
    anchor = s.anchor
    y2nd = anchor + _div(dx[:, None] * (7.0 * k1 + 6.0 * k2 + 8.0 * k3
                                        + 3.0 * k4), 24.0)
    scales = atol + torch.maximum(ys3.abs(), y2nd.abs()) * rtol
    q = ((ys3 - y2nd) / scales) ** 2
    q_sum = q[:, 0]
    for d in range(1, q.shape[1]):
        q_sum = q_sum + q[:, d]
    err = torch.sqrt(_div(q_sum, 3.0))
    accept = ok & ((err <= 1.0) | (dx < 2.0 * min_dx))

    # ---- failure path: shrink dx to the boundary distance ----
    # Capped at 0.75*dx: a trajectory hugging a wall fails right at the
    # step end, and the (1-eps) factor alone would decay dx by ~eps per
    # retry
    d_boundary = norm3(r_p - pad3(anchor[:, :ndim]))
    dx_fail = torch.minimum((1.0 - shrink_eps) * d_boundary, 0.75 * dx)
    hit_boundary = failed & (dx_fail < min_dx)

    # ---- accept path: store the new point ----
    n_new = torch.where(accept, s.n_idx + 1, s.n_idx)
    overflow_now = accept & (n_new >= max_steps)
    write = accept & ~overflow_now
    ys_store = clamp_axi(ys3, axisymmetric, min_radius)
    rows = torch.arange(anchor.shape[0], device=anchor.device)
    slot = torch.where(write, n_new, max_steps).long()
    s.y_buf[rows, slot] = ys_store
    s.yf_buf[rows, slot] = field4[:, :ndim]
    s.anchor = torch.where(write[:, None], ys_store, anchor)
    s.field_a = torch.where(write[:, None], field4, s.field_a)
    s.i_cell_prev = torch.where(accept, ic4, s.i_cell_prev)

    # ---- step-size control (:1178-1188) ----
    s.last_rejected = torch.where(act & (failed | ~accept), it,
                                  s.last_rejected)
    max_growth = torch.where(s.last_rejected > it - 2, 1.0, 2.0).to(dx.dtype)
    dx_factor = torch.minimum(
        max_growth, SAFETY_FAC * (torch.ones_like(err) / err) ** (1.0 / 3.0))
    dx_ok = torch.clamp(dx * dx_factor, min_dx, max_dx)
    s.dx = torch.where(act, torch.where(failed, dx_fail, dx_ok), dx)

    s.done = s.done | hit_boundary | overflow_now
    # A step-cap failure at min_dx is a walk-budget artifact, not a
    # boundary or mask stop: it is reported distinctly
    s.bm = torch.where(
        hit_boundary,
        torch.where(cap_fail, BM_STEP_CAP, boundary_code(ic_fail)),
        s.bm,
    ).to(torch.int32)
    s.n_idx = torch.where(write, n_new, s.n_idx)
    s.iteration = torch.where(act, it + 1, s.iteration).to(torch.int32)
    s.overflow = s.overflow | overflow_now


def _check_loop_inputs(table, y0, field0, ic0, done, bm, cell_type, ndim):
    if cell_type not in CELL_CODES:
        raise ValueError(f"Unsupported cell type {cell_type!r}")
    b = y0.shape[0]
    if not (y0.shape == (b, ndim) and field0.shape == (b, 3)
            and ic0.shape == done.shape == bm.shape == (b,)):
        raise ValueError("trace inputs must be y0 (B, ndim), field0 (B, 3) "
                         "and ic0, done, bm (B,)")
    if ic0.dtype != torch.int32 or bm.dtype != torch.int32:
        raise TypeError("ic0 and bm must be int32")
    if done.dtype != torch.bool:
        raise TypeError("done must be bool")
    if len({t.device for t in (table, y0, field0, ic0, done, bm)}) != 1:
        raise ValueError("trace inputs must share one device")


def trace_loop_plain(table, y0, field0, ic0, done, bm, *, cell_type, ndim,
                     nudge, eps_arrive, tiny, big, reverse, axisymmetric,
                     walk_steps, min_radius, min_dx, max_dx, max_steps, rtol,
                     atol, shrink_eps, max_iterations):
    """Plain PyTorch version of B4 (model: the fused path of the JAX
    package's ``trace.integrate_along_field``), on any device: a host
    loop over RK iterations while a line is not done, each running
    :func:`trace_plain` for stages 2-4 of every line and
    :func:`step_control`.

    Args:
      table: (n_rows, W) trace rows (``trace.build_trace_table``).
      y0: (B, ndim) start points; field0: (B, 3) the field there, zero
        past ``ndim`` (zero where the line does not start).
      ic0: (B,) int32 start cells; done: (B,) bool, lines that do not
        start; bm: (B,) int32 their boundary codes (BM_NOT_REACHED for
        the others).
      nudge, eps_arrive, tiny, big: walk tolerances, the degenerate
        length and the no-hit distance; walk_steps: walk rounds a stage
        may take before it fails.
      min_dx, max_dx, max_steps, rtol, atol, reverse, axisymmetric:
        ``integrate_along_field``'s; shrink_eps: the boundary shrink
        factor's eps; max_iterations: the cap on RK iterations.
    Returns (y (B, max_steps, ndim), y_field (B, max_steps, ndim),
    n_steps, boundary_material, n_iterations (B,) int32, n_rounds ()
    int32: the stage rounds summed over iterations of the largest lane
    count, as the JAX package counts them).
    """
    _check_loop_inputs(table, y0, field0, ic0, done, bm, cell_type, ndim)
    s = RKState(y0, field0, ic0, done, bm, max_dx, max_steps, ndim)
    stage_kw = dict(cell_type=cell_type, ndim=ndim, nudge=nudge,
                    eps_arrive=eps_arrive, tiny=tiny, big=big,
                    reverse=reverse, axisymmetric=axisymmetric,
                    max_steps=walk_steps, min_radius=min_radius)
    it = 0
    while it < max_iterations and bool((~s.done).any()):
        act = ~s.done
        # k1 reuses the stored field sample (:1109-1115)
        k1 = unit_field(s.field_a, ndim, tiny, reverse)
        st = trace_plain(table, pad3(s.anchor), pad3(k1), s.dx,
                         s.i_cell_prev, act, **stage_kw)
        k2, k3, k4 = (kk[:, :ndim] for kk in (st.k2, st.k3, st.k4))
        s.n_rounds = s.n_rounds + st.rounds.max()
        failed = act & st.fail
        # No icell mask on this path, so a failure that ends INSIDE the
        # domain can only be the walk step cap
        cap_fail = failed & (st.ic_fail >= 0)
        ys3 = s.anchor + s.dx[:, None] * k123(k1, k2, k3)
        step_control(
            s, it, act, (k1, k2, k3, k4), ys3, st.field4, st.ic, st.rp_fail,
            act & ~st.fail, failed, st.ic_fail, cap_fail,
            lambda ic: torch.full_like(ic, -1), ndim=ndim, min_dx=min_dx,
            max_dx=max_dx, max_steps=max_steps, rtol=rtol, atol=atol,
            shrink_eps=shrink_eps, axisymmetric=axisymmetric,
            min_radius=min_radius)
        it += 1
    return s.result(max_steps)


def _f32(x):
    """A Python number rounded to float32, as torch rounds a scalar
    operand of a float32 tensor op."""
    return float(np.float32(x))


def trace_loop_cuda(table, y0, field0, ic0, done, bm, *, cell_type, ndim,
                    nudge, eps_arrive, tiny, big, reverse, axisymmetric,
                    walk_steps, min_radius, min_dx, max_dx, max_steps, rtol,
                    atol, shrink_eps, max_iterations):
    """Launch B4 on CUDA tensors (arguments and results as
    :func:`trace_loop_plain`; float32 table, y0 and field0): one thread
    per line runs its RK iterations to the end.  ``n_rounds`` is kept as
    each iteration's largest round count (an atomic max into an int32
    buffer of ``max_iterations`` entries), summed on the device after."""
    global launches
    _check_loop_inputs(table, y0, field0, ic0, done, bm, cell_type, ndim)
    if any(t.dtype != torch.float32 for t in (table, y0, field0)):
        raise TypeError(
            "the CUDA tracer kernel takes float32 tables, start points and "
            f"fields, got {table.dtype} / {y0.dtype} / {field0.dtype}")
    npc = _NPC[cell_type]
    if (table.ndim != 2 or not table.is_contiguous() or table.shape[0] < 1
            or table.shape[1] < npc * 8 + 1 + npc * ndim):
        raise ValueError("table must hold contiguous, non-empty trace rows")
    if max_iterations < 0 or max_steps < 1:
        raise ValueError("max_iterations must be >= 0 and max_steps >= 1")
    y0, field0 = y0.contiguous(), field0.contiguous()
    ic0, done, bm = ic0.contiguous(), done.contiguous(), bm.contiguous()
    y_buf, yf_buf = out_buffers(y0, field0, max_steps, ndim)
    b = y0.shape[0]
    dev = table.device
    n_steps = torch.empty(b, dtype=torch.int32, device=dev)
    bm_out = torch.empty(b, dtype=torch.int32, device=dev)
    iters = torch.empty(b, dtype=torch.int32, device=dev)
    rounds = torch.zeros(max(max_iterations, 1), dtype=torch.int32,
                         device=dev)
    if b:
        with torch.cuda.device(dev):
            code = _kernels.lib().iu_trace_loop(
                table.data_ptr(), table.shape[0], table.shape[1],
                CELL_CODES[cell_type], y0.data_ptr(), field0.data_ptr(),
                ic0.data_ptr(), done.data_ptr(), bm.data_ptr(), b,
                float(nudge), float(eps_arrive), float(tiny), float(big),
                int(reverse), int(axisymmetric), int(walk_steps),
                float(min_radius), round_cap(walk_steps), float(min_dx),
                float(max_dx), _f32(2.0 * min_dx), float(rtol), float(atol),
                _f32(1.0 - shrink_eps), _f32(SAFETY_FAC), _f32(1.0 / 3.0),
                int(max_steps), int(max_iterations), y_buf.data_ptr(),
                yf_buf.data_ptr(), n_steps.data_ptr(), bm_out.data_ptr(),
                iters.data_ptr(), rounds.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _kernels.check(code, "iu_trace_loop")
        launches += 1
    return (y_buf[:, :max_steps], yf_buf[:, :max_steps], n_steps, bm_out,
            iters, rounds.sum(dtype=torch.int32))


def trace_loop(table, y0, field0, ic0, done, bm, **kw):
    """Every line's RK loop: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (arguments and results as
    :func:`trace_loop_plain`)."""
    if table.device.type == "cuda":
        return trace_loop_cuda(table, y0, field0, ic0, done, bm, **kw)
    if table.device.type == "cpu":
        return trace_loop_plain(table, y0, field0, ic0, done, bm, **kw)
    raise ValueError(f"no tracer kernel for device {table.device}")
