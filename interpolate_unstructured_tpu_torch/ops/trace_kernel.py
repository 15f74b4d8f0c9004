"""Kernel B4: the fused stages of one tracer RK23 iteration.

Counterpart of the JAX package's ``ops/pallas_trace.py``.  For every
trajectory of the batch, stages 2-4 of one Bogacki-Shampine iteration
(``trace.integrate_along_field``; the reference's
m_interp_unstructured.f90:1122-1156): walk from the anchor to the stage-2
target, interpolate the field on arrival from the same trace-table row,
take k2 and aim at the stage-3 target, and so on to k4 and the field at
the stage-4 point.  A walk that leaves the domain, or is still walking
after ``max_steps`` rounds of one stage, ends the lane's iteration as a
failure, with its position and cell recorded for the boundary shrink.

Each round of a lane is: one neighbor-walk round (``walk_kernel.
_face_round``); on arrival the field at the target from the row's vertex,
volume and field columns (``trace.build_trace_table``), k = +-field /
|field| and the stage machine.  Lanes are independent, and an inactive
lane is left as it is, so one call runs every lane to its end.

:func:`trace_stages` launches the CUDA kernel (``csrc/trace.cu``, one
thread per trajectory) on CUDA tensors and runs :func:`trace_plain`, the
plain PyTorch version (a round loop over the still-active lanes), on CPU
tensors.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _kernels, interp, walk_kernel

launches = 0

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


def k123(k1, k2, k3):
    """The third-order direction (2 k1 + 3 k2 + 4 k3) / 9 (:1144).  The
    divisor is a tensor: torch turns division by a Python scalar on CUDA
    into a multiply by its rounded reciprocal, and the kernel divides."""
    return (2.0 * k1 + 3.0 * k2 + 4.0 * k3) / torch.full_like(k1, 9.0)


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


def _clamp_axi(t, axisymmetric, min_radius):
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
    tgt = _clamp_axi(anchor + (0.5 * dx)[:, None] * k1, axisymmetric,
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
                            _clamp_axi(t, axisymmetric, min_radius), tg)
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


def trace_cuda(table, anchor, k1, dx, ic_start, act, *, cell_type, ndim,
               nudge, eps_arrive, tiny, big, reverse, axisymmetric,
               max_steps, min_radius):
    """Launch B4 on CUDA tensors: float32 table, anchors, derivatives and
    step sizes, int32 ``ic_start``, bool ``act``.  One thread per
    trajectory runs its rounds to the end."""
    global launches
    if cell_type not in CELL_CODES:
        raise ValueError(f"Unsupported cell type {cell_type!r}")
    b = anchor.shape[0]
    if not (anchor.shape == k1.shape == (b, 3)
            and dx.shape == ic_start.shape == act.shape == (b,)):
        raise ValueError(
            "trace inputs must be anchor, k1 (B, 3) and dx, ic_start, act (B,)"
        )
    if any(t.dtype != torch.float32 for t in (table, anchor, k1, dx)):
        raise TypeError(
            "the CUDA tracer kernel takes float32 tables, anchors, "
            f"derivatives and steps, got {table.dtype} / {anchor.dtype}"
        )
    if ic_start.dtype != torch.int32 or act.dtype != torch.bool:
        raise TypeError("ic_start must be int32 and act bool")
    if len({t.device for t in (table, anchor, k1, dx, ic_start, act)}) != 1:
        raise ValueError("trace inputs must share one device")
    npc = _NPC[cell_type]
    if (table.ndim != 2 or not table.is_contiguous() or table.shape[0] < 1
            or table.shape[1] < npc * 8 + 1 + npc * ndim):
        raise ValueError("table must hold contiguous, non-empty trace rows")
    anchor, k1, dx = anchor.contiguous(), k1.contiguous(), dx.contiguous()
    ic_start, act = ic_start.contiguous(), act.contiguous()
    dev = table.device
    out_f = torch.empty((b, 15), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, 4), dtype=torch.int32, device=dev)
    if b:
        with torch.cuda.device(dev):
            code = _kernels.lib().iu_trace(
                table.data_ptr(), table.shape[0], table.shape[1],
                CELL_CODES[cell_type], anchor.data_ptr(), k1.data_ptr(),
                dx.data_ptr(), ic_start.data_ptr(), act.data_ptr(), b,
                float(nudge), float(eps_arrive), float(tiny), float(big),
                int(reverse), int(axisymmetric), int(max_steps),
                float(min_radius), round_cap(max_steps), out_f.data_ptr(),
                out_i.data_ptr(), torch.cuda.current_stream().cuda_stream,
            )
        _kernels.check(code, "iu_trace")
        launches += 1
    return Stages(
        out_f[:, 0:3], out_f[:, 3:6], out_f[:, 6:9], out_f[:, 9:12],
        out_f[:, 12:15], out_i[:, 0], out_i[:, 1] != 0, out_i[:, 2],
        out_i[:, 3],
    )


def trace_stages(table, anchor, k1, dx, ic_start, act, **kw):
    """Stages 2-4 of one RK iteration for every lane: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors (arguments as
    :func:`trace_plain`).  Returns :class:`Stages`."""
    if table.device.type == "cuda":
        return trace_cuda(table, anchor, k1, dx, ic_start, act, **kw)
    if table.device.type == "cpu":
        return trace_plain(table, anchor, k1, dx, ic_start, act, **kw)
    raise ValueError(f"no tracer kernel for device {table.device}")
