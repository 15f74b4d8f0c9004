"""Kernel B3: the batched neighbor walk.

Counterpart of the JAX package's ``ops/pallas_walk.py``.  Every query
walks from ``r0`` (inside cell ``ic0``) along the unit direction ``u``
for ``total``: each round takes the exit face (least ray-plane distance
among faces with ``u . n > 0``, the runner-up when the best leads
straight back to the previous cell), then arrives, leaves the domain or
hops across with a ``nudge`` overshoot (m_interp_unstructured.f90:
664-764).  A query stops at arrival or at the boundary; one still
walking after ``max_steps`` rounds gets ``STATUS_STEP_CAP``.  With a
per-cell ``mask`` column (the tracer's icell-mask region), a hop into a
cell whose mask value differs from the start cell's stops on the face
with ``STATUS_MASK_CHANGED``, in that cell (:706-719).

:func:`walk_rows` launches the CUDA kernel (``csrc/walk.cu``, one thread
per query walking to its end) on CUDA tensors and runs
:func:`walk_plain`, the plain PyTorch version (the round loop, rows
gathered per round), on CPU tensors.  ``launches`` counts kernel
launches.

Walk rows (``models.grid._build_walk_table``) start with face normals
(nf*3, column f*3 + d) | face offsets (nf) | neighbor ids as floats
(nf); both versions read only those nf*5 columns.
"""

from __future__ import annotations

import torch

from . import _kernels

launches = 0

STATUS_ARRIVED = 0
STATUS_BOUNDARY = -1
STATUS_MASK_CHANGED = 1
STATUS_STEP_CAP = 2


def _face_round(g, nf, u, p, prev, big):
    """Exit face of each lane from gathered rows g (n, >= nf*5): two-best
    tracking with strict <, each sum of three products as (x + y) + z
    (csrc/walk.cuh:face_round).  Returns (face_dist >= 0, ic_next, hit)."""
    d1 = torch.full_like(p[:, 0], big)
    d2 = d1.clone()
    n1 = torch.full_like(prev, -1)
    n2 = n1.clone()
    for f in range(nf):
        nx, ny, nz = g[:, 3 * f], g[:, 3 * f + 1], g[:, 3 * f + 2]
        off = g[:, 3 * nf + f]
        nbr = g[:, 4 * nf + f].to(torch.int32)
        pdn = (nx * u[:, 0] + ny * u[:, 1]) + nz * u[:, 2]
        rpn = (nx * p[:, 0] + ny * p[:, 1]) + nz * p[:, 2]
        dist = torch.where(pdn > 0, (off - rpn) / pdn, big)
        better1 = dist < d1
        better2 = ~better1 & (dist < d2)
        d2 = torch.where(better1, d1, torch.where(better2, dist, d2))
        n2 = torch.where(better1, n1, torch.where(better2, nbr, n2))
        d1 = torch.where(better1, dist, d1)
        n1 = torch.where(better1, nbr, n1)
    backtrack = (n1 == prev) & (prev >= 0)
    face_dist = torch.where(backtrack, d2, d1)
    ic_next = torch.where(backtrack, n2, n1)
    hit = face_dist < 0.5 * big
    face_dist = torch.where(face_dist < 0, 0.0, face_dist)
    return face_dist, ic_next, hit


def walk_plain(table, r0, u, total, active, ic0, nudge, eps_arrive, big,
               max_steps, nf, mask=None):
    """Plain PyTorch version of B3 (model: the round body of the JAX
    package's ``ops/pallas_walk._kernel`` looped as ``_walk_pallas``
    loops it), on any device and float dtype.  Each round works on the
    still-active lanes only (``torch.nonzero``) and gathers their rows;
    a lane's result does not depend on the others.

    Args:
      table: (n_rows, W) walk rows.
      r0, u: (B, 3) start positions and unit directions.
      total: (B,) distance to walk.
      active: (B,) bool, the lanes that walk (the others keep r0/ic0).
      ic0: (B,) int32 start cells.
      nudge, eps_arrive, big: walk tolerances and the no-hit distance.
      mask: optional (n_rows,) int32 per-cell mask values; None walks
        without one.
    Returns (ic (B,) int32, r_p (B, 3), steps (B,) int32, status (B,)
    int32), ``ops.locate.walk``'s contract.
    """
    b = r0.shape[0]
    dev = r0.device
    rp = r0.clone()
    dist_left = total.clone()
    ic = ic0.to(torch.int32).clone()
    prev = torch.full((b,), -1, dtype=torch.int32, device=dev)
    status = torch.zeros(b, dtype=torch.int32, device=dev)
    steps = torch.zeros(b, dtype=torch.int32, device=dev)
    nudge_t = torch.tensor(nudge, dtype=r0.dtype, device=dev)
    zero = torch.zeros((), dtype=r0.dtype, device=dev)
    lanes = torch.nonzero(active).squeeze(1)
    n_rows = table.shape[0]
    if mask is not None:
        mask0 = mask[ic.clamp(0, n_rows - 1).long()]
    for _ in range(max_steps):
        if lanes.numel() == 0:
            break
        ic_a = ic[lanes]
        g = table[ic_a.clamp(0, n_rows - 1).long(), : 5 * nf]
        p, ua, prev_a = rp[lanes], u[lanes], prev[lanes]
        face_dist, ic_next, hit = _face_round(g, nf, ua, p, prev_a, big)
        dl = dist_left[lanes]
        crossing = hit & (dl - face_dist > eps_arrive)
        out_of_domain = ic_next < 0
        continuing = crossing & ~out_of_domain
        st = torch.where(crossing & out_of_domain, STATUS_BOUNDARY,
                         STATUS_ARRIVED)
        if mask is not None:
            changed = continuing & (
                mask[ic_next.clamp_min(0).long()] != mask0[lanes])
            continuing = continuing & ~changed
            st = torch.where(changed, STATUS_MASK_CHANGED, st)
        advance = face_dist + torch.where(continuing, nudge_t, zero)
        rp[lanes] = torch.where(hit[:, None], p + advance[:, None] * ua, p)
        dist_left[lanes] = torch.where(hit, dl - advance, dl)
        status[lanes] = st.to(torch.int32)
        prev[lanes] = torch.where(continuing, ic_a, prev_a)
        ic[lanes] = torch.where(crossing, ic_next, ic_a)
        steps[lanes] += 1
        lanes = lanes[continuing]
    status[lanes] = STATUS_STEP_CAP
    return ic, rp, steps, status


def walk_cuda(table, r0, u, total, active, ic0, nudge, eps_arrive, big,
              max_steps, nf, mask=None):
    """Launch B3 on CUDA tensors: float32 table and positions, bool
    ``active``, int32 ``ic0`` and ``mask`` (None: no mask).  One thread
    per query walks to its end."""
    global launches
    if table.dtype != torch.float32 or r0.dtype != torch.float32:
        raise TypeError(
            "the CUDA walk kernel takes float32 tables and positions, "
            f"got {table.dtype} / {r0.dtype}"
        )
    b = r0.shape[0]
    if not (r0.shape == u.shape == (b, 3) and total.shape == active.shape
            == ic0.shape == (b,)):
        raise ValueError(
            "walk inputs must be r0, u (B, 3) and total, active, ic0 (B,)"
        )
    if u.dtype != torch.float32 or total.dtype != torch.float32:
        raise TypeError("u and total must be float32")
    if active.dtype != torch.bool or ic0.dtype != torch.int32:
        raise TypeError("active must be bool and ic0 int32")
    if len({t.device for t in (table, r0, u, total, active, ic0)}) != 1:
        raise ValueError("walk inputs must share one device")
    if table.ndim != 2 or not table.is_contiguous() or table.shape[0] < 1:
        raise ValueError("table must be a contiguous, non-empty (n, W) tensor")
    if nf not in (3, 4) or table.shape[1] < 5 * nf:
        raise ValueError(f"rows of width {table.shape[1]} hold no nf={nf} faces")
    if mask is not None:
        if (mask.dtype != torch.int32 or mask.shape != (table.shape[0],)
                or mask.device != table.device):
            raise ValueError("mask must be an int32 (n_rows,) tensor on the "
                             "table's device")
        mask = mask.contiguous()
    r0, u, total = r0.contiguous(), u.contiguous(), total.contiguous()
    active, ic0 = active.contiguous(), ic0.contiguous()
    dev = table.device
    out_ic = torch.empty(b, dtype=torch.int32, device=dev)
    out_rp = torch.empty((b, 3), dtype=torch.float32, device=dev)
    out_steps = torch.empty(b, dtype=torch.int32, device=dev)
    out_status = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return out_ic, out_rp, out_steps, out_status
    with torch.cuda.device(dev):
        code = _kernels.lib().iu_walk(
            table.data_ptr(), table.shape[0], table.shape[1], nf,
            r0.data_ptr(), u.data_ptr(), total.data_ptr(), active.data_ptr(),
            ic0.data_ptr(), None if mask is None else mask.data_ptr(), b,
            float(nudge), float(eps_arrive), float(big),
            int(max_steps), out_ic.data_ptr(), out_rp.data_ptr(),
            out_steps.data_ptr(), out_status.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "iu_walk")
    launches += 1
    return out_ic, out_rp, out_steps, out_status


def walk_rows(table, r0, u, total, active, ic0, nudge, eps_arrive, big,
              max_steps, nf, mask=None):
    """The batched walk: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns (ic, r_p, steps, status)."""
    if table.device.type == "cuda":
        return walk_cuda(table, r0, u, total, active, ic0, nudge, eps_arrive,
                         big, max_steps, nf, mask)
    if table.device.type == "cpu":
        return walk_plain(table, r0, u, total, active, ic0, nudge,
                          eps_arrive, big, max_steps, nf, mask)
    raise ValueError(f"no walk for device {table.device}")
