"""Kernel B3: the batched neighbor walk.

Counterpart of the JAX package's ``ops/pallas_walk.py``.  Every query
walks from ``r0`` (inside cell ``ic0``) towards ``r1``, along the unit
direction ``u`` for the length ``total`` (:func:`walk_direction`): each
round takes the exit face (least ray-plane distance among faces with
``u . n > 0``, the runner-up when the best leads straight back to the
previous cell), then arrives, leaves the domain or hops across with a
``nudge`` overshoot (m_interp_unstructured.f90:664-764).  A query stops
at arrival or at the boundary; one still walking after ``max_steps``
rounds gets ``STATUS_STEP_CAP``.  With a per-cell ``mask`` column (the
tracer's icell-mask region), a hop into a cell whose mask value differs
from the start cell's stops on the face with ``STATUS_MASK_CHANGED``, in
that cell (:706-719).

:func:`walk_rows` launches the CUDA kernel (``csrc/walk.cu``; float32,
or float64 for a float64 grid, whose entry points take double
tolerances) on CUDA tensors: from ``r0``, ``r1`` and ``ic0`` the kernel
computes each walk's direction and walks it to its end, one thread a
walk, in blocks sized by batch (:func:`walk_threads`).  On CPU tensors
it runs :func:`walk_rows_plain`, the plain PyTorch version:
:func:`walk_direction`, then :func:`walk_plain` (the round loop, rows
gathered per round).  ``launches`` counts kernel launches.  It serves
explicit walks: the public ``walk()``, masked walks and the tracer's
generic path.

:func:`get_cell_walk` is ``get_cell``'s whole walk stage, from the start
cells (or the seed bins) to (ic, found): origin, direction, the
two-phase walk and the found rule in one launch of
``get_cell_walk_kernel`` (``csrc/walk.cu``) on CUDA tensors, and
:func:`get_cell_walk_plain`, the composition of the plain pieces, on CPU
tensors.  ``get_cell_launches`` counts its launches.  While tracing
(``utils/timing.py``) it is span ``iu.locate.walk`` and counts
``walk.queries`` and ``walk.steps``, the steps of every walk over both
phases, which both versions sum on the device.

Walk rows (``models.grid._build_walk_table``) start with face normals
(nf*3, column f*3 + d) | face offsets (nf) | neighbor ids as floats
(nf); both versions read only those nf*5 columns.
"""

from __future__ import annotations

import torch

from . import _kernels, geometry
from ..utils import timing
from ..utils.config import huge_distance, tiny_distance

launches = 0  # launches of the explicit walk (walk_rows)
get_cell_launches = 0  # launches of get_cell's walk stage (get_cell_walk)

# the kernels' entry points by the rows' dtype: float32 rows take C float
# tolerances, a float64 grid's rows C doubles
_WALK_ENTRY = {torch.float32: "iu_walk", torch.float64: "iu_walk_f64"}
_GET_CELL_ENTRY = {torch.float32: "iu_get_cell_walk",
                   torch.float64: "iu_get_cell_walk_f64"}


def _entry(entries, what, *tensors):
    """The name of the entry point of ``entries`` for the dtype that every
    one of ``tensors`` has; raises for any other dtype, or for a mix."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in entries:
        raise TypeError(f"the CUDA {what} takes float32 or float64 tensors "
                        f"of one dtype, got {sorted(map(str, dtypes))}")
    return entries[dtypes.pop()]

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


# Threads a block of the explicit walk by batch size
# (tools/walk_rows_sweep.py on the 998k-tet box's walk rows and the trace
# table, H100, PERF.md §6): at 1024 walks a launch is one chain of
# dependent rounds per walk, and blocks of 32 spread the walks over 32
# SMs (0.0052 ms against 0.0056 at 128 and 0.0060 at 256 in float32,
# 0.0065 / 0.0071 / 0.0079 in float64); from 65,536 walks on the block
# size moves the time by 1% or less.
SMALL_WALKS = 1 << 16
SMALL_THREADS = 32
THREADS = 128


def walk_threads(n_walks):
    """Threads a block of the explicit walk's kernel for a batch of
    ``n_walks``."""
    return SMALL_THREADS if n_walks <= SMALL_WALKS else THREADS


def walk_rows_plain(table, r0, r1, ic0, nudge, eps_arrive, big, tiny,
                    max_steps, nf, mask=None):
    """Plain PyTorch version of :func:`walk_rows`: :func:`walk_direction`
    from r0 to r1, then :func:`walk_plain`, on any device and float
    dtype.  Returns (ic, r_p, steps, status)."""
    u, total, active = walk_direction(r0, r1, tiny)
    return walk_plain(table, r0, u, total, active, ic0, nudge, eps_arrive,
                      big, max_steps, nf, mask)


def walk_cuda(table, r0, r1, ic0, nudge, eps_arrive, big, tiny, max_steps,
              nf, mask=None, threads=None):
    """Launch B3's explicit walk on CUDA tensors: a float32 or float64
    table (16-byte aligned, a whole number of 16-byte words wide) with
    starts and targets of its dtype, int32 ``ic0`` and ``mask`` (None:
    no mask).  The kernel computes each walk's direction and walks it to
    its end, one thread a walk, in blocks of ``threads`` (None:
    :func:`walk_threads`)."""
    global launches
    b = r0.shape[0]
    if not (r0.shape == r1.shape == (b, 3) and ic0.shape == (b,)):
        raise ValueError("walk inputs must be r0, r1 (B, 3) and ic0 (B,)")
    entry = _entry(_WALK_ENTRY, "walk kernel", table, r0, r1)
    if ic0.dtype != torch.int32:
        raise TypeError("ic0 must be int32")
    if len({t.device for t in (table, r0, r1, ic0)}) != 1:
        raise ValueError("walk inputs must share one device")
    if (table.ndim != 2 or not table.is_contiguous() or table.shape[0] < 1
            or table.shape[1] * table.element_size() % 16
            or not _aligned(table)):
        raise ValueError(
            "table must be a contiguous, non-empty (n, W) tensor with "
            "16-byte aligned rows"
        )
    if nf not in (3, 4) or table.shape[1] < 5 * nf:
        raise ValueError(f"rows of width {table.shape[1]} hold no nf={nf} faces")
    if mask is not None:
        if (mask.dtype != torch.int32 or mask.shape != (table.shape[0],)
                or mask.device != table.device):
            raise ValueError("mask must be an int32 (n_rows,) tensor on the "
                             "table's device")
        mask = mask.contiguous()
    threads = walk_threads(b) if threads is None else threads
    if threads % 32 or not 32 <= threads <= 256:
        raise ValueError(f"threads must be a multiple of 32 up to 256, got "
                         f"{threads}")
    r0, r1, ic0 = r0.contiguous(), r1.contiguous(), ic0.contiguous()
    dev = table.device
    out_ic = torch.empty(b, dtype=torch.int32, device=dev)
    out_rp = torch.empty((b, 3), dtype=table.dtype, device=dev)
    out_steps = torch.empty(b, dtype=torch.int32, device=dev)
    out_status = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return out_ic, out_rp, out_steps, out_status
    with torch.cuda.device(dev):
        code = getattr(_kernels.lib(), entry)(
            table.data_ptr(), table.shape[0], table.shape[1], nf,
            r0.data_ptr(), r1.data_ptr(), ic0.data_ptr(),
            None if mask is None else mask.data_ptr(), b, float(nudge),
            float(eps_arrive), float(big), float(tiny), int(max_steps),
            threads, out_ic.data_ptr(), out_rp.data_ptr(),
            out_steps.data_ptr(), out_status.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _kernels.check(code, entry)
    launches += 1
    return out_ic, out_rp, out_steps, out_status


def walk_rows(table, r0, r1, ic0, nudge, eps_arrive, big, tiny, max_steps,
              nf, mask=None):
    """The batched walk from r0 towards r1: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Returns (ic, r_p, steps,
    status)."""
    if table.device.type == "cuda":
        return walk_cuda(table, r0, r1, ic0, nudge, eps_arrive, big, tiny,
                         max_steps, nf, mask)
    if table.device.type == "cpu":
        return walk_rows_plain(table, r0, r1, ic0, nudge, eps_arrive, big,
                               tiny, max_steps, nf, mask)
    raise ValueError(f"no walk for device {table.device}")


def seed_bins(grid, r):
    """Flat seed-bin index (B,) int64 of (B, 3) queries on the grid's
    seed bins (``bin_table`` and ``bin_pack`` rows)."""
    ijk = geometry.bin_ijk(r, grid.bin_rmin, grid.bin_inv_h, grid.bin_shape,
                           torch.int64)
    return geometry.bin_flat(ijk, grid.bin_shape)


def walk_origin(table, starts, nf, npc):
    """Cell centers of ``starts`` (walk origins), from the vertex block of
    the walk rows (columns [nf*5, nf*5 + npc*3)), summed in vertex order
    and divided by a tensor, so that CUDA tensors divide as the CPU and
    the kernel do (torch multiplies a CUDA tensor by the reciprocal of a
    Python scalar divisor)."""
    cp = table[starts.long(), nf * 5: nf * 5 + npc * 3].reshape(-1, npc, 3)
    acc = cp[:, 0]
    for k in range(1, npc):
        acc = acc + cp[:, k]
    return acc / torch.full_like(acc, npc)


def walk_direction(r0, r1, tiny):
    """(u, total, active) of walks from r0 to r1: unit directions,
    lengths ``sqrt((x*x + y*y) + z*z)``, and which walks move (the
    degenerate ones, shorter than ``tiny``, stay put)."""
    delta = r1 - r0
    total = torch.sqrt(
        (delta[:, 0] * delta[:, 0] + delta[:, 1] * delta[:, 1])
        + delta[:, 2] * delta[:, 2]
    )
    degenerate = total < tiny
    u = delta / torch.where(degenerate, 1.0, total)[:, None]
    return u, total, ~degenerate


def _tolerances(grid):
    """(nudge, eps_arrive, big, tiny) of the grid's walks, in its dtype:
    the tolerances it holds (``Grid.walk_tol``), read from no tensor."""
    np_dtype = torch.empty((), dtype=grid.dtype).numpy().dtype
    nudge, eps_arrive = grid.walk_tol
    return nudge, eps_arrive, huge_distance(np_dtype), tiny_distance(np_dtype)


def _resume_plain(grid, r_p, r1, ic, max_steps):
    """Phase 2 of the plain get_cell walk: the stragglers walk again from
    where they stopped (direction and distance from ``r_p``, no previous
    cell).  Returns (ic, steps, status)."""
    nudge, eps_arrive, big, tiny = _tolerances(grid)
    u, total, active = walk_direction(r_p, r1, tiny)
    ic_o, _, steps_o, st_o = walk_plain(grid.walk_table, r_p, u, total,
                                        active, ic, nudge, eps_arrive, big,
                                        max_steps, grid.n_faces_per_cell)
    return ic_o, steps_o, st_o


def get_cell_walk_plain(grid, r, start, max_steps, p1, step_count=None):
    """Plain PyTorch version of :func:`get_cell_walk`: the composition the
    port ran before the fused kernel (seed rows or start-cell centers,
    :func:`walk_direction`, :func:`walk_plain`, the two-phase merge), on
    any device and float dtype.  ``step_count``: None, or an int64
    tensor of one element that gets the steps of every walk added."""
    table = grid.walk_table
    n_rows = table.shape[0]
    nf = grid.n_faces_per_cell
    nudge, eps_arrive, big, tiny = _tolerances(grid)
    if start is None:
        g = grid.bin_pack[seed_bins(grid, r)]
        start, r0 = g[:, 0].to(torch.int32), g[:, 1:4]
    else:
        if grid.bin_table is not None:
            # out-of-range start cells (guesses) reseed from the bin table
            bad = (start < 0) | (start >= n_rows)
            start = torch.where(bad, grid.bin_table[seed_bins(grid, r)], start)
        r0 = walk_origin(table, start.clamp(0, n_rows - 1), nf,
                         grid.n_points_per_cell)
    u, total, active = walk_direction(r0, r, tiny)
    ic, rp, steps, status = walk_plain(table, r0, u, total, active, start,
                                       nudge, eps_arrive, big,
                                       p1 if p1 > 0 else max_steps, nf)
    found = (status == STATUS_ARRIVED) & (ic >= 0)
    if step_count is not None:
        step_count += steps.sum()
    if p1 > 0:
        sel = torch.nonzero(status == STATUS_STEP_CAP).squeeze(1)
        if sel.numel():
            ic_o, steps_o, st_o = _resume_plain(grid, rp[sel], r[sel],
                                                ic[sel], max_steps - p1)
            ic[sel] = ic_o
            found[sel] = (st_o == STATUS_ARRIVED) & (ic_o >= 0)
            if step_count is not None:
                step_count += steps_o.sum()
    return torch.where(found, ic, torch.clamp_max(ic, -1)), found


def _aligned(t):
    return t.data_ptr() % 16 == 0


def get_cell_walk_cuda(grid, r, start, max_steps, p1, step_count=None):
    """Launch ``get_cell_walk_kernel`` on CUDA tensors: float32 or float64
    walk rows (16-byte aligned, a whole number of 16-byte words wide),
    with queries, seed rows and bin grid of their dtype, and int32 start
    cells or None.  One thread per query, from its origin to (ic,
    found).  ``step_count``: None, or an int64 tensor of one element on
    the rows' device that gets the steps of every walk added (a sum a
    warp, one atomic add a warp); the outputs do not change."""
    global get_cell_launches
    table = grid.walk_table
    nf, npc = grid.n_faces_per_cell, grid.n_points_per_cell
    entry = _entry(_GET_CELL_ENTRY, "get_cell walk", table, r, grid.bin_rmin,
                   grid.bin_inv_h)
    b = r.shape[0]
    if r.ndim != 2 or r.shape[1] != 3:
        raise ValueError(f"queries must be (B, 3), got {tuple(r.shape)}")
    if start is not None and (start.dtype != torch.int32
                              or start.shape != (b,)):
        raise ValueError("start must be an int32 (B,) tensor or None")
    tensors = [table, r, grid.bin_rmin, grid.bin_inv_h]
    tensors += [t for t in (start, grid.bin_pack, grid.bin_table)
                if t is not None]
    if step_count is not None:
        if (step_count.dtype != torch.int64 or step_count.numel() != 1
                or not step_count.is_contiguous()):
            raise ValueError("step_count must be a contiguous int64 tensor "
                             "of one element")
        tensors.append(step_count)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("get_cell walk inputs must share one device")
    if (table.ndim != 2 or not table.is_contiguous() or table.shape[0] < 1
            or table.shape[1] * table.element_size() % 16
            or not _aligned(table)):
        raise ValueError(
            "walk rows must be a contiguous, non-empty (n, W) tensor with "
            "16-byte aligned rows"
        )
    if nf not in (3, 4) or npc != nf or table.shape[1] < 8 * nf:
        raise ValueError(f"rows of width {table.shape[1]} hold no nf={nf} "
                         f"faces and npc={npc} vertices")
    if start is None:
        pack = grid.bin_pack
        if (pack is None or pack.dtype != table.dtype
                or pack.shape[1:] != (4,) or not pack.is_contiguous()
                or not _aligned(pack)):
            raise ValueError("a cold start needs a contiguous, 16-byte "
                             "aligned (n_bins, 4) bin_pack of the walk "
                             "rows' dtype")
    bin_table = grid.bin_table
    if bin_table is not None:
        if bin_table.dtype != torch.int32:
            raise TypeError("bin_table must be int32")
        bin_table = bin_table.contiguous()
    for t in (grid.bin_rmin, grid.bin_inv_h):
        if t.shape != (3,):
            raise ValueError("bin_rmin and bin_inv_h must be (3,)")
    rmin, inv_h = grid.bin_rmin.contiguous(), grid.bin_inv_h.contiguous()
    r = r.contiguous()
    if start is not None:
        start = start.contiguous()
    dev = table.device
    out_ic = torch.empty(b, dtype=torch.int32, device=dev)
    out_found = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return out_ic, out_found
    nudge, eps_arrive, big, tiny = _tolerances(grid)
    nbx, nby, nbz = grid.bin_shape

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        code = getattr(_kernels.lib(), entry)(
            table.data_ptr(), table.shape[0], table.shape[1], nf,
            r.data_ptr(), ptr(start),
            ptr(grid.bin_pack if start is None else None), ptr(bin_table),
            rmin.data_ptr(), inv_h.data_ptr(), nbx, nby, nbz, b,
            float(nudge), float(eps_arrive), float(big), float(tiny),
            int(max_steps), int(p1), out_ic.data_ptr(), out_found.data_ptr(),
            ptr(step_count), torch.cuda.current_stream(dev).cuda_stream,
        )
    _kernels.check(code, entry)
    get_cell_launches += 1
    return out_ic, out_found


@timing.spanned("iu.locate.walk")
def get_cell_walk(grid, r, start, max_steps, p1):
    """``get_cell``'s walk stage on a walk grid: (i_cell, found) of the
    (B, 3) queries ``r``.

    Args:
      start: (B,) int32 start cells, or None for a pure cold start
        (start cell and origin from the query's ``bin_pack`` row).
        Start cells outside [0, n_cells) take the query's seed from
        ``bin_table`` (get_cell's rule for out-of-range guesses); a
        start cell's walk leaves from its center.
      max_steps: the step cap of the whole walk.
      p1: rounds of phase 1; a query still walking after them restarts
        from where it stopped, for at most ``max_steps - p1`` more
        rounds.  0: one phase of ``max_steps`` rounds.
    Returns (i_cell (B,) int32, found (B,) bool) with get_cell's
    contract: where not found, i_cell is -1 or the boundary code.

    The kernel on CUDA tensors, the plain version on CPU tensors.
    """
    dev = grid.walk_table.device
    steps = None
    if timing.tracing():
        steps = torch.zeros((), dtype=torch.int64, device=dev)
        timing.metrics.count("walk.queries", r.shape[0])
        timing.metrics.count("walk.steps", steps)
    if dev.type == "cuda":
        return get_cell_walk_cuda(grid, r, start, max_steps, p1, steps)
    if dev.type == "cpu":
        return get_cell_walk_plain(grid, r, start, max_steps, p1, steps)
    raise ValueError(f"no get_cell walk for device {grid.walk_table.device}")
