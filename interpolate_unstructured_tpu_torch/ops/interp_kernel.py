"""Kernel B1: brute-force fused locate + interpolate for small meshes.

Counterpart of the JAX package's ``ops/pallas_interp.py``.  For each
query: the margin ``min_f (d_f - n_f . r)`` against every cell, the
most interior cell by first-occurrence argmax, ``found = max >= -eps``,
then the winner's tri/tet/quad weights contracted with its vertex
values (m_interp_unstructured.f90:412-527).

:func:`interpolate_bruteforce` launches the CUDA kernel
(``csrc/interp_bruteforce.cu``, for a float32 grid or, through its
double entry point, a float64 one) on CUDA tensors and runs
:func:`interpolate_bruteforce_plain`, the plain PyTorch version, on CPU
tensors.  ``launches`` counts kernel launches.  The kernel reads the
grid's own tensors (face planes, winner geometry, point data), so a
launch builds nothing but its outputs.
"""

from __future__ import annotations

import torch

from . import _kernels, locate
from .interp import _static_slots, _weights_from_geometry

launches = 0

# Queries a thread and threads a block of the kernel, from the sweep of
# tools/b1_b5_sweep.py on the smoke's three meshes (PERF.md §6).  The
# double kernel takes 4 queries a thread: at 8 its 512 threads a block
# cap it at 128 registers and it spills (nvcc -Xptxas -v on sm_90a).
QUERIES_PER_THREAD = 8
QUERIES_PER_THREAD_F64 = 4
THREADS = 512

_CELL_TYPE_CODE = {"triangle": 0, "quad": 1, "tetra": 2}
# the kernel's entry point by the grid's dtype (a float64 grid's takes a
# C double eps)
_ENTRY = {torch.float32: "iu_interp_bruteforce",
          torch.float64: "iu_interp_bruteforce_f64"}


def _payload(grid, i_vars):
    """(C, npc*3 + 1 + npc*V) winner payload per cell of the plain
    version: vertex coords | volume | vertex values (vertex-major,
    ``k*V + v``)."""
    n_cells = grid.n_cells
    npc = grid.n_points_per_cell
    pd_cell = grid.point_data[:, i_vars][grid.cells.long()]  # (C, npc, V)
    return torch.cat(
        [
            grid.cell_points.reshape(n_cells, npc * 3),
            grid.cell_volume[:, None],
            pd_cell.reshape(n_cells, npc * i_vars.shape[0]),
        ],
        dim=1,
    ).contiguous()


def interpolate_bruteforce_plain(grid, r, i_vars):
    """Plain PyTorch version of B1 (model: the JAX package's
    ``ops/interp._interpolate_bruteforce``), on any device and float
    dtype.  Tiled over the batch so the (tile, C, nf) margins stay
    bounded.  Returns (values (B, V), i_cell (B,) int32, found (B,))."""
    i_vars = torch.as_tensor(i_vars, dtype=torch.long, device=grid.device)
    payload = _payload(grid, i_vars)
    npc = grid.n_points_per_cell
    n_vars = i_vars.shape[0]
    neg_eps = torch.tensor(-grid.config.eps_inside, dtype=grid.dtype,
                           device=grid.device)
    b = r.shape[0]
    tile = max(1024, (1 << 26) // max(grid.face_offsets.numel(), 1))
    vals, ics, founds = [], [], []
    for lo in range(0, b, tile):
        rt = r[lo: lo + tile]
        m = locate._containment_margins(grid, rt)  # (tile, C)
        best = torch.argmax(m, dim=1)  # first occurrence of the max
        found = m.gather(1, best[:, None])[:, 0] >= neg_eps
        g = payload[best]
        cp = g[:, : npc * 3].reshape(-1, npc, 3)
        vol = g[:, npc * 3]
        vv = g[:, npc * 3 + 1:].reshape(-1, npc, n_vars)
        w = _weights_from_geometry(grid.cell_type, cp, vol, rt)
        acc = w[:, 0, None] * vv[:, 0]
        for k in range(1, npc):
            acc = acc + w[:, k, None] * vv[:, k]
        vals.append(acc)
        ics.append(torch.where(found, best, -1).to(torch.int32))
        founds.append(found)
    if not vals:
        return (
            r.new_zeros((0, n_vars)),
            torch.zeros(0, dtype=torch.int32, device=r.device),
            torch.zeros(0, dtype=torch.bool, device=r.device),
        )
    return torch.cat(vals), torch.cat(ics), torch.cat(founds)


def _var_columns(grid, i_vars):
    """``i_vars`` as point_data columns, negative ones wrapped as torch
    indexing wraps them."""
    width = grid.point_data.shape[1]
    cols = []
    for v in _static_slots(i_vars):
        if not -width <= v < width:
            raise IndexError(f"variable {v} outside point_data's {width} "
                             "columns")
        cols.append(v % width)
    return cols


def interpolate_bruteforce_cuda(grid, r, i_vars, *, q=None, threads=THREADS):
    """Launch B1 on CUDA tensors (a float32 or float64 grid, queries of
    its dtype).  ``q`` and ``threads`` are the kernel's queries a thread
    and threads a block, for the sweep; callers keep the defaults (``q``
    None: QUERIES_PER_THREAD, or QUERIES_PER_THREAD_F64 for a float64
    grid)."""
    global launches
    if grid.dtype not in _ENTRY or r.dtype != grid.dtype:
        raise TypeError(
            "the CUDA brute-force kernel takes float32 or float64 grids "
            f"with queries of their dtype, got {grid.dtype} / {r.dtype}"
        )
    if r.device != grid.device:
        raise ValueError(f"queries on {r.device}, grid on {grid.device}")
    if r.ndim != 2 or r.shape[1] != 3:
        raise ValueError(f"queries must be (B, 3), got {tuple(r.shape)}")
    if grid.cells.dtype != torch.int32:
        raise TypeError(f"grid cells must be int32, got {grid.cells.dtype}")
    cols = _var_columns(grid, i_vars)
    if q is None:
        q = (QUERIES_PER_THREAD if grid.dtype == torch.float32
             else QUERIES_PER_THREAD_F64)
    r = r.contiguous()
    normals, offsets, cell_points, volume, cells = (
        t.contiguous() for t in (grid.face_normals, grid.face_offsets,
                                 grid.cell_points, grid.cell_volume,
                                 grid.cells))
    pd = grid.point_data
    if pd.stride(1) != 1:
        pd = pd.contiguous()
    b, n_vars = r.shape[0], len(cols)
    vals = torch.empty((b, n_vars), dtype=grid.dtype, device=r.device)
    ic = torch.empty(b, dtype=torch.int32, device=r.device)
    found = torch.empty(b, dtype=torch.bool, device=r.device)
    if b == 0:
        return vals, ic, found
    fn = getattr(_kernels.lib(), _ENTRY[grid.dtype])
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        for g, slots, n in _kernels.var_slot_groups(cols):
            code = fn(
                normals.data_ptr(), offsets.data_ptr(),
                cell_points.data_ptr(), volume.data_ptr(), cells.data_ptr(),
                pd.data_ptr(), pd.stride(0), slots, n, r.data_ptr(), b,
                grid.n_cells, _CELL_TYPE_CODE[grid.cell_type],
                float(grid.config.eps_inside),
                vals.data_ptr() + vals.element_size() * g,
                n_vars, ic.data_ptr(), found.data_ptr(), q, threads, stream,
            )
            _kernels.check(code, "iu_interp_bruteforce")
            launches += 1
    return vals, ic, found


def interpolate_bruteforce(grid, r, i_vars):
    """Fused locate + interpolate on a brute-force grid: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.  Returns
    (values (B, V), i_cell (B,) int32 with -1 on a miss, found (B,))."""
    if r.device.type == "cuda":
        return interpolate_bruteforce_cuda(grid, r, i_vars)
    if r.device.type == "cpu":
        return interpolate_bruteforce_plain(grid, r, i_vars)
    raise ValueError(f"no brute-force path for device {r.device}")
