"""Kernel E1: interpolation at known cells on the card.

The CUDA body of ``interpolate_at_icell`` (``ops/interp.py``), which
the JAX package runs in XLA (its ``ops/interp.py:177``; no Pallas
counterpart).  For each query: its cell clamped to ``[0, n_cells)`` (a
memory guard: the plain version reads cell 0 for a negative id too,
but raises for one of ``n_cells`` or more), the cell's vertex ids from
``grid.cells`` and its volume from ``grid.cell_volume``, each vertex's
coordinates from ``grid.points``, the tri / tet / quad weights of
``csrc/wkern.cuh``, and the weighted sum of the requested point-data
columns at the cell's vertices (m_interp_unstructured.f90:497-527).
Those tables fit in the card's L2 on the meshes the smoke runs; the
walk rows are not read, so a grid without them answers too.  Nothing
is assembled per call.

:func:`interpolate_at_icell_cuda` launches the kernel
(``csrc/interp_icell.cu``, for a float32 grid or, through its double
entry point, a float64 one); ``ops/interp.interpolate_at_icell_plain``
is its plain PyTorch version, which ``interpolate_at_icell`` runs for a
CPU grid.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _kernels
from .interp_kernel import _var_columns

launches = 0

_CELL_TYPE_CODE = {"triangle": 0, "quad": 1, "tetra": 2}
_ENTRY = {torch.float32: "iu_interp_icell",
          torch.float64: "iu_interp_icell_f64"}


def interpolate_at_icell_cuda(grid, r, slots, ic):
    """Launch E1 on a CUDA grid: (B, 3) queries of the grid's dtype on
    its device, point-data columns ``slots`` (negative ones wrap as
    ``point_data[:, slots]`` wraps them; one outside the columns
    raises), (B,) cells (int32 or int64, a tensor or an array; not
    validated: a negative one reads cell 0, one of ``n_cells`` or more
    the last cell, where the plain version raises).  Reads
    ``grid.point_data``, ``grid.points``, ``grid.cells`` and
    ``grid.cell_volume`` as the grid holds them at the call: each must be
    contiguous, of the grid's dtype (``cells`` int32, starting on a
    16-byte boundary), or the call raises; nothing is copied.  Returns
    (B, V) values."""
    global launches
    if not (grid.device.type == "cuda" and grid.dtype in _ENTRY
            and grid.cell_type in _CELL_TYPE_CODE
            and isinstance(r, torch.Tensor) and r.dtype == grid.dtype
            and r.device == grid.device):
        raise TypeError(
            "the CUDA known-cell kernel takes float32 or float64 "
            "triangle, quad or tetra grids on a CUDA device with queries "
            f"of their dtype there, got a {grid.dtype} {grid.cell_type} "
            f"grid on {grid.device}, queries "
            + (f"{r.dtype} on {r.device}" if isinstance(r, torch.Tensor)
               else type(r).__name__)
        )
    if r.ndim != 2 or r.shape[1] != 3:
        raise ValueError(f"queries must be (B, 3), got {tuple(r.shape)}")
    cols = _var_columns(grid, slots)
    ic = torch.as_tensor(ic, device=grid.device)
    if ic.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"cells must be int32 or int64, got {ic.dtype}")
    b = r.shape[0]
    if ic.shape != (b,):
        raise ValueError(f"cells must be ({b},), got {tuple(ic.shape)}")
    pd = grid.point_data
    if not pd.is_contiguous():
        raise ValueError("grid.point_data must be contiguous: the kernel "
                         "reads the tensor the grid holds")
    for name, want in (("points", grid.dtype), ("cells", torch.int32),
                       ("cell_volume", grid.dtype)):
        t = getattr(grid, name)
        if t.dtype != want or not t.is_contiguous():
            raise TypeError(f"grid.{name} must be a contiguous {want} "
                            "tensor: the kernel reads the tensor the grid "
                            "holds")
    if grid.points.shape[1] != 3 or grid.cells.data_ptr() % 16:
        raise ValueError("the kernel reads (P, 3) points and cells that "
                         "start on a 16-byte boundary")
    vals = torch.empty((b, len(cols)), dtype=grid.dtype, device=grid.device)
    if b == 0 or not cols:
        return vals
    ic = ic.to(torch.int32).contiguous()
    r = r.contiguous()
    item = vals.element_size()
    fn = getattr(_kernels.lib(), _ENTRY[grid.dtype])
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        for g, sl, n in _kernels.var_slot_groups(cols):
            code = fn(
                grid.points.data_ptr(), grid.cells.data_ptr(),
                grid.cell_volume.data_ptr(), grid.n_cells,
                _CELL_TYPE_CODE[grid.cell_type], pd.data_ptr(), pd.stride(0),
                sl, n, r.data_ptr(), ic.data_ptr(), b,
                vals.data_ptr() + item * g, len(cols), stream,
            )
            _kernels.check(code, _ENTRY[grid.dtype])
            launches += 1
    return vals
