"""Kernel B5: df32 interpolation at known cells (accurate mode).

Counterpart of the JAX package's ``ops/pallas_acc.py``.  For each query
the row of its cell in the acc table (``ops/interp_acc.py``: the float64
vertex coordinates and vertex data as hi/lo float32 pairs), the tri /
tet / quad weights in df32 (``ops/wkern.py``, ``DF`` trait), simplex
weights normalized by their df32 sum, and the df32 contraction with the
requested variables (m_interp_unstructured.f90:529-641).

:func:`interp_acc` launches the CUDA kernel (``csrc/interp_acc.cu``) on
CUDA tensors and runs :func:`interp_acc_plain`, the plain PyTorch
version, on CPU tensors.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _kernels, df32, wkern

launches = 0

# Threads a block of the kernel, from the sweep of tools/b1_b5_sweep.py
# (PERF.md §6)
THREADS = 128

_CELL_TYPE_CODE = {"triangle": 0, "quad": 1, "tetra": 2}
_CHUNK = 1 << 20  # queries per block of the plain version


def _acc_tile(g, r_hi, r_lo, cell_type, npc, nv, slots):
    """df32 values of gathered rows g (b, used) — the JAX package's
    ``interp_acc._interp_acc_tile``, operation for operation."""

    def col(j):
        return g[:, j]

    q = [(r_hi[:, d], r_lo[:, d]) for d in range(3)]
    v = [
        [(col(vtx * 3 + d), col(npc * 3 + vtx * 3 + d)) for d in range(3)]
        for vtx in range(npc)
    ]
    ar = wkern.DF()
    if cell_type == "triangle":
        w = wkern.triangle_areas2(v, q, ar)
    elif cell_type == "tetra":
        w = wkern.tetra_triples(v, q, ar)
    else:
        w = wkern.quad_weights_generic(v, q, ar)
    if cell_type in ("triangle", "tetra"):
        tot = w[0]
        for k in range(1, npc):
            tot = df32.add(tot, w[k])
        w = [df32.div(wk, tot) for wk in w]

    d0 = npc * 6
    outs_h, outs_l = [], []
    for slot in slots:
        acc = None
        for vtx in range(npc):
            dhi = col(d0 + slot * npc + vtx)
            dlo = col(d0 + nv * npc + slot * npc + vtx)
            term = df32.mul(w[vtx], (dhi, dlo))
            acc = term if acc is None else df32.add(acc, term)
        outs_h.append(acc[0])
        outs_l.append(acc[1])
    b = g.shape[0]
    if not slots:
        z = g.new_zeros((b, 0))
        return z, z
    return torch.stack(outs_h, dim=1), torch.stack(outs_l, dim=1)


def interp_acc_plain(table, ic, r_hi, r_lo, cell_type, npc, nv, slots):
    """Plain PyTorch version of B5, on any device: rows of ``table``
    read at ``max(ic, 0)``, ``_CHUNK`` queries at a time.  Returns
    (vals_hi (B, V), vals_lo (B, V))."""
    used = npc * 6 + 2 * nv * npc
    his, los = [], []
    for lo in range(0, ic.shape[0], _CHUNK):
        g = table[ic[lo: lo + _CHUNK].clamp_min(0).long(), :used]
        h, l_ = _acc_tile(g, r_hi[lo: lo + _CHUNK], r_lo[lo: lo + _CHUNK],
                          cell_type, npc, nv, slots)
        his.append(h)
        los.append(l_)
    if not his:
        z = table.new_zeros((0, len(slots)))
        return z, z
    return torch.cat(his), torch.cat(los)


def interp_acc_cuda(table, ic, r_hi, r_lo, cell_type, npc, nv, slots, *,
                    threads=THREADS):
    """Launch B5 on CUDA tensors: float32 (n_cells, W) acc table, int32
    cells, float32 (B, 3) hi/lo queries.  The kernel reads each
    query's row itself; the slots go by value with the launch.
    ``threads`` is the kernel's threads a block, for the sweep; callers
    keep the default."""
    global launches
    if table.dtype != torch.float32 or r_hi.dtype != torch.float32 \
            or r_lo.dtype != torch.float32:
        raise TypeError("the CUDA accurate kernel takes float32 tables and "
                        f"queries, got {table.dtype} / {r_hi.dtype} / "
                        f"{r_lo.dtype}")
    if ic.dtype != torch.int32:
        raise TypeError(f"cells must be int32, got {ic.dtype}")
    if not (table.device == ic.device == r_hi.device == r_lo.device):
        raise ValueError("table, cells and queries must share one device")
    if table.ndim != 2 or not table.is_contiguous():
        raise ValueError("the acc table must be a contiguous (n_cells, W) "
                         "tensor")
    width = table.shape[1]
    if width % 4 or table.data_ptr() % 16 \
            or npc * 6 + 2 * nv * npc > width:
        raise ValueError(f"acc table width {width} does not hold npc={npc}, "
                         f"nv={nv} or is not 16-byte aligned")
    b = ic.shape[0]
    if ic.ndim != 1 or r_hi.shape != (b, 3) or r_lo.shape != (b, 3):
        raise ValueError(
            f"cells must be (B,), queries (B, 3): got {tuple(ic.shape)}, "
            f"{tuple(r_hi.shape)}, {tuple(r_lo.shape)}"
        )
    if any(not 0 <= s < nv for s in slots):
        raise ValueError(f"slots {slots} outside [0, {nv})")
    dev = table.device
    vh = torch.empty((b, len(slots)), dtype=torch.float32, device=dev)
    vl = torch.empty((b, len(slots)), dtype=torch.float32, device=dev)
    if b == 0 or not slots:
        return vh, vl
    ic = ic.contiguous()
    r_hi = r_hi.contiguous()
    r_lo = r_lo.contiguous()
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for g, sl, n in _kernels.var_slot_groups(slots):
            code = lib.iu_interp_acc(
                table.data_ptr(), width, ic.data_ptr(), r_hi.data_ptr(),
                r_lo.data_ptr(), b, _CELL_TYPE_CODE[cell_type], nv, sl, n,
                vh.data_ptr() + 4 * g, vl.data_ptr() + 4 * g, len(slots),
                threads, stream,
            )
            _kernels.check(code, "iu_interp_acc")
            launches += 1
    return vh, vl


def interp_acc(table, ic, r_hi, r_lo, cell_type, npc, nv, slots):
    """df32 interpolation at known cells: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Returns (vals_hi (B, V),
    vals_lo (B, V))."""
    if table.device.type == "cuda":
        return interp_acc_cuda(table, ic, r_hi, r_lo, cell_type, npc, nv,
                               slots)
    if table.device.type == "cpu":
        return interp_acc_plain(table, ic, r_hi, r_lo, cell_type, npc, nv,
                                slots)
    raise ValueError(f"no accurate interpolation for device {table.device}")
