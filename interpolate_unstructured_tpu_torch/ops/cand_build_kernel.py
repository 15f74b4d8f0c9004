"""Kernels D1 and D2: the device candidate builder's bin buckets and id
tables.

No Pallas kernel is their counterpart: the JAX package builds the lists
in XLA (``ops/cand_build.py``: ``_gen_pairs``, ``lax.sort``,
``_fill_tables``).  D1 (``csrc/cand_build.cu`` ``cand_bin_kernel``) runs
twice: :func:`count_pairs_cuda` counts each bin's kept pairs and
:func:`write_pairs_cuda` writes each kept pair's record into its bin's
bucket.  :func:`order_tables_cuda` launches D2 (``cand_order_*_kernel``),
which orders each bucket and writes the tables.  Their plain versions,
``bin_pairs_plain`` and ``fill_tables_plain``, live in
``ops/cand_build.py`` beside the builder, which runs them on CPU
tensors.  ``count_launches``, ``write_launches`` and ``order_launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

count_launches = 0  # launches of D1's count pass
write_launches = 0  # launches of D1's write pass
order_launches = 0  # launches of D2

# D2 sorts buckets above this many records in shared memory, a block a
# bin; smaller ones in a warp (csrc/cand_build.cu)
WARP_RECORDS = 32


def _bin(p, counter, rec, write):
    """One launch of D1 on a :class:`.cand_build.PairInputs` whose
    tensors lie on one CUDA device."""
    normals, offs, b0, span = p.normals, p.offs, p.b0, p.span
    if normals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"D1 takes float32 or float64 grids, got "
                        f"{normals.dtype}")
    c, nf = offs.shape
    if (nf not in (3, 4) or normals.shape != (c, nf, 3)
            or offs.dtype != normals.dtype
            or b0.shape != (c, 3) or span.shape != (c, 3)
            or b0.dtype != torch.int32 or span.dtype != torch.int32):
        raise ValueError("D1 takes normals (C, nf, 3), offsets (C, nf) of "
                         "one dtype, b0 and span (C, 3) int32, nf 3 or 4")
    dev = normals.device
    if dev.type != "cuda" or any(t.device != dev for t in (offs, b0, span)):
        raise ValueError("D1's inputs must lie on one CUDA device")
    if not all(t.is_contiguous() for t in (normals, offs, b0, span)):
        raise ValueError("D1's inputs must be contiguous")
    if p.n_slots >= 1 << 31:
        raise ValueError("D1 takes fewer than 2^31 slots")
    smax = (ctypes.c_int * 3)(*p.smax)
    frame = (ctypes.c_double * 11)(*p.half, *p.rmin, *p.h, p.eps, p.zc)
    _, nby, nbz = p.bin_shape
    with torch.cuda.device(dev):
        code = _kernels.lib().iu_cand_bin(
            normals.data_ptr(), offs.data_ptr(), b0.data_ptr(),
            span.data_ptr(), c, nf, int(normals.dtype == torch.float64),
            smax, nby, nbz, frame, int(p.use_zc), int(write),
            counter.data_ptr(), 0 if rec is None else rec.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _kernels.check(code, "iu_cand_bin")


def count_pairs_cuda(p):
    """D1's count pass: (n_bins,) int32, the kept pairs of each bin."""
    global count_launches
    counts = torch.zeros(p.n_bins, dtype=torch.int32,
                         device=p.normals.device)
    _bin(p, counts, None, write=False)
    count_launches += 1
    return counts


def write_pairs_cuda(p, start, n_kept):
    """D1's write pass: (n_kept,) int64 records ``(score_order << 32) |
    slot``, bin by bin from ``start`` ((n_bins,) int32, the exclusive
    scan of the count pass's counts), in an order the atomics choose
    inside each bin."""
    global write_launches
    dev = p.normals.device
    if (start.device != dev or start.dtype != torch.int32
            or start.shape != (p.n_bins,)):
        raise ValueError("D1's write pass takes (n_bins,) int32 starts on "
                         "the inputs' device")
    nxt = start.clone()
    rec = torch.empty(n_kept, dtype=torch.int64, device=dev)
    _bin(p, nxt, rec, write=True)
    write_launches += 1
    return rec


def order_tables_cuda(rec, start, counts, ext_slot, n_cells, k_max, k_ext,
                      n_over, max_count):
    """Launch D2 on CUDA tensors: ``rec`` the write pass's records,
    ``start``, ``counts`` and ``ext_slot`` (n_bins,) int32
    (``cand_build.ext_slots``), ``max_count`` the largest count.
    Returns (cand_ids (n_bins, k_max), ext_slot, ext_ids (n_over, k_ext)
    or (0, 0)), int32, as ``fill_tables_plain``."""
    global order_launches
    dev = rec.device
    n_bins = counts.shape[0]
    if dev.type != "cuda" or any(
            t.device != dev for t in (start, counts, ext_slot)):
        raise ValueError("D2's inputs must lie on one CUDA device")
    if (rec.dtype != torch.int64 or rec.dim() != 1
            or any(t.dtype != torch.int32 or t.shape != (n_bins,)
                   for t in (start, counts, ext_slot))):
        raise ValueError("D2 takes int64 records and (n_bins,) int32 "
                         "starts, counts and slots")
    if not all(t.is_contiguous() for t in (rec, start, counts, ext_slot)):
        raise ValueError("D2's inputs must be contiguous")
    if not 0 < n_cells < 1 << 31 or rec.numel() >= 1 << 31:
        raise ValueError("D2 takes 1 to 2^31 - 1 cells and fewer than 2^31 "
                         "records")
    cand_ids = torch.empty((n_bins, k_max), dtype=torch.int32, device=dev)
    if not (k_ext and n_over):
        k_ext = 0
    ext_ids = torch.empty((n_over, k_ext) if k_ext else (0, 0),
                          dtype=torch.int32, device=dev)
    work, cap = None, 0
    if max_count > WARP_RECORDS:
        cap = min(n_bins, rec.numel() // (WARP_RECORDS + 1) + 1)
        work = torch.empty(2 + 2 * cap, dtype=torch.int32, device=dev)
        work[:2].zero_()
    with torch.cuda.device(dev):
        code = _kernels.lib().iu_cand_order(
            rec.data_ptr(), start.data_ptr(), counts.data_ptr(),
            ext_slot.data_ptr(), n_bins, n_cells, k_max, k_ext, max_count,
            cand_ids.data_ptr(), ext_ids.data_ptr(),
            0 if work is None else work.data_ptr(), cap,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _kernels.check(code, "iu_cand_order")
    order_launches += 1
    return cand_ids, ext_slot, ext_ids
