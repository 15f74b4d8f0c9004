"""Kernels D1 and D2: the device candidate builder's pair words and id
tables.

No Pallas kernel is their counterpart: the JAX package builds the lists
in XLA (``ops/cand_build.py``: ``_gen_pairs``, ``lax.sort``,
``_fill_tables``).  :func:`gen_pairs_cuda` launches D1
(``csrc/cand_build.cu`` ``cand_pairs_kernel``) and
:func:`fill_tables_cuda` launches D2 (``cand_fill_kernel``) on CUDA
tensors; their plain versions, ``gen_pairs_plain`` and
``fill_tables_plain``, live in ``ops/cand_build.py`` beside the builder,
which runs them on CPU tensors.  ``pairs_launches`` and
``fill_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

pairs_launches = 0  # launches of D1
fill_launches = 0  # launches of D2


def gen_pairs_cuda(p):
    """Launch D1 on a :class:`.cand_build.PairInputs` whose tensors lie on
    one CUDA device.  Returns (word int64, cell int32, counts int32):
    each slot's sort word and cell id, and the kept pairs of each bin."""
    global pairs_launches
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
    n_slots, n_bins = p.n_slots, p.n_bins
    word = torch.empty(n_slots, dtype=torch.int64, device=dev)
    cell = torch.empty(n_slots, dtype=torch.int32, device=dev)
    counts = torch.zeros(n_bins, dtype=torch.int32, device=dev)
    smax = (ctypes.c_int * 3)(*p.smax)
    frame = (ctypes.c_double * 11)(*p.half, *p.rmin, *p.h, p.eps, p.zc)
    _, nby, nbz = p.bin_shape
    with torch.cuda.device(dev):
        code = _kernels.lib().iu_cand_pairs(
            normals.data_ptr(), offs.data_ptr(), b0.data_ptr(),
            span.data_ptr(), c, nf, int(normals.dtype == torch.float64),
            smax, nby, nbz, n_bins, frame, int(p.use_zc), word.data_ptr(),
            cell.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "iu_cand_pairs")
    pairs_launches += 1
    return word, cell, counts


def fill_tables_cuda(sw, scell, counts, ext_slot, n_bins, k_max, k_ext,
                     n_over):
    """Launch D2 on CUDA tensors: ``sw`` the sorted words (int64),
    ``scell`` their cells (int32), ``counts`` and ``ext_slot`` (n_bins,)
    int32 (``cand_build.ext_slots``).  Returns (cand_ids (n_bins, k_max),
    ext_slot, ext_ids (n_over, k_ext) or (0, 0)), int32, as
    ``fill_tables_plain``."""
    global fill_launches
    dev = sw.device
    if dev.type != "cuda" or any(
            t.device != dev for t in (scell, counts, ext_slot)):
        raise ValueError("D2's inputs must lie on one CUDA device")
    if (sw.dtype != torch.int64 or scell.dtype != torch.int32
            or counts.dtype != torch.int32 or ext_slot.dtype != torch.int32
            or sw.shape != scell.shape or counts.shape != (n_bins,)
            or ext_slot.shape != (n_bins,)):
        raise ValueError("D2 takes sorted int64 words, int32 cells of the "
                         "same length and (n_bins,) int32 counts and slots")
    if sw.numel() >= 1 << 31:
        raise ValueError("D2 takes fewer than 2^31 slots")
    sw, scell = sw.contiguous(), scell.contiguous()
    ext_slot = ext_slot.contiguous()
    start = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    cand_ids = torch.full((n_bins, k_max), -1, dtype=torch.int32, device=dev)
    if not (k_ext and n_over):
        k_ext = 0
    ext_ids = torch.full((n_over, k_ext) if k_ext else (0, 0), -1,
                         dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = _kernels.lib().iu_cand_fill(
            sw.data_ptr(), scell.data_ptr(), sw.numel(), start.data_ptr(),
            ext_slot.data_ptr(), n_bins, k_max, k_ext, cand_ids.data_ptr(),
            ext_ids.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(code, "iu_cand_fill")
    fill_launches += 1
    return cand_ids, ext_slot, ext_ids
