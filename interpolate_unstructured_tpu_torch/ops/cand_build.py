"""Device-side candidate-bin construction.

The port of the JAX package's ``ops/cand_build.py``: the same per-bin
candidate lists as :func:`.geometry.build_candidate_bins` (the host
builder), built on the grid's device in three stages over a fixed grid
of pair slots.  Each cell's AABB spans at most ``smax`` bins per axis,
so bin offset ``o`` = (i, j, k) within that span gives one potential
(bin, cell) pair per cell: slot ``s = o * C + c``, offset-major, as the
JAX package stacks its per-offset arrays.

1. Pairs (kernel D1 on the card, :func:`gen_pairs_plain` on the CPU):
   per slot the bin key (``n_bins`` where the slot is outside the cell's
   span or the bin is provably separated from the cell by a face plane)
   and the bin-center interiority score, packed into one 64-bit sort
   word (:func:`sort_word`), and the slot's cell id.
2. Sort (:func:`sort_pairs`): ``torch.sort(word, stable=True)``, which
   reproduces the JAX package's ``lax.sort((key, -score, cell),
   num_keys=2, is_stable=True)``: bins ascending, scores descending,
   ties in slot order.
3. Tables (kernel D2 on the card, :func:`fill_tables_plain` after
   :func:`sort_rank_count` on the CPU): each kept pair's rank in its
   bin, the first ``k_max`` into ``cand_ids``, ranks ``k_max ..
   k_max + k_ext`` of overflowing bins into ``ext_ids``, extension rows
   assigned in ascending bin order.

The arithmetic of stage 1 runs in the grid's dtype in the JAX package's
operation order.  The separation test is inflated by ``eps`` plus a
dtype-scaled rounding guard, so a dropped pair is always truly separated
at the query tolerance; counts are exact, so "no candidate contains r
and the count fits" stays an exact not-found.  Meshes whose worst AABB
span needs more than ``MAX_OFFSETS`` offsets, or more than
``MAX_PAIR_SLOTS`` slots in all, are declined (None), exactly where the
JAX package declines, so ``cand_build="auto"`` picks the same builder in
both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cand_build_kernel, geometry

# The JAX package's limits, kept for parity of the "auto" choice: pair
# slots the pipeline may allocate, and bin offsets of the worst span
MAX_PAIR_SLOTS = 1 << 26
MAX_OFFSETS = 512

# Low half of a sort word for a NaN score: above every other score's
# (lax.sort orders every NaN after +inf, and all NaNs as equal)
NAN_ORDER = 0xFFC00000


@dataclasses.dataclass(frozen=True)
class PairInputs:
    """Stage 1's inputs on the device.  ``normals`` (C, nf, 3) and
    ``offs`` (C, nf) in the grid dtype; ``b0`` and ``span`` (C, 3) int32,
    each cell's first bin and bin count per axis.  ``half``, ``rmin`` and
    ``h`` are the float64 (3,) bin half-size, origin and size (0 on an
    unused axis), ``eps`` the widened separation guard and ``zc`` the
    probe plane of a planar mesh: the stages round them to the dtype.
    ``use_zc`` says whether bin centers take ``zc`` for z."""

    normals: torch.Tensor
    offs: torch.Tensor
    b0: torch.Tensor
    span: torch.Tensor
    half: np.ndarray
    rmin: np.ndarray
    h: np.ndarray
    eps: float
    zc: float
    use_zc: bool
    smax: tuple
    bin_shape: tuple

    @property
    def n_bins(self) -> int:
        return int(np.prod(self.bin_shape))

    @property
    def n_offsets(self) -> int:
        return int(np.prod(self.smax))

    @property
    def n_slots(self) -> int:
        return self.n_offsets * self.normals.shape[0]


def prepare_pairs(cell_points, face_normals, face_offsets, rmin, rmax, ndim,
                  dtype, bins_per_cell=1.0, max_bins=1 << 21, eps=0.0,
                  device="cuda"):
    """The host prelude of the JAX package's builder, line for line: bin
    grid, float64 cell AABBs in bins, the offset span, the rounding
    guard.  Returns (PairInputs, bin_shape, rmin, inv_h), or None where
    the JAX package declines (no cells, too many offsets or slots)."""
    n_cells = len(cell_points)
    if n_cells == 0:
        return None
    rmin = np.asarray(rmin, np.float64)
    n_target = min(max(int(bins_per_cell * n_cells), 1), max_bins)
    bin_shape, h, inv_h, active = geometry._bin_grid_shape(
        rmin, rmax, ndim, n_target
    )
    nbx, nby, nbz = (int(s) for s in bin_shape)

    pad = eps + 1e-300
    lo = cell_points.min(axis=1) - pad
    hi = cell_points.max(axis=1) + pad
    b0 = np.clip(
        np.floor((lo - rmin) * inv_h).astype(np.int64), 0, bin_shape - 1
    )
    b1 = np.clip(
        np.floor((hi - rmin) * inv_h).astype(np.int64), 0, bin_shape - 1
    )
    span = (b1 - b0 + 1).astype(np.int32)
    smax = span.max(axis=0)
    n_offsets = int(np.prod(smax))
    if n_offsets > MAX_OFFSETS or n_offsets * n_cells > MAX_PAIR_SLOTS:
        return None  # strongly graded mesh: host fallback

    # dtype-scaled rounding guard on top of the caller's inflation, so a
    # dropped pair is ALWAYS truly separated at the query eps
    scale = max(np.max(np.abs(rmin)), np.max(np.abs(np.asarray(rmax))), 1.0)
    eps_dev = float(eps + 64.0 * torch.finfo(dtype).eps * scale)
    use_zc = ndim == 2 and not active[2]
    zc = float(cell_points[:, :, 2].mean()) if use_zc else 0.0

    device = torch.device(device)

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dt)

    pairs = PairInputs(
        normals=dev(face_normals, dtype),
        offs=dev(face_offsets, dtype),
        b0=dev(b0, torch.int32),
        span=dev(span, torch.int32),
        half=np.where(active, 0.5 * h, 0.0),
        rmin=rmin,
        h=np.where(active, h, 0.0),
        eps=eps_dev,
        zc=zc,
        use_zc=bool(use_zc),
        smax=tuple(int(s) for s in smax),
        bin_shape=(nbx, nby, nbz),
    )
    return pairs, (nbx, nby, nbz), rmin, inv_h


def sort_word(key, score):
    """The 64-bit sort word of each slot: the bin key in the high half,
    and in the low half the bits of ``-score`` mapped so that unsigned
    order is float order, as ``lax.sort``'s comparator orders float32 in
    the JAX package: -0.0 and the subnormals (which XLA flushes to zero
    on the CPU and the TPU) as +0.0, every NaN as one value above +inf.
    Sorting the words ascending sorts (key ascending, score
    descending)."""
    neg = -score
    tiny = torch.finfo(torch.float32).tiny
    neg = torch.where(neg.abs() < tiny, torch.zeros_like(neg), neg)
    bits = neg.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                        bits | 0x80000000)
    order = torch.where(torch.isnan(neg), NAN_ORDER, order)
    return (key.to(torch.int64) << 32) | order


def key_score_plain(p: PairInputs):
    """Stage 1's (key int32, score float32) of every slot, offset-major:
    the JAX package's ``_gen_pairs`` (:56-110) in torch, operation for
    operation in the grid dtype."""
    normals, offs = p.normals, p.offs
    dtype, dev = normals.dtype, normals.device
    _, nby, nbz = p.bin_shape
    n_bins = p.n_bins

    def scalars(a):
        return [torch.tensor(float(x), dtype=dtype, device=dev) for x in a]

    half, rmin_d, h_d = scalars(p.half), scalars(p.rmin), scalars(p.h)
    n_abs = normals.abs()
    reach = (
        n_abs[:, :, 0] * half[0]
        + n_abs[:, :, 1] * half[1]
        + n_abs[:, :, 2] * half[2]
    )  # (C, nf)
    off_eps = offs + torch.tensor(p.eps, dtype=dtype, device=dev)
    zc = torch.tensor(p.zc, dtype=dtype, device=dev)
    b0, span = p.b0, p.span
    keys, scores = [], []
    for i in range(p.smax[0]):
        for j in range(p.smax[1]):
            for k in range(p.smax[2]):
                valid = (i < span[:, 0]) & (j < span[:, 1]) & (k < span[:, 2])
                bx = b0[:, 0] + i
                by = b0[:, 1] + j
                bz = b0[:, 2] + k
                pbin = (bx * nby + by) * nbz + bz
                cbx = rmin_d[0] + (bx.to(dtype) + 0.5) * h_d[0]
                cby = rmin_d[1] + (by.to(dtype) + 0.5) * h_d[1]
                cbz = (zc.expand_as(cbx) if p.use_zc
                       else rmin_d[2] + (bz.to(dtype) + 0.5) * h_d[2])
                proj = (
                    normals[:, :, 0] * cbx[:, None]
                    + normals[:, :, 1] * cby[:, None]
                    + normals[:, :, 2] * cbz[:, None]
                )  # (C, nf)
                separated = ((proj - reach) > off_eps).any(dim=1)
                keep = valid & ~separated
                keys.append(torch.where(keep, pbin, n_bins).to(torch.int32))
                scores.append((offs - proj).amin(dim=1).to(torch.float32))
    return torch.cat(keys), torch.cat(scores)


def gen_pairs_plain(p: PairInputs):
    """Plain PyTorch version of kernel D1: (word int64, cell int32,
    counts int32) of every slot — the sort words of
    :func:`key_score_plain`, each slot's cell id, and the number of kept
    pairs in each bin."""
    key, score = key_score_plain(p)
    c = p.normals.shape[0]
    cell = torch.arange(c, dtype=torch.int32,
                        device=key.device).repeat(p.n_offsets)
    counts = torch.bincount(key, minlength=p.n_bins + 1)[: p.n_bins]
    return sort_word(key, score), cell, counts.to(torch.int32)


def sort_pairs(word, cell):
    """Stage 2's sort: words ascending, stable, and the cells carried
    along.  Returns (sorted words, sorted cells)."""
    sw, perm = torch.sort(word, stable=True)
    return sw, cell[perm]


def sort_rank_count(word, cell):
    """Stage 2, plain (the JAX package's ``_sort_rank_count``, :114-132,
    whose per-bin counts come from stage 1 here): the sort and each
    pair's rank in its bin.  Returns (sorted keys int32, ranks int32,
    sorted cells)."""
    sw, scell = sort_pairs(word, cell)
    sk = (sw >> 32).to(torch.int32)
    return sk, bin_ranks(sk), scell


def bin_ranks(sk):
    """Each sorted pair's rank in its bin (int32): its position minus
    the position where its key's run starts."""
    n = sk.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=sk.device)
    change = torch.ones(n, dtype=torch.bool, device=sk.device)
    change[1:] = sk[1:] != sk[:-1]
    return pos - torch.cummax(torch.where(change, pos, 0), dim=0).values


def ext_slots(counts, k_max):
    """Each overflowing bin's row in the extension table, in ascending
    bin order; -1 for the others."""
    over = counts > k_max
    return torch.where(
        over, torch.cumsum(over, 0, dtype=torch.int32) - 1, -1
    ).to(torch.int32)


def fill_tables_plain(sk, rank, scell, counts, n_bins, k_max, k_ext, n_over):
    """Plain PyTorch version of kernel D2 (the JAX package's
    ``_fill_tables``, :135-168): ranked pairs into the main table and the
    extension table.  Returns (cand_ids (n_bins, k_max), ext_slot
    (n_bins,), ext_ids (n_over, k_ext) or (0, 0)), int32."""
    dev = sk.device
    sentinel = n_bins * k_max
    sk64, rank64 = sk.long(), rank.long()
    flat = torch.where(
        (sk64 < n_bins) & (rank64 < k_max), sk64 * k_max + rank64, sentinel
    )
    cand_ids = torch.full((sentinel + 1,), -1, dtype=torch.int32, device=dev)
    cand_ids[flat] = scell
    cand_ids = cand_ids[:sentinel].reshape(n_bins, k_max)
    ext_slot = ext_slots(counts, k_max)
    if k_ext and n_over:
        slot_of_pair = ext_slot[torch.clamp(sk64, max=n_bins - 1)].long()
        in_ext = ((sk64 < n_bins) & (rank64 >= k_max)
                  & (rank64 < k_max + k_ext) & (slot_of_pair >= 0))
        esent = n_over * k_ext
        eflat = torch.where(
            in_ext, slot_of_pair * k_ext + (rank64 - k_max), esent
        )
        ext_ids = torch.full((esent + 1,), -1, dtype=torch.int32, device=dev)
        ext_ids[eflat] = scell
        ext_ids = ext_ids[:esent].reshape(n_over, k_ext)
    else:
        ext_ids = torch.zeros((0, 0), dtype=torch.int32, device=dev)
    return cand_ids, ext_slot, ext_ids


def build_candidate_bins_device(
    cell_points: np.ndarray,
    face_normals: np.ndarray,
    face_offsets: np.ndarray,
    rmin,
    rmax,
    ndim: int,
    k_max: int,
    dtype: torch.dtype,
    bins_per_cell: float = 1.0,
    max_bins: int = 1 << 21,
    eps: float = 0.0,
    ext_max_k: int = 0,
    cover_ok=None,
    device="cuda",
):
    """Device-pipeline equivalent of :func:`.geometry.build_candidate_bins`.

    Returns the same 7-tuple, with the id, count and slot tables as int32
    tensors on ``device`` (kernels D1 and D2 on a CUDA device, their
    plain versions on the CPU), or ``None`` where the JAX package's
    builder declines (no cells, a worst-case AABB span past the offset or
    slot budget); the caller then takes the host builder."""
    prep = prepare_pairs(cell_points, face_normals, face_offsets, rmin, rmax,
                         ndim, dtype, bins_per_cell, max_bins, eps, device)
    if prep is None:
        return None
    p, bin_shape, rmin, inv_h = prep
    n_bins = p.n_bins
    if p.normals.device.type == "cuda":
        word, cell, counts = cand_build_kernel.gen_pairs_cuda(p)
        sw, scell = sort_pairs(word, cell)
        del word, cell

        def fill(k, k_ext, n_over):
            return cand_build_kernel.fill_tables_cuda(
                sw, scell, counts, ext_slots(counts, k), n_bins, k, k_ext,
                n_over)
    elif p.normals.device.type == "cpu":
        word, cell, counts = gen_pairs_plain(p)
        sk, rank, scell = sort_rank_count(word, cell)
        del word, cell

        def fill(k, k_ext, n_over):
            return fill_tables_plain(sk, rank, scell, counts, n_bins, k,
                                     k_ext, n_over)
    else:
        raise ValueError(f"no candidate builder for device {device}")
    # Two host scalars size the extension table
    max_count = int(counts.max())
    if cover_ok is not None and cover_ok(max_count):
        # Cover-all rows: widen K to the worst bin so every bin's list
        # is complete — no extension table, no query-side fallback
        k_max = max_count
    n_over = int((counts > k_max).sum())
    k_ext = (
        min(max_count - k_max, ext_max_k)
        if (n_over and ext_max_k > 0)
        else 0
    )
    cand_ids, ext_slot, ext_ids = fill(k_max, k_ext, n_over)
    return cand_ids, counts, bin_shape, rmin, inv_h, ext_ids, ext_slot
