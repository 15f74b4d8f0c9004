"""Device-side candidate-bin construction.

The port of the JAX package's ``ops/cand_build.py``: the same per-bin
candidate lists as :func:`.geometry.build_candidate_bins` (the host
builder), built on the grid's device over a fixed grid of pair slots.
Each cell's AABB spans at most ``smax`` bins per axis, so bin offset
``o`` = (i, j, k) within that span gives one potential (bin, cell) pair
per cell: slot ``s = o * C + c``, offset-major, as the JAX package
stacks its per-offset arrays.

0. Prelude (:func:`prepare_pairs`, on the grid's device): bin grid and
   each cell's first bin and bin span, from float64 AABBs.
1. Buckets (kernel D1 on the card, in a count pass and a write pass;
   :func:`bin_pairs_plain` on the CPU): a slot is kept unless it lies
   outside the cell's span or the bin is provably separated from the
   cell by a face plane.  Each bin counts its kept pairs; after an
   exclusive scan of the counts each kept pair writes one 64-bit record
   ``(score_order << 32) | slot`` into its bin's bucket, the score being
   the bin-center interiority (:func:`score_order`).
2. Tables (kernel D2 on the card, :func:`fill_tables_plain` on the
   CPU): each bucket in ascending order, which is the JAX package's
   ``lax.sort((key, -score, cell), num_keys=2, is_stable=True)`` order
   inside the bin (scores descending, ties in slot order); rank r <
   ``k_max`` into ``cand_ids``, ranks ``k_max .. k_max + k_ext`` of
   overflowing bins into ``ext_ids``, extension rows assigned in
   ascending bin order.  No general sort runs on the card.

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
import time

import numpy as np
import torch

from . import cand_build_kernel, geometry

# The JAX package's limits, kept for parity of the "auto" choice: pair
# slots the pipeline may allocate, and bin offsets of the worst span
MAX_PAIR_SLOTS = 1 << 26
MAX_OFFSETS = 512

# Order bits of a NaN score: above every other score's (lax.sort orders
# every NaN after +inf, and all NaNs as equal)
NAN_ORDER = 0xFFC00000
# The sign bit of an int64: a record XOR it compares, signed, as the
# record compares unsigned
SIGN_BIT = -(1 << 63)


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
                  device="cuda", timings=None):
    """The prelude of the JAX package's builder: bin grid, float64 cell
    AABBs in bins, the offset span, the rounding guard.  The AABBs are
    computed on ``device`` from the float64 ``cell_points`` (C, npc, 3),
    each step one IEEE operation as in the JAX package's numpy lines
    (min, max, the pad, ``- rmin``, ``* inv_h``, floor, clip), so ``b0``,
    ``span`` and ``smax`` are theirs bit for bit on any device; ``smax``
    is read to the host once.  ``timings``: a dict that gets the seconds
    of each step (``grid_s``, ``points_s``, ``aabb_s``, ``inputs_s``),
    the device synchronized at each.  Returns (PairInputs, bin_shape,
    rmin, inv_h), or None where the JAX package declines (no cells, too
    many offsets or slots)."""
    n_cells = len(cell_points)
    if n_cells == 0:
        return None
    device = torch.device(device)
    t0 = time.perf_counter()

    def mark(key):
        nonlocal t0
        if timings is None:
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        timings[key] = timings.get(key, 0.0) + (now - t0)
        t0 = now

    cell_points = np.asarray(cell_points, np.float64)
    rmin = np.asarray(rmin, np.float64)
    n_target = min(max(int(bins_per_cell * n_cells), 1), max_bins)
    bin_shape, h, inv_h, active = geometry._bin_grid_shape(
        rmin, rmax, ndim, n_target
    )
    nbx, nby, nbz = (int(s) for s in bin_shape)
    mark("grid_s")

    cp = torch.from_numpy(cell_points).to(device)
    mark("points_s")
    rmin_d = torch.from_numpy(rmin).to(device)
    inv_h_d = torch.from_numpy(np.asarray(inv_h, np.float64)).to(device)
    top = torch.from_numpy(np.asarray(bin_shape, np.int64) - 1).to(device)

    def bins(x):
        i = torch.floor((x - rmin_d) * inv_h_d).to(torch.int64)
        return torch.minimum(i.clamp_(min=0), top)

    pad = eps + 1e-300
    b0 = bins(cp.amin(dim=1) - pad)
    span = (bins(cp.amax(dim=1) + pad) - b0 + 1).to(torch.int32)
    del cp
    smax = span.amax(dim=0).tolist()
    mark("aabb_s")
    n_offsets = int(np.prod(smax))
    if n_offsets > MAX_OFFSETS or n_offsets * n_cells > MAX_PAIR_SLOTS:
        return None  # strongly graded mesh: host fallback

    # dtype-scaled rounding guard on top of the caller's inflation, so a
    # dropped pair is ALWAYS truly separated at the query eps
    scale = max(np.max(np.abs(rmin)), np.max(np.abs(np.asarray(rmax))), 1.0)
    eps_dev = float(eps + 64.0 * torch.finfo(dtype).eps * scale)
    use_zc = ndim == 2 and not active[2]
    zc = float(cell_points[:, :, 2].mean()) if use_zc else 0.0

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dt)

    pairs = PairInputs(
        normals=dev(face_normals, dtype),
        offs=dev(face_offsets, dtype),
        b0=b0.to(torch.int32),
        span=span,
        half=np.where(active, 0.5 * h, 0.0),
        rmin=rmin,
        h=np.where(active, h, 0.0),
        eps=eps_dev,
        zc=zc,
        use_zc=bool(use_zc),
        smax=tuple(int(s) for s in smax),
        bin_shape=(nbx, nby, nbz),
    )
    mark("inputs_s")
    return pairs, (nbx, nby, nbz), rmin, inv_h


def score_order(score):
    """The order-preserving bits (int64 in [0, 2^32)) of ``-score``:
    unsigned order of the result is float order, as ``lax.sort``'s
    comparator orders float32 in the JAX package: -0.0 and the subnormals
    (which XLA flushes to zero on the CPU and the TPU) as +0.0, every NaN
    as one value above +inf.  Ascending order sorts scores descending."""
    neg = -score
    tiny = torch.finfo(torch.float32).tiny
    neg = torch.where(neg.abs() < tiny, torch.zeros_like(neg), neg)
    bits = neg.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                        bits | 0x80000000)
    return torch.where(torch.isnan(neg), NAN_ORDER, order)


def sort_word(key, score):
    """The 64-bit sort word of each slot: the bin key in the high half,
    :func:`score_order` in the low half.  Sorting the words ascending
    sorts (key ascending, score descending)."""
    return (key.to(torch.int64) << 32) | score_order(score)


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


def bucket_order(key, rec):
    """The permutation that puts records in canonical order: keys
    ascending, records ascending as unsigned 64-bit words within a key.
    Records are unique (each holds its slot), so the order is total."""
    perm = torch.argsort(rec ^ SIGN_BIT)  # unsigned order as signed
    return perm[torch.argsort(key[perm], stable=True)]


def bin_pairs_plain(p: PairInputs):
    """Plain PyTorch version of kernel D1's two passes: (counts (n_bins,)
    int32, records (kept pairs,) int64).  Each kept pair's record is
    ``(score_order << 32) | slot``, bucket by bucket in ascending bin
    order, each bucket in ascending order of its records (the order D2
    gives it)."""
    key, score = key_score_plain(p)
    n_bins = p.n_bins
    counts = torch.bincount(key, minlength=n_bins + 1)[:n_bins]
    slot = torch.nonzero(key < n_bins).squeeze(1)
    rec = (score_order(score[slot]) << 32) | slot
    return counts.to(torch.int32), rec[bucket_order(key[slot], rec)]


def ext_slots(counts, k_max):
    """Each overflowing bin's row in the extension table, in ascending
    bin order; -1 for the others."""
    over = counts > k_max
    return torch.where(
        over, torch.cumsum(over, 0, dtype=torch.int32) - 1, -1
    ).to(torch.int32)


def fill_tables_plain(rec, counts, n_cells, k_max, k_ext, n_over):
    """Plain PyTorch version of kernel D2 (the JAX package's
    ``_fill_tables``, :135-168, after the ranks of ``_sort_rank_count``):
    each bucket of ``rec`` (bucket by bucket, ``counts`` (n_bins,) int32
    records each, any order inside a bucket) in ascending order; rank r <
    k_max into ``cand_ids[bin, r]``, ranks ``k_max .. k_max + k_ext`` of
    overflowing bins into ``ext_ids``, the cell being slot % n_cells.
    Returns (cand_ids (n_bins, k_max), ext_slot (n_bins,), ext_ids
    (n_over, k_ext) or (0, 0)), int32."""
    dev = rec.device
    n_bins = counts.shape[0]
    c64 = counts.to(torch.int64)
    key = torch.repeat_interleave(torch.arange(n_bins, device=dev), c64)
    rec = rec[bucket_order(key, rec)]
    rank = torch.arange(rec.shape[0], device=dev) - (
        torch.cumsum(c64, 0) - c64)[key]
    cell = ((rec & 0xFFFFFFFF) % n_cells).to(torch.int32)
    cand_ids = torch.full((n_bins, k_max), -1, dtype=torch.int32, device=dev)
    main = rank < k_max
    cand_ids[key[main], rank[main]] = cell[main]
    ext_slot = ext_slots(counts, k_max)
    if k_ext and n_over:
        e = ext_slot[key].to(torch.int64)
        in_ext = (rank >= k_max) & (rank < k_max + k_ext) & (e >= 0)
        ext_ids = torch.full((n_over, k_ext), -1, dtype=torch.int32,
                             device=dev)
        ext_ids[e[in_ext], rank[in_ext] - k_max] = cell[in_ext]
    else:
        ext_ids = torch.zeros((0, 0), dtype=torch.int32, device=dev)
    return cand_ids, ext_slot, ext_ids


def candidate_tables(p: PairInputs, k_max, ext_max_k=0, cover_ok=None):
    """Stages 1 and 2 on the prelude's inputs: (cand_ids, counts, ext_ids,
    ext_slot), int32 tensors on ``p``'s device.  On a CUDA device D1's
    count pass, one host read of three scalars (the largest count, the
    kept pairs, the overflowing bins), the exclusive scan of the counts,
    D1's write pass and D2; on the CPU their plain versions.  Any other
    device raises."""
    dev = p.normals.device
    on_card = dev.type == "cuda"
    if on_card:
        counts = cand_build_kernel.count_pairs_cuda(p)
    elif dev.type == "cpu":
        counts, rec = bin_pairs_plain(p)
    else:
        raise ValueError(f"no candidate builder for device {dev}")
    # One host read sizes the records and the extension table
    max_count, n_kept, n_over = torch.stack((
        counts.max().to(torch.int64), counts.sum(dtype=torch.int64),
        (counts > k_max).sum())).tolist()
    if cover_ok is not None and cover_ok(max_count):
        # Cover-all rows: widen K to the worst bin so every bin's list
        # is complete — no extension table, no query-side fallback
        k_max, n_over = max_count, 0
    k_ext = (
        min(max_count - k_max, ext_max_k)
        if (n_over and ext_max_k > 0)
        else 0
    )
    n_cells = p.normals.shape[0]
    if on_card:
        start = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        rec = cand_build_kernel.write_pairs_cuda(p, start, n_kept)
        cand_ids, ext_slot, ext_ids = cand_build_kernel.order_tables_cuda(
            rec, start, counts, ext_slots(counts, k_max), n_cells, k_max,
            k_ext, n_over, max_count)
    else:
        cand_ids, ext_slot, ext_ids = fill_tables_plain(
            rec, counts, n_cells, k_max, k_ext, n_over)
    return cand_ids, counts, ext_ids, ext_slot


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
    plain versions on the CPU; any other device raises), or ``None``
    where the JAX package's builder declines (no cells, a worst-case AABB
    span past the offset or slot budget); the caller then takes the host
    builder."""
    prep = prepare_pairs(cell_points, face_normals, face_offsets, rmin, rmax,
                         ndim, dtype, bins_per_cell, max_bins, eps, device)
    if prep is None:
        return None
    p, bin_shape, rmin, inv_h = prep
    cand_ids, counts, ext_ids, ext_slot = candidate_tables(
        p, k_max, ext_max_k, cover_ok)
    return cand_ids, counts, bin_shape, rmin, inv_h, ext_ids, ext_slot
