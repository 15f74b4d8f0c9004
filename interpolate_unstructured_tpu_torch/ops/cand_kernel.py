"""Kernel B2: the candidate-row probe of the cold locate.

Counterpart of the JAX package's ``ops/pallas_cand.py``.  Each query
reads the packed row of its bin (``table[idx]``): K candidate cells,
role-major, column ``j*K + k`` for role j of candidate k.  The probe
returns, per query, the first-occurrence argmax winner ``id_best`` of
the face margins, the verdict ``aux`` (-2 found, >= 0 overflow-bin miss
carrying the extension slot, -1 exact miss) and the winner's fused
values (m_interp_unstructured.f90:766-786 containment, :529-641
weights).  Four row layouts (see ``RowLayout.kind`` and the packers in
``models/grid.py``); the fourth, "qdf", is accurate mode's df-plane
branch (the JAX kernel's ``df_planes=True``), whose values come back as
hi/lo float32 pairs.

:func:`cand_rows_binned_query` probes the main table in bin order: on
CUDA tensors a key pass, a scan and a scatter kernel move the queries
into coarse bin order as runs (:func:`bin_order_cuda`: coarse keys of
``2**span_shift`` flat bins, tiles of the batch; :func:`order_sizing`),
and the probe kernel takes a chunk of a coarse bucket a block, puts it
in bin order in shared memory and probes it there, a group of lanes per
query (:func:`binned_lanes`); an unsort kernel puts the records back in
query order as runs (:func:`cand_rows_binned_cuda`).  On CPU tensors the
plain version, :func:`probe_rows_plain`, probes in query order
(:func:`cand_order_plain` is the order's plain twin).  On a grid with
extension rows (``ext``) the same probe launch takes an overflow miss
on to its bin's extension row and writes the merged record; the plain
version is :func:`probe_rows_ext_plain`, the main probe, the extension
probe of the overflow misses and the merge.  The df-plane rows take the
same kernels from the queries as given, float64 or a float32 hi/lo
pair, which the scatter splits and the probe carries into the hi/lo
local frame (:func:`cand_rows_df_query`); the plain version is
:func:`cand_rows_df_plain` (:func:`probe_inputs_df_plain`, then
:func:`probe_rows_df_plain`).  ``bin_pass_launches`` (the key pass and
its scan), ``bin_scatter_launches`` and ``bin_unsort_launches`` count
the launches of the bin order (every row kind), ``binned_launches`` the
probe of a main table without extension rows, ``ext_launches`` the
probe with extension rows and ``df_launches`` that of the df-plane
rows.  While tracing (``utils/timing.py``) the key pass, scan and
scatter are span ``iu.locate.bin_order``, the probe and unsort (or the
plain probe) ``iu.locate.probe``, and counters ``cand_order.queries``
and ``cand_order.split_buckets`` count the queries taken in bin order
and the coarse buckets cut into more than one chunk.

A float64 grid's rows ("simplex" and "quad" in float64, never quantized)
take the same kernels, instantiated for double (the ``*_f64`` entry
points, scalars as C doubles): the key pass bins the float64 queries in
double against the grid's float64 origin and inverse sizes, and a
record carries each double as two int32 words, which the scatter, the
probe's chunk copies and the unsort move as they move any word.  They
count in the same counters.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _kernels, df32, geometry, wkern
from ..utils import timing

df_launches = 0  # probe in bin order of the df-plane rows (B2-df)
bin_pass_launches = 0  # key pass (and its scan) of the bin order
bin_scatter_launches = 0  # scatter of the bin order
binned_launches = 0  # probe in bin order (main table, no extension rows)
ext_launches = 0  # probe in bin order with the extension rows
bin_unsort_launches = 0  # unsort of the probe's records

_KIND_CODE = {"quantized": 0, "simplex": 1, "quad": 2, "qdf": 3}
_QUANTIZED_KINDS = ("quantized", "qdf")
# 1/32767 rounded to float32, as the JAX kernel's jnp.float32(1/32767)
QINV = float(np.float32(1.0 / 32767.0))

# The bin order's sizing (csrc/cand_rows.cu; tools/b2_sweep.py, PERF.md
# §6).  The key pass, scatter and unsort take tiles of KEY_THREADS x 1,
# 2, 4, 8 or 16 queries (TILES), the largest whose staged words (the
# scatter's records and slots, the unsort's UNSORT_WORDS a query) fit
# TILE_SMEM bytes of shared memory (the kernels' cap) and that leaves at
# least MIN_TILES tiles a batch (two a streaming multiprocessor of an
# H100): the longer a tile, the longer its runs (10M uniform float32
# queries: 8192 a tile 3% faster than 4096 and 2048).  The probe takes
# chunks of at most
# MAX_CHUNK queries, the most whose records fit PROBE_SMEM bytes (two
# blocks an SM), and coarse keys of the most flat bins (a power of two,
# at most MAX_SPAN) whose expected bucket fills at most BUCKET_FILL of a
# chunk, and at most MAX_KEYS keys.
KEY_THREADS = 512
TILES = tuple(KEY_THREADS * i for i in (16, 8, 4, 2, 1))
TILE_SMEM = 200 * 1024
UNSORT_WORDS = 6  # 4 words of a record staged, a pad, a slot
MIN_TILES = 264
MAX_KEYS = 8192
MAX_SPAN = 4096
MAX_CHUNK = 4096
PROBE_SMEM = 110 * 1024
BUCKET_FILL = 0.75


class OrderSizing(NamedTuple):
    """The bin order of a batch (:func:`order_sizing`): queries a tile of
    the key pass, scatter and unsort; ``2**span_shift`` flat bins a
    coarse key, ``n_keys`` keys; at most ``chunk`` queries a chunk of the
    probe, at most ``max_chunks`` chunks; words a record (``rec_words``:
    the query) and a result (``out_words``: id, aux and the values)."""

    tile: int
    span_shift: int
    n_keys: int
    chunk: int
    max_chunks: int
    rec_words: int
    out_words: int


def order_sizing(b: int, n_bins: int, rec_words: int,
                 out_words: int) -> OrderSizing:
    """The sizing of the bin order of ``b`` queries on ``n_bins`` flat
    bins, for records of ``rec_words`` and results of ``out_words``
    4-byte words (see the constants above); the launch grids follow from
    it, and it from these numbers alone."""
    return _sizing(b, n_bins, rec_words, out_words, TILES, TILE_SMEM,
                   UNSORT_WORDS, MIN_TILES, MAX_KEYS, MAX_SPAN, MAX_CHUNK,
                   PROBE_SMEM, BUCKET_FILL)


@functools.lru_cache(maxsize=256)
def _sizing(b, n_bins, rec_words, out_words, TILES, TILE_SMEM, UNSORT_WORDS,
            MIN_TILES, MAX_KEYS, MAX_SPAN, MAX_CHUNK, PROBE_SMEM,
            BUCKET_FILL):
    """:func:`order_sizing` with the constants as arguments (scripts patch
    them), cached: it runs on the host before a call's first launch."""
    tile = next((t for t in TILES
                 if 4 * t * max(rec_words + 1, UNSORT_WORDS) <= TILE_SMEM
                 and b >= MIN_TILES * t), TILES[-1])
    sw = max(rec_words, out_words)
    chunk = MAX_CHUNK
    while chunk > 32 and 4 * (chunk * sw + MAX_SPAN) + 2 * chunk > PROBE_SMEM:
        chunk //= 2
    shift = 0
    while ((1 << shift) < min(MAX_SPAN, n_bins)
           and b * (2 << shift) <= BUCKET_FILL * chunk * n_bins):
        shift += 1
    while ((n_bins - 1) >> shift) + 1 > MAX_KEYS:
        shift += 1
    if (1 << shift) > MAX_SPAN:
        raise ValueError(f"{n_bins} bins: the bin order takes at most "
                         f"{MAX_KEYS * MAX_SPAN}")
    n_keys = ((n_bins - 1) >> shift) + 1
    return OrderSizing(tile, shift, n_keys, chunk,
                       -(-b // chunk) + min(n_keys, b), rec_words, out_words)


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Where a probe finds things in a packed candidate row.

    kind: "quantized" (int16 probe geometry + f32 value planes, queries
      in the bin's local frame), "simplex" (unit planes + premultiplied
      vertex data), "quad" (planes + vertices + raw vertex data) or
      "qdf" (accurate mode: the quantized probe + df32 value planes,
      queries as a hi/lo r_local).
    nf: faces (== vertices) per cell; k: candidates per row;
    id_role: role of the cell ids; count_col: column of the count (the
      quantized layout's dscale follows it);
    var_roles: first role of each requested fused variable.
    """

    kind: str
    nf: int
    k: int
    id_role: int
    count_col: int
    var_roles: tuple


def probe_inputs_plain(r, rmin, inv_h, shape, quantized):
    """(idx (B,) int32, rq (B, 3)) of a direct probe of (B, 3) queries on
    the candidate bins (origin ``rmin``, inverse sizes ``inv_h``,
    ``shape`` bins per axis): each query's flat bin, and the query in
    that bin's local frame when the rows are quantized."""
    ijk = geometry.bin_ijk(r, rmin, inv_h, shape, torch.int32)
    idx = geometry.bin_flat(ijk, shape)
    if quantized:
        return idx, geometry.cand_local_frame(r, rmin, inv_h, ijk)
    return idx, r.contiguous()


def local_frame_df(r_hi, r_lo, rmin, inv_h, ijk):
    """(hi, lo) split of r_local = r - bin_center, each (B, 3): hi =
    fl(r_hi - c) and lo its error-free residual (two_sum) plus the query's
    own residual ``r_lo`` -- the JAX package's ``_cand_local_df_t``, so
    the df32 plane evaluation sees r_local to float64-grade precision.
    hi equals the quantized probe's r_local bit for bit."""
    cs = geometry.cand_bin_center_cols(rmin, inv_h, *ijk)
    his, los = [], []
    for d in range(3):
        hi, err = df32.two_sum(r_hi[:, d], -cs[d])
        his.append(hi)
        los.append(err + r_lo[:, d])
    return torch.stack(his, dim=1), torch.stack(los, dim=1)


def probe_inputs_df_plain(r, r_lo, rmin, inv_h, shape):
    """(idx (B,) int32, rq (B, 3), rq_lo (B, 3)) of a df-plane probe of
    the queries ``r`` (float64, split by :func:`df32.split_queries`, or
    float32 with their lo parts ``r_lo``, None for zeros): each query's
    flat bin from its hi part, and the hi/lo local frame."""
    if r_lo is None:
        r_hi, r_lo = df32.split_queries(r)
    else:
        r_hi = r
    ijk = geometry.bin_ijk(r_hi, rmin, inv_h, shape, torch.int32)
    return (geometry.bin_flat(ijk, shape),
            *local_frame_df(r_hi, r_lo, rmin, inv_h, ijk))


def bin_order_plain(idx):
    """Plain version of the bin ordering: the permutation (B,) int64 that
    groups queries by their flat bin ``idx``, in ascending bin order and,
    in a bin, in query order (a stable sort)."""
    return torch.argsort(idx, stable=True)


def cand_order_plain(idx, sizing):
    """Plain twin of the bin order of the kernels, from each query's flat
    bin ``idx`` (B,): the coarse order (by key ``idx >> span_shift``; in
    a key, in query order, where the kernels keep the order of their
    atomics), each bucket cut into chunks of at most ``sizing.chunk``
    queries, each chunk in ascending flat order (stable).  Returns (perm
    (B,) int64: the queries in the order the probe takes them; chunk
    (B,) int64: the chunk that takes each of them, nondecreasing)."""
    idx = idx.long()
    key = idx >> sizing.span_shift
    coarse = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=sizing.n_keys)
    starts = torch.cumsum(counts, 0) - counts
    per = (counts + sizing.chunk - 1) // sizing.chunk
    first = torch.cumsum(per, 0) - per
    k = key[coarse]
    at = torch.arange(idx.shape[0], device=idx.device) - starts[k]
    chunk = first[k] + at // sizing.chunk
    fine = torch.argsort(chunk * (sizing.n_keys << sizing.span_shift)
                         + idx[coarse], stable=True)
    return coarse[fine], chunk[fine]


def order_scan_plain(idx, sizing):
    """Plain version of the key pass's counts and the scan, from each
    query's flat bin ``idx``: (counts, starts, chunk_end), (n_keys,)
    int32: the queries a key, where its bucket starts in coarse order,
    and the inclusive scan of its chunks."""
    key = idx.long() >> sizing.span_shift
    counts = torch.bincount(key, minlength=sizing.n_keys)
    per = (counts + sizing.chunk - 1) // sizing.chunk
    return (counts.to(torch.int32), (torch.cumsum(counts, 0) - counts).to(
        torch.int32), torch.cumsum(per, 0).to(torch.int32))


def order_records_plain(r, df=False, r_lo=None):
    """Plain version of the scatter's records: (B, 3) or (B, 6) int32
    words of each query as the probe reads it: float32 x, y, z; a float64
    grid's doubles (``r`` float64, ``df`` False); for the df-plane rows
    (``df``) the float32 hi and lo of :func:`df32.split_queries`, or
    float32 ``r`` and its lo parts ``r_lo`` (None: zeros)."""
    if df:
        if r.dtype == torch.float64:
            hi, lo = df32.split_queries(r)
        else:
            hi, lo = r, torch.zeros_like(r) if r_lo is None else r_lo
        r = torch.cat([hi, lo], 1)
    return r.contiguous().view(torch.int32)


def order_mismatches(order, idx, words):
    """The entries of the :class:`BinOrder` ``order`` that break its
    contract, against the plain versions, from each query's flat bin
    ``idx`` and record ``words`` (:func:`order_records_plain`): counts,
    starts and chunk_end unlike :func:`order_scan_plain`; slot not a
    permutation that puts each query inside its key's bucket; a record
    at a query's slot unlike its words; pos not the query's place among
    the slots of its tile.  0 for a sound order."""
    sz = order.sizing
    b = idx.shape[0]
    bad = sum(int((a != w).sum()) for a, w in zip(
        (order.counts, order.starts, order.chunk_end),
        order_scan_plain(idx, sz)))
    if b == 0:
        return bad
    q = torch.arange(b, device=idx.device)
    slot = order.slot.long()
    key = idx.long() >> sz.span_shift
    lo = order.starts.long()[key]
    bad += int((torch.sort(slot).values != q).sum())
    bad += int(((slot < lo) | (slot >= lo + order.counts.long()[key])).sum())
    bad += int((order.rec[slot.clamp(0, b - 1)] != words).any(1).sum())
    tile = q // sz.tile
    by = torch.argsort(tile * b + slot.clamp(0, b - 1))
    pos = torch.empty_like(q)
    pos[by] = q - tile[by] * sz.tile
    return bad + int((order.pos.long() != pos).sum())


@functools.lru_cache(maxsize=64)
def _var_roles(var_roles, device):
    """The (V,) int32 role columns on ``device``, made once: a copy from
    host memory would make the host wait for the kernels queued before
    it."""
    return torch.tensor(var_roles, dtype=torch.int32, device=device)


def _gather_rows(table, idx):
    """``table[idx]``, moving float32 rows as int32 bits (packed int16
    words are often NaN patterns, which a float copy may not keep)."""
    if table.dtype == torch.float32:
        return table.view(torch.int32)[idx.long()].view(torch.float32)
    return table[idx.long()]


def _margins_plain(g, rq, lay):
    """(b, W) rows, (b, 3) queries -> per-face margins [(b, K)] * nf and
    the masked cell margins (b, K), in the kernel's rounding order."""
    K, nf = lay.k, lay.nf
    rx, ry, rz = rq[:, 0:1], rq[:, 1:2], rq[:, 2:3]

    def role(j):
        return g[:, j * K:(j + 1) * K]

    m_faces = []
    if lay.kind in _QUANTIZED_KINDS:
        gi = g.view(torch.int32)
        s_n = -(-3 * nf // 2)
        inv = torch.tensor(QINV, dtype=torch.float32, device=g.device)
        ds = g[:, lay.count_col + 1: lay.count_col + 2]

        def unpack(j):  # slot j -> (even, odd) int16 components as f32
            w = gi[:, j * K:(j + 1) * K]
            return ((w << 16) >> 16).to(torch.float32), (w >> 16).to(
                torch.float32
            )

        comps = []
        for s in range(s_n):
            comps.extend(unpack(s))
        dcomps = []
        for s in range(-(-nf // 2)):
            dcomps.extend(unpack(s_n + s))
        for f in range(nf):
            proj = (
                (comps[3 * f] * rx + comps[3 * f + 1] * ry)
                + comps[3 * f + 2] * rz
            ) * inv
            m_faces.append(dcomps[f] * ds - proj)
    else:
        for f in range(nf):
            proj = (role(f) * rx + role(nf + f) * ry) + role(2 * nf + f) * rz
            m_faces.append(role(3 * nf + f) - proj)
    margins = m_faces[0]
    for mf in m_faces[1:]:
        margins = torch.minimum(margins, mf)
    if lay.kind in _QUANTIZED_KINDS:
        # padding slots carry no huge-offset sentinel (int16 can't hold
        # one): mask them by the id sign
        margins = torch.where(
            role(lay.id_role) < 0, torch.full_like(margins, -1e30), margins
        )
    return m_faces, margins


def _probe_plain(g, rq, lay, eps, ovf_base, rq_lo=None):
    """Probe of gathered rows g (b, W); see :func:`probe_rows_plain`.
    For the "qdf" kind the values are (b, 2V): hi columns, then lo."""
    K, nf = lay.k, lay.nf
    npc = nf
    rx, ry, rz = rq[:, 0], rq[:, 1], rq[:, 2]
    m_faces, margins = _margins_plain(g, rq, lay)
    k_best = torch.argmax(margins, dim=1)[:, None]  # first occurrence
    m_best = margins.gather(1, k_best)[:, 0]

    def pick(j):  # role j of the winner, (b,)
        return g[:, j * K:(j + 1) * K].gather(1, k_best)[:, 0]

    id_best = pick(lay.id_role).to(torch.int32)
    cnt = g[:, lay.count_col].to(torch.int32)
    neg_eps = torch.tensor(-eps, dtype=g.dtype, device=g.device)
    found = (m_best >= neg_eps) & (id_best >= 0)
    ovf_miss = (~found) & (cnt > ovf_base) & (id_best >= 0)
    aux = torch.where(
        found, -2, torch.where(ovf_miss, cnt - (ovf_base + 1), -1)
    ).to(torch.int32)

    vals = []
    if lay.kind == "qdf":
        # df32 value planes: the winner's plane, then v = g . r_local +
        # c_loc in compensated f32 with the hi/lo r_local
        rl = [(rq[:, d], rq_lo[:, d]) for d in range(3)]
        his, los = [], []
        for pr in lay.var_roles:
            acc = (pick(pr + 6), pick(pr + 7))  # c_loc
            for d in range(3):
                acc = df32.add(acc, df32.mul((pick(pr + d), pick(pr + 3 + d)),
                                             rl[d]))
            his.append(acc[0])
            los.append(acc[1])
        vals = his + los
    elif lay.kind == "quantized":
        # exact per-cell value planes: value = g . r_local + c
        for pr in lay.var_roles:
            vals.append(
                ((pick(pr) * rx + pick(pr + 1) * ry) + pick(pr + 2) * rz)
                + pick(pr + 3)
            )
    elif lay.kind == "quad":
        v0 = 4 * nf
        p = [[pick(v0 + v * 3 + d) for d in range(3)] for v in range(npc)]
        w = wkern.quad_weights_generic(p, (rx, ry, rz), wkern.Plain(g.dtype))
        for dr in lay.var_roles:
            acc = w[0] * pick(dr)
            for v in range(1, npc):
                acc = acc + w[v] * pick(dr + v)
            vals.append(acc)
    else:
        # barycentric straight from margins: the packed data of vertex v
        # is premultiplied by its inverse height, so the weight of
        # vertex v is the margin of face (v+1) % npc
        mw = [mf.gather(1, k_best)[:, 0] for mf in m_faces]
        for dr in lay.var_roles:
            acc = mw[1 % npc] * pick(dr)
            for v in range(1, npc):
                acc = acc + mw[(v + 1) % npc] * pick(dr + v)
            vals.append(acc)
    if vals:
        values = torch.stack(vals, dim=1)
    else:
        values = g.new_zeros((g.shape[0], 0))
    return id_best, aux, values


def probe_rows_plain(table, idx, rq, lay, eps, ovf_base, chunk, rq_lo=None):
    """Plain PyTorch version of B2 (model: the JAX package's
    ``ops/locate._probe_rows_xla``), on any device and float dtype.
    Rows are gathered ``chunk`` queries at a time so the gathered
    (chunk, W) block stays bounded.

    Args:
      table: (n_rows, W) packed rows (main or extension table).
      idx: (B,) row of each query.
      rq: (B, 3) queries — r_local (query minus bin center) for the
        quantized layouts, r otherwise.
      lay: the table's :class:`RowLayout`.
      eps: inside tolerance (plus the grid's cand_qeps when quantized).
      ovf_base: count above which a miss is an overflow-bin miss
        (main table: K; extension table: K + k_ext).
      rq_lo: (B, 3) lo parts of r_local, for the "qdf" kind.
    Returns (id_best (B,) int32, aux (B,) int32, values (B, V)); for the
    "qdf" kind values is (B, 2V), hi columns then lo columns.
    """
    outs = [
        _probe_plain(
            _gather_rows(table, idx[lo: lo + chunk]), rq[lo: lo + chunk],
            lay, eps, ovf_base,
            None if rq_lo is None else rq_lo[lo: lo + chunk],
        )
        for lo in range(0, idx.shape[0], chunk)
    ]
    if not outs:
        z = torch.zeros(0, dtype=torch.int32, device=idx.device)
        n_out = len(lay.var_roles) * (2 if lay.kind == "qdf" else 1)
        return z, z, rq.new_zeros((0, n_out))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def probe_rows_ext_plain(table, ext_table, idx, rq, lay, lay_ext, eps,
                         ovf_base, chunk):
    """Plain PyTorch version of the probe with extension rows (model: the
    JAX package's ``_candidates_query`` merge, ops/locate.py:892-975), on
    any device and float dtype: :func:`probe_rows_plain` on the main
    table, then on the extension row (slot ``aux``) of every overflow
    miss, in the main rows' frame ``rq``, with ``ovf_base + lay_ext.k``,
    then the merge.  A query found in its extension row takes that
    winner's id, verdict and values; one that the extension row does not
    hold keeps the main winner's id and values with the extension row's
    verdict: -1 for an exact miss, >= 0 where even K + k_ext candidates
    did not hold the bin (its residual walk starts from the main
    winner).  Returns (id_best (B,) int32, aux (B,) int32, values (B,
    V))."""
    id_best, aux, values = probe_rows_plain(table, idx, rq, lay, eps,
                                            ovf_base, chunk)
    sel = torch.nonzero(aux >= 0).squeeze(1)
    if sel.numel() == 0:
        return id_best, aux, values
    chunk_ext = max(1, chunk * table.shape[1] // ext_table.shape[1])
    id2, aux2, vals2 = probe_rows_plain(
        ext_table, aux[sel], rq[sel], lay_ext, eps, ovf_base + lay_ext.k,
        chunk_ext)
    found2 = aux2 == -2
    id_best[sel] = torch.where(found2, id2, id_best[sel])
    aux[sel] = aux2
    values[sel] = torch.where(found2[:, None], vals2, values[sel])
    return id_best, aux, values


def probe_rows_df_plain(table, idx, rq, rq_lo, lay, eps, ovf_base, chunk):
    """Plain PyTorch version of B2's df-plane branch ("qdf" rows).
    Returns (id_best, aux, vals_hi (B, V), vals_lo (B, V))."""
    id_best, aux, vals = probe_rows_plain(table, idx, rq, lay, eps, ovf_base,
                                          chunk, rq_lo=rq_lo)
    n = len(lay.var_roles)
    return id_best, aux, vals[:, :n], vals[:, n:]


def cand_rows_df_plain(table, r, r_lo, rmin, inv_h, shape, lay, eps,
                       ovf_base, chunk):
    """Plain PyTorch version of the df-plane query in bin order, from the
    same inputs as :func:`cand_rows_df_query` (any device; in query
    order, which no query's result depends on).  Returns (id_best, aux,
    vals_hi (B, V), vals_lo (B, V))."""
    idx, rq, rq_lo = probe_inputs_df_plain(r, r_lo, rmin, inv_h, shape)
    return probe_rows_df_plain(table, idx, rq, rq_lo, lay, eps, ovf_base,
                               chunk)


def binned_lanes(n_queries, n_bins):
    """Lanes per query of the probe in bin order, from the batch's queries
    per bin.  tools/b2_sweep.py on the 998k-tet box (H100, PERF.md §6),
    the chunk probe: 4 lanes (with 8) the fastest at 0.5 and 1 query a
    bin, 4 by 3% over 2 at 2 a bin, 2 (with 1) the fastest at 5 a bin;
    one lane alone is slow where it walks a whole row for one query, and
    a group where the queries of a bin repeat its per-query work."""
    return 2 if n_queries >= 4 * n_bins else 4


def _check_table(table, lay):
    """The kernels take float32 tables, and a float64 grid's "simplex"
    and "quad" rows in float64."""
    if table.dtype == torch.float32 or (
            table.dtype == torch.float64 and lay.kind in ("simplex", "quad")):
        return
    raise TypeError(f"the CUDA candidate kernel takes float32 tables, or "
                    f"float64 simplex and quad rows, got {table.dtype} "
                    f"{lay.kind!r} rows")


def _check_bins(r, rmin, inv_h, shape):
    """Check the queries (float32, or float64) and bin grid (float32, or
    float64 with float64 queries: a float64 grid's) of a bin-ordered
    launch; returns the contiguous (r, rmin, inv_h) and the number of
    bins."""
    if (r.dtype not in (torch.float32, torch.float64) or r.ndim != 2
            or r.shape[1] != 3):
        raise TypeError(f"queries must be float32 or float64 (B, 3), got "
                        f"{r.dtype} {tuple(r.shape)}")
    for t in (rmin, inv_h):
        if t.dtype != rmin.dtype or t.shape != (3,) or not (
                t.dtype == torch.float32 or t.dtype == r.dtype):
            raise ValueError("bin origin and inverse sizes must be float32 "
                             "(3,), or float64 with float64 queries")
    if not r.device == rmin.device == inv_h.device:
        raise ValueError("queries and bin grid must share one device")
    n_bins = int(math.prod(shape))
    if len(shape) != 3 or min(shape) < 1 or n_bins >= 2**31:
        raise ValueError(f"bad bin grid shape {shape}")
    return r.contiguous(), rmin.contiguous(), inv_h.contiguous(), n_bins


class BinOrder(NamedTuple):
    """A batch in coarse bin order (:func:`bin_order_cuda`): ``rec``
    (B, rec_words) int32, each query's record at its slot (float32 x, y,
    z; or six words: a float64 grid's doubles, or the df-plane rows'
    float32 hi and lo); ``slot`` (B,) int32, each query's position in
    coarse order; ``pos`` (B,) int32, its position among its tile's
    slots; ``counts``, ``starts`` and ``chunk_end`` (n_keys,) int32: the
    queries a key, where its bucket starts, and the inclusive scan of
    its chunks; the :class:`OrderSizing`."""

    rec: torch.Tensor
    slot: torch.Tensor
    pos: torch.Tensor
    counts: torch.Tensor
    starts: torch.Tensor
    chunk_end: torch.Tensor
    sizing: OrderSizing


def out_words(lay, table):
    """4-byte words of a query's result on ``table`` with layout ``lay``:
    id, aux and the values (hi and lo floats of the df-plane rows, two
    words a double)."""
    n_vars = len(lay.var_roles)
    wide = lay.kind == "qdf" or table.dtype == torch.float64
    return 2 + (2 * n_vars if wide else n_vars)


def _count_order(b, split):
    """While tracing, count the queries taken in bin order and the split
    buckets (``split``: a 0-d device count, read in the report)."""
    timing.metrics.count("cand_order.queries", b)
    timing.metrics.count("cand_order.split_buckets", split)


@timing.spanned("iu.locate.bin_order")
def bin_order_cuda(r, rmin, inv_h, shape, n_out, df=False, r_lo=None):
    """Launch the key pass, the scan and the scatter on CUDA tensors: (B,
    3) float32 queries with the (3,) float32 bin origin and inverse
    sizes, or a float64 grid's float64 queries and bin grid (binned in
    double); for the df-plane rows (``df``) float64 queries (split into
    float32 hi and lo, binned by hi) or float32 ones with their lo parts
    ``r_lo`` (None: zeros).  ``n_out``: words of a result of the probe
    that will take the order (:func:`out_words`).  Returns the
    :class:`BinOrder`: the queries grouped by coarse key in ascending key
    order, a key's queries in no fixed order."""
    global bin_pass_launches, bin_scatter_launches
    r, rmin, inv_h, n_bins = _check_bins(r, rmin, inv_h, shape)
    grid64 = rmin.dtype == torch.float64
    if grid64 and df:
        raise TypeError("the df-plane rows take a float32 bin grid")
    if r.dtype == torch.float64 and not (grid64 or df):
        raise TypeError("float64 queries on a float32 grid are taken by the "
                        "df-plane rows only")
    if r_lo is not None:
        if (not df or r.dtype != torch.float32 or r_lo.dtype != torch.float32
                or r_lo.shape != r.shape):
            raise ValueError("r_lo must be the float32 (B, 3) lo parts of "
                             "float32 df-plane queries")
        if r_lo.device != r.device:
            raise ValueError("r and r_lo must share one device")
        r_lo = r_lo.contiguous()
    mode = 3 if grid64 else (1 if r.dtype == torch.float64 else 2) if df \
        else 0
    b = r.shape[0]
    sz = order_sizing(b, n_bins, 3 if mode == 0 else 6, n_out)
    dev = r.device

    def ints(*size):
        return torch.empty(size, dtype=torch.int32, device=dev)

    # the counts (zeroed for the key pass), starts and chunk ends
    counts, starts, chunk_end = torch.zeros((3, sz.n_keys), dtype=torch.int32,
                                            device=dev)
    if b == 0:  # no query: no bucket starts anywhere, no chunk
        return BinOrder(ints(0, sz.rec_words), ints(0), ints(0), counts,
                        starts, chunk_end, sz)
    order = BinOrder(ints(b, sz.rec_words), *ints(2, b), counts, starts,
                     chunk_end, sz)
    split = None
    if timing.tracing():
        split = torch.zeros((), dtype=torch.int32, device=dev)
        _count_order(b, split)
    key, rank = ints(2, b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _kernels.lib()
    outs = (sz.span_shift, sz.n_keys, sz.tile, counts.data_ptr(),
            key.data_ptr(), rank.data_ptr(), order.pos.data_ptr(), stream)
    with torch.cuda.device(dev):
        if grid64:
            code = lib.iu_cand_key_f64(r.data_ptr(), b, rmin.data_ptr(),
                                       inv_h.data_ptr(), *shape, *outs)
        else:
            code = lib.iu_cand_key(
                r.data_ptr(), int(r.dtype == torch.float64), b,
                rmin.data_ptr(), inv_h.data_ptr(), *shape, *outs)
        _kernels.check(code, "iu_cand_key")
        code = lib.iu_cand_key_scan(
            counts.data_ptr(), sz.n_keys, sz.chunk, order.starts.data_ptr(),
            order.chunk_end.data_ptr(),
            None if split is None else split.data_ptr(), stream)
        _kernels.check(code, "iu_cand_key_scan")
        bin_pass_launches += 1
        code = lib.iu_cand_key_scatter(
            r.data_ptr(), None if r_lo is None else r_lo.data_ptr(), mode, b,
            sz.tile, key.data_ptr(), rank.data_ptr(), order.pos.data_ptr(),
            order.starts.data_ptr(), order.rec.data_ptr(),
            order.slot.data_ptr(), stream)
        _kernels.check(code, "iu_cand_key_scatter")
        bin_scatter_launches += 1
    return order


@timing.spanned("iu.locate.probe")
def cand_rows_binned_cuda(table, order, rmin, inv_h, shape, lay, eps,
                          ovf_base, lanes=None, ext=None, fill=None):
    """Launch the probe and the unsort on CUDA tensors: float32 table (one
    row per bin) with the float32 bin grid, or a float64 grid's float64
    table and bin grid; ``order`` the :class:`BinOrder` of the queries
    (:func:`bin_order_cuda`, for the df-plane rows ("qdf") with
    ``df=True``).  A block takes a chunk of a coarse bucket, puts it in
    bin order in shared memory and probes it there, a group of ``lanes``
    lanes (None: :func:`binned_lanes`) a query (the kernel computes the
    queries' bins and, for quantized rows, their local frame; for "qdf"
    their hi/lo local frame), and writes the chunk's records back in
    coarse order; the unsort puts them back in query order.  ``ext``:
    (extension table, its :class:`RowLayout`) of a grid with extension
    rows (layouts 0-2), whose overflow misses the same launch probes
    there and merges as :func:`probe_rows_ext_plain` does.  Returns
    (id_best, aux, values) in query order; for "qdf" values is (B, 2V),
    hi columns then lo.  ``fill`` (a scalar, not for "qdf"): the unsort
    writes the finished outputs instead, (i_cell: id_best where found,
    else -1; found (B,) bool; values, ``fill`` where not found)."""
    global binned_launches, ext_launches, df_launches, bin_unsort_launches
    df = lay.kind == "qdf"
    if lay.kind not in ("quantized", "simplex", "quad", "qdf"):
        raise ValueError(f"unknown row kind {lay.kind!r}")
    if not isinstance(order, BinOrder):
        raise TypeError("order must be the BinOrder of bin_order_cuda")
    rec, slot, pos, counts, starts, chunk_end, sz = order
    for t in (rmin, inv_h):
        if t.dtype != rmin.dtype or t.shape != (3,):
            raise ValueError("bin origin and inverse sizes must be (3,) of "
                             "one dtype")
    n_bins = int(math.prod(shape))
    if len(shape) != 3 or min(shape) < 1 or n_bins >= 2**31:
        raise ValueError(f"bad bin grid shape {shape}")
    _check_table(table, lay)
    grid64 = table.dtype == torch.float64  # a float64 grid's rows
    if grid64 != (rmin.dtype == torch.float64):
        raise TypeError("a float64 table takes a float64 bin grid, a float32 "
                        "table a float32 one")
    b = slot.shape[0]
    if sz.rec_words != (6 if df or grid64 else 3) or rec.shape != (
            b, sz.rec_words):
        raise ValueError("the order's records do not suit these rows "
                         "(bin_order_cuda with df=True for the df-plane "
                         "rows)")
    if sz.out_words != out_words(lay, table):
        raise ValueError(f"the order was sized for {sz.out_words} words a "
                         f"result, these rows give {out_words(lay, table)}")
    if sz.n_keys != ((n_bins - 1) >> sz.span_shift) + 1:
        raise ValueError("the order was made for another bin grid")
    if not (table.device == rec.device == slot.device == rmin.device
            == inv_h.device):
        raise ValueError("table, order and bin grid must share one device")
    if (table.ndim != 2 or not table.is_contiguous()
            or table.shape[0] != n_bins):
        raise ValueError("table must be a contiguous (n_bins, W) tensor")
    tail = 2 if lay.kind in _QUANTIZED_KINDS else 1
    if lay.count_col + tail > table.shape[1]:
        raise ValueError(f"row layout {lay} does not fit width {table.shape[1]}")
    ext_args = (None, 0, 0, 0)
    if ext is not None:
        ext_table, lay_ext = ext
        if df or (lay_ext.kind, lay_ext.nf, lay_ext.id_role,
                  lay_ext.var_roles) != (lay.kind, lay.nf, lay.id_role,
                                         lay.var_roles):
            raise ValueError("extension rows take the main rows' layout "
                             "(layouts 0-2) with their own k")
        if (ext_table.dtype != table.dtype or ext_table.device != table.device
                or ext_table.ndim != 2 or not ext_table.is_contiguous()
                or lay_ext.count_col + tail > ext_table.shape[1]
                or lay_ext.k < 1):
            raise ValueError("the extension table must be a contiguous "
                             "(n_ext, W) tensor of the table's dtype and "
                             "device that its layout fits")
        ext_args = (ext_table.data_ptr(), ext_table.shape[1], lay_ext.k,
                    lay_ext.count_col)
    if fill is not None and df:
        raise ValueError("the df-plane rows' values are not filled")
    if lanes is None:
        lanes = binned_lanes(b, n_bins)
    if lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"lanes must be a power of two up to 32, got {lanes}")
    rmin, inv_h = rmin.contiguous(), inv_h.contiguous()
    dev = table.device
    n_vars = len(lay.var_roles)
    n_words = sz.out_words - 2
    vroles = _var_roles(lay.var_roles, dev)
    finish = fill is not None
    out_id = torch.empty(b, dtype=torch.int32, device=dev)
    # aux, or the found mask of the finished outputs
    out_aux = torch.empty(b, dtype=torch.bool if finish else torch.int32,
                          device=dev)
    vals = torch.empty((b, n_vars if grid64 else n_words), dtype=table.dtype,
                       device=dev)
    if b == 0:
        return out_id, out_aux, vals
    # the fill value's 4-byte words, as the values' dtype holds it
    fill_words = (0, 0) if not finish else tuple(int(w) for w in np.array(
        [fill], dtype=np.float64 if grid64 else np.float32).view(
            np.int32)) + (0,)
    res = torch.empty((b, sz.out_words), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    chunks = (rec.data_ptr(), starts.data_ptr(), counts.data_ptr(),
              chunk_end.data_ptr(), sz.n_keys, sz.span_shift, sz.chunk,
              sz.max_chunks, lanes, rmin.data_ptr(), inv_h.data_ptr(),
              *shape, lay.k, lay.nf, _KIND_CODE[lay.kind], lay.id_role,
              lay.count_col, float(eps), int(ovf_base))
    with torch.cuda.device(dev):
        if grid64:
            code = _kernels.lib().iu_cand_rows_chunked_f64(
                table.data_ptr(), table.shape[1], *chunks, n_vars,
                vroles.data_ptr(), *ext_args, res.data_ptr(), stream)
        else:
            code = _kernels.lib().iu_cand_rows_chunked(
                table.data_ptr(), table.shape[1], *chunks, QINV, n_vars,
                vroles.data_ptr(), *ext_args, res.data_ptr(), stream)
        _kernels.check(code, "iu_cand_rows_chunked")
        if df:
            df_launches += 1
        elif ext is not None:
            ext_launches += 1
        else:
            binned_launches += 1
        code = _kernels.lib().iu_cand_key_unsort(
            res.data_ptr(), slot.data_ptr(), pos.data_ptr(), b, sz.tile,
            sz.out_words, out_id.data_ptr(),
            None if finish else out_aux.data_ptr(), vals.data_ptr(),
            out_aux.data_ptr() if finish else None, int(finish),
            fill_words[0], fill_words[1], 2 if grid64 else 1, stream)
        _kernels.check(code, "iu_cand_key_unsort")
        bin_unsort_launches += 1
    return out_id, out_aux, vals


def cand_rows_binned_query(table, r, rmin, inv_h, shape, lay, eps, ovf_base,
                           chunk, ext=None):
    """The candidate probe in bin order, from the queries themselves:
    ``table`` holds one row per candidate bin of the grid (origin
    ``rmin``, inverse sizes ``inv_h``, ``shape`` bins per axis); ``ext``:
    (extension table, its :class:`RowLayout`) of a grid with extension
    rows, or None.  The key pass, scan, scatter, probe (with the
    extension probe of the overflow misses where ``ext`` is given) and
    unsort kernels for CUDA tensors; for CPU tensors the plain version,
    :func:`probe_rows_plain` (:func:`probe_rows_ext_plain` with ``ext``)
    in query order (a query's result does not depend on the order).
    Returns (id_best (B,) int32, aux (B,) int32, values (B, V)) in query
    order."""
    if table.device.type == "cuda":
        _check_table(table, lay)  # before the key pass
        order = bin_order_cuda(r, rmin, inv_h, shape, out_words(lay, table))
        return cand_rows_binned_cuda(table, order, rmin, inv_h, shape, lay,
                                     eps, ovf_base, ext=ext)
    if table.device.type == "cpu":
        with timing.span("iu.locate.probe", table.device):
            idx, rq = probe_inputs_plain(r, rmin, inv_h, shape,
                                         lay.kind == "quantized")
            if ext is not None:
                return probe_rows_ext_plain(table, ext[0], idx, rq, lay,
                                            ext[1], eps, ovf_base, chunk)
            return probe_rows_plain(table, idx, rq, lay, eps, ovf_base,
                                    chunk)
    raise ValueError(f"no candidate probe for device {table.device}")


def cand_rows_found_query(table, r, rmin, inv_h, shape, lay, eps, ovf_base,
                          chunk, ext=None, fill=math.nan):
    """The candidate probe's finished outputs, as :func:`cand_rows_binned_query`
    takes it: (i_cell (B,) int32, the winner where found, else -1; found
    (B,) bool; values (B, V), the scalar ``fill`` where not found).  On
    CUDA tensors the unsort writes them; on CPU tensors torch.where makes
    them from the plain probe's outputs."""
    if table.device.type == "cuda":
        _check_table(table, lay)
        order = bin_order_cuda(r, rmin, inv_h, shape, out_words(lay, table))
        return cand_rows_binned_cuda(table, order, rmin, inv_h, shape, lay,
                                     eps, ovf_base, ext=ext, fill=fill)
    id_best, aux, values = cand_rows_binned_query(
        table, r, rmin, inv_h, shape, lay, eps, ovf_base, chunk, ext)
    found = aux == -2
    return (torch.where(found, id_best, -1), found,
            torch.where(found[:, None], values, float(fill)))


def cand_rows_df_query(table, r, r_lo, rmin, inv_h, shape, lay, eps,
                       ovf_base, chunk):
    """The df-plane probe of accurate mode in bin order, from the queries
    as given: float64 ``r`` (``r_lo`` None), or float32 ``r`` with its lo
    parts ``r_lo`` (None: zeros); ``table`` holds one df-plane row per
    candidate bin.  The key pass, scan, scatter (which splits the
    queries), df probe and unsort kernels for CUDA tensors; for CPU
    tensors the plain version, :func:`cand_rows_df_plain`.  Returns
    (id_best, aux, vals_hi (B, V), vals_lo (B, V)) in query order."""
    if table.device.type == "cuda":
        _check_table(table, lay)
        if r.dtype == torch.float64 and r_lo is not None:
            raise TypeError("float64 queries are taken without r_lo")
        order = bin_order_cuda(r, rmin, inv_h, shape, out_words(lay, table),
                               df=True, r_lo=r_lo)
        id_best, aux, vals = cand_rows_binned_cuda(
            table, order, rmin, inv_h, shape, lay, eps, ovf_base)
        n = len(lay.var_roles)
        return id_best, aux, vals[:, :n], vals[:, n:]
    if table.device.type == "cpu":
        return cand_rows_df_plain(table, r, r_lo, rmin, inv_h, shape, lay,
                                  eps, ovf_base, chunk)
    raise ValueError(f"no candidate probe for device {table.device}")
