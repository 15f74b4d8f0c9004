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

:func:`cand_rows_query` launches the direct CUDA kernel
(``csrc/cand_rows.cu``, one warp per query in query order) on CUDA
tensors and runs the plain PyTorch version (:func:`probe_rows_plain`) on
CPU tensors; it serves the extension table.  The main table is probed in
bin order by :func:`cand_rows_binned_query`: on CUDA tensors a bin pass
and a scatter kernel group the queries by bin (:func:`bin_order_cuda`),
the probe kernel takes them in that order, a group of lanes per query
(:func:`binned_lanes`), and writes each query's record at its sorted
slot, and an unsort kernel puts the records back in query order
(:func:`cand_rows_binned_cuda`); on CPU tensors the plain version,
:func:`probe_rows_plain`, probes in query order (:func:`bin_order_plain`
is the scatter's plain twin).  The df-plane rows take the same four
kernels from the queries as given, float64 or a float32 hi/lo pair,
which the kernels split and carry into the hi/lo local frame themselves
(:func:`cand_rows_df_query`); the plain version is
:func:`cand_rows_df_plain` (:func:`probe_inputs_df_plain`, then
:func:`probe_rows_df_plain`).  ``launches`` counts the direct kernel's
launches, ``bin_pass_launches``, ``bin_scatter_launches`` and
``bin_unsort_launches`` those of the bin-ordered front end (both row
kinds), ``binned_launches`` the probe in bin order of the f32 layouts and
``df_launches`` that of the df-plane rows.

A float64 grid's rows ("simplex" and "quad" in float64, never quantized)
take the same direct kernel, bin pass, probe and unsort, instantiated for
double (the ``*_f64`` entry points, scalars as C doubles): the bin pass
bins the float64 queries in double against the grid's float64 origin and
inverse sizes, and a record carries each double value as two int32
words, which the unsort moves as it moves any word.  They count in the
same counters.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _kernels, df32, geometry, wkern

launches = 0  # direct launches (B2, the extension rows)
df_launches = 0  # probe in bin order of the df-plane rows (B2-df)
bin_pass_launches = 0  # bin pass of the bin-ordered probe
bin_scatter_launches = 0  # scatter of the bin-ordered probe
binned_launches = 0  # probe in bin order (main table, f32 layouts)
bin_unsort_launches = 0  # unsort of the bin-ordered probe's records

_KIND_CODE = {"quantized": 0, "simplex": 1, "quad": 2, "qdf": 3}
_QUANTIZED_KINDS = ("quantized", "qdf")
# 1/32767 rounded to float32, as the JAX kernel's jnp.float32(1/32767)
QINV = float(np.float32(1.0 / 32767.0))


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


def cand_rows_cuda(table, idx, rq, lay, eps, ovf_base):
    """Launch B2's direct kernel on CUDA tensors: a float32 or float64
    table (float64: "simplex" or "quad" rows), int32 idx, rq of the
    table's dtype.  The kernel reads each query's row from the table
    itself.  Returns (id_best, aux, values)."""
    global launches
    if lay.kind not in ("quantized", "simplex", "quad"):
        raise ValueError(f"{lay.kind!r} rows are probed in bin order")
    _check_table(table, lay)
    if rq.dtype != table.dtype:
        raise TypeError(
            "the CUDA candidate kernel takes queries of the table's dtype, "
            f"got {table.dtype} / {rq.dtype}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if not table.device == idx.device == rq.device:
        raise ValueError("table, idx and queries must share one device")
    if table.ndim != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous (n_rows, W) tensor")
    b = idx.shape[0]
    if idx.ndim != 1 or rq.shape != (b, 3):
        raise ValueError(
            f"idx must be (B,), queries (B, 3): got {tuple(idx.shape)}, "
            f"{tuple(rq.shape)}"
        )
    tail = 2 if lay.kind == "quantized" else 1
    if lay.count_col + tail > table.shape[1] or lay.k < 1:
        raise ValueError(f"row layout {lay} does not fit width {table.shape[1]}")
    idx = idx.contiguous()
    rq = rq.contiguous()
    dev = table.device
    n_vars = len(lay.var_roles)
    vroles = _var_roles(lay.var_roles, dev)
    out_id = torch.empty(b, dtype=torch.int32, device=dev)
    out_aux = torch.empty(b, dtype=torch.int32, device=dev)
    vals = torch.empty((b, n_vars), dtype=table.dtype, device=dev)
    if b == 0:
        return out_id, out_aux, vals
    args = (table.data_ptr(), table.shape[1], idx.data_ptr(), rq.data_ptr(),
            b, lay.k, lay.nf, _KIND_CODE[lay.kind], lay.id_role,
            lay.count_col, float(eps), int(ovf_base))
    outs = (n_vars, vroles.data_ptr(), out_id.data_ptr(),
            out_aux.data_ptr(), vals.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if table.dtype == torch.float64:
            code = _kernels.lib().iu_cand_rows_f64(*args, *outs)
        else:
            code = _kernels.lib().iu_cand_rows(*args, QINV, *outs)
    _kernels.check(code, "iu_cand_rows")
    launches += 1
    return out_id, out_aux, vals


def cand_rows_query(table, idx, rq, lay, eps, ovf_base, chunk):
    """Candidate-row probe: the CUDA kernel for CUDA tensors, the plain
    version (gathering ``chunk`` rows at a time) for CPU tensors.
    Returns (id_best (B,) int32, aux (B,) int32, values (B, V))."""
    if table.device.type == "cuda":
        return cand_rows_cuda(table, idx, rq, lay, eps, ovf_base)
    if table.device.type == "cpu":
        return probe_rows_plain(table, idx, rq, lay, eps, ovf_base, chunk)
    raise ValueError(f"no candidate probe for device {table.device}")


def binned_lanes(n_queries, n_bins):
    """Lanes per query of the probe in bin order, from the batch's queries
    per bin.  tools/b2_sweep.py on the 998k-tet box (H100, PERF.md §6):
    4 lanes were the fastest at 0.5 and 1 query a bin, 2 and 4 tied at
    2 a bin, 2 (with 1) the fastest at 5 a bin; one lane alone is slow
    where it walks a whole row for one query, and a group where the
    queries of a bin repeat its per-query work."""
    return 2 if n_queries >= 2 * n_bins else 4


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
    n_bins = int(np.prod(shape))
    if len(shape) != 3 or min(shape) < 1 or n_bins >= 2**31:
        raise ValueError(f"bad bin grid shape {shape}")
    return r.contiguous(), rmin.contiguous(), inv_h.contiguous(), n_bins


def bin_order_cuda(r, rmin, inv_h, shape):
    """Launch the bin pass and the scatter on CUDA tensors: (B, 3) float32
    queries (or float64, binned by their float32 rounding) with the (3,)
    float32 bin origin and inverse sizes, or a float64 grid's float64
    queries and bin grid (binned in double); the bins per axis.  Returns
    (idx (B,) int32 flat bins, ends (n_bins,) int32 the
    inclusive scan of the queries per bin, perm (B,) int32: the queries
    grouped by bin, in ascending bin order, bin b in slots
    [ends[b - 1], ends[b]), in a bin in no fixed order; slot (B,) int32:
    each query's position in perm)."""
    global bin_pass_launches, bin_scatter_launches
    r, rmin, inv_h, n_bins = _check_bins(r, rmin, inv_h, shape)
    b = r.shape[0]
    dev = r.device
    counts = torch.zeros(n_bins, dtype=torch.int32, device=dev)
    idx, rank, perm, slot = (torch.empty(b, dtype=torch.int32, device=dev)
                             for _ in range(4))
    if b == 0:
        return idx, counts, perm, slot  # no query: the scan of the counts is 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = (counts.data_ptr(), idx.data_ptr(), rank.data_ptr(), stream)
    with torch.cuda.device(dev):
        if rmin.dtype == torch.float64:
            code = _kernels.lib().iu_cand_bin_pass_f64(
                r.data_ptr(), b, rmin.data_ptr(), inv_h.data_ptr(), *shape,
                *outs)
        else:
            code = _kernels.lib().iu_cand_bin_pass(
                r.data_ptr(), int(r.dtype == torch.float64), b,
                rmin.data_ptr(), inv_h.data_ptr(), *shape, *outs)
        _kernels.check(code, "iu_cand_bin_pass")
        bin_pass_launches += 1
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        code = _kernels.lib().iu_cand_bin_scatter(
            idx.data_ptr(), rank.data_ptr(), ends.data_ptr(), b,
            perm.data_ptr(), slot.data_ptr(), stream)
        _kernels.check(code, "iu_cand_bin_scatter")
        bin_scatter_launches += 1
    return idx, ends, perm, slot


def cand_rows_binned_cuda(table, r, perm, slot, rmin, inv_h, shape, lay, eps,
                          ovf_base, lanes=None, r_lo=None):
    """Launch the probe in bin order and the unsort on CUDA tensors:
    float32 table (one row per bin) and (B, 3) queries ``r`` (the kernel
    computes their bins and, for quantized rows, their local frame), or a
    float64 grid's float64 table, queries and bin grid;
    ``perm`` and ``slot`` the int32 grouping of the queries by bin and its
    inverse (:func:`bin_order_cuda`).  A group of ``lanes`` lanes (None:
    :func:`binned_lanes`) probes each query, in the order of ``perm``, and
    writes its record at its slot; the unsort puts the records back.
    For the df-plane rows ("qdf") ``r`` is float64, or float32 with the
    lo parts ``r_lo`` (None: zeros), and the kernel splits the queries and
    forms their hi/lo local frame.  Returns (id_best, aux, values) in
    query order; for "qdf" values is (B, 2V), hi columns then lo."""
    global binned_launches, df_launches, bin_unsort_launches
    df = lay.kind == "qdf"
    if lay.kind not in ("quantized", "simplex", "quad", "qdf"):
        raise ValueError(f"unknown row kind {lay.kind!r}")
    r, rmin, inv_h, n_bins = _check_bins(r, rmin, inv_h, shape)
    _check_table(table, lay)
    grid64 = table.dtype == torch.float64  # a float64 grid's rows
    if grid64 != (rmin.dtype == torch.float64):
        raise TypeError("a float64 table takes a float64 bin grid, a float32 "
                        "table a float32 one")
    f64 = r.dtype == torch.float64 and not grid64
    if f64 and (not df or r_lo is not None):
        raise TypeError("float64 queries are taken by the df-plane rows only, "
                        "without r_lo")
    if r_lo is not None:
        if not df or r_lo.dtype != torch.float32 or r_lo.shape != r.shape:
            raise ValueError("r_lo must be the float32 (B, 3) lo parts of "
                             "df-plane queries")
        if r_lo.device != r.device:
            raise ValueError("r and r_lo must share one device")
        r_lo = r_lo.contiguous()
    b = r.shape[0]
    for name, t in (("perm", perm), ("slot", slot)):
        if t.dtype != torch.int32 or t.shape != (b,):
            raise ValueError(f"{name} must be an int32 (B,) tensor")
    if not table.device == r.device == perm.device == slot.device:
        raise ValueError("table, queries, perm and slot must share one device")
    if (table.ndim != 2 or not table.is_contiguous()
            or table.shape[0] != n_bins):
        raise ValueError("table must be a contiguous (n_bins, W) tensor")
    tail = 2 if lay.kind in _QUANTIZED_KINDS else 1
    if lay.count_col + tail > table.shape[1]:
        raise ValueError(f"row layout {lay} does not fit width {table.shape[1]}")
    if lanes is None:
        lanes = binned_lanes(b, n_bins)
    if lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"lanes must be a power of two up to 32, got {lanes}")
    perm, slot = perm.contiguous(), slot.contiguous()
    dev = table.device
    n_vars = len(lay.var_roles)
    # 4-byte words of values a record carries: hi and lo floats of the
    # df-plane rows, the two words of a double
    n_words = 2 * n_vars if df or grid64 else n_vars
    vroles = _var_roles(lay.var_roles, dev)
    out_id = torch.empty(b, dtype=torch.int32, device=dev)
    out_aux = torch.empty(b, dtype=torch.int32, device=dev)
    vals = torch.empty((b, n_vars if grid64 else n_words), dtype=table.dtype,
                       device=dev)
    if b == 0:
        return out_id, out_aux, vals
    rec = torch.empty((b, 2 + n_words), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if grid64:
            code = _kernels.lib().iu_cand_rows_binned_f64(
                table.data_ptr(), table.shape[1], r.data_ptr(),
                perm.data_ptr(), b, lanes, rmin.data_ptr(), inv_h.data_ptr(),
                *shape, lay.k, lay.nf, _KIND_CODE[lay.kind], lay.id_role,
                lay.count_col, float(eps), int(ovf_base), n_vars,
                vroles.data_ptr(), rec.data_ptr(), stream,
            )
        else:
            code = _kernels.lib().iu_cand_rows_binned(
                table.data_ptr(), table.shape[1], r.data_ptr(),
                None if r_lo is None else r_lo.data_ptr(), int(f64),
                perm.data_ptr(), b, lanes, rmin.data_ptr(), inv_h.data_ptr(),
                *shape, lay.k, lay.nf, _KIND_CODE[lay.kind], lay.id_role,
                lay.count_col, float(eps), int(ovf_base), QINV, n_vars,
                vroles.data_ptr(), rec.data_ptr(), stream,
            )
        _kernels.check(code, "iu_cand_rows_binned")
        if df:
            df_launches += 1
        else:
            binned_launches += 1
        code = _kernels.lib().iu_cand_bin_unsort(
            rec.data_ptr(), slot.data_ptr(), b, n_words, out_id.data_ptr(),
            out_aux.data_ptr(), vals.data_ptr(), stream)
        _kernels.check(code, "iu_cand_bin_unsort")
        bin_unsort_launches += 1
    return out_id, out_aux, vals


def cand_rows_binned_query(table, r, rmin, inv_h, shape, lay, eps, ovf_base,
                           chunk):
    """The main-table probe in bin order, from the queries themselves:
    ``table`` holds one row per candidate bin of the grid (origin
    ``rmin``, inverse sizes ``inv_h``, ``shape`` bins per axis).  The
    bin pass, scatter, probe and unsort kernels for CUDA tensors; for
    CPU tensors the plain version, :func:`probe_rows_plain` in query
    order (a query's result does not depend on the order).  Returns
    (id_best (B,) int32, aux (B,) int32, values (B, V)) in query order."""
    if table.device.type == "cuda":
        _check_table(table, lay)  # before the bin pass
        _, _, perm, slot = bin_order_cuda(r, rmin, inv_h, shape)
        return cand_rows_binned_cuda(table, r, perm, slot, rmin, inv_h, shape,
                                     lay, eps, ovf_base)
    if table.device.type == "cpu":
        idx, rq = probe_inputs_plain(r, rmin, inv_h, shape,
                                     lay.kind == "quantized")
        return probe_rows_plain(table, idx, rq, lay, eps, ovf_base, chunk)
    raise ValueError(f"no candidate probe for device {table.device}")


def cand_rows_df_query(table, r, r_lo, rmin, inv_h, shape, lay, eps,
                       ovf_base, chunk):
    """The df-plane probe of accurate mode in bin order, from the queries
    as given: float64 ``r`` (``r_lo`` None), or float32 ``r`` with its lo
    parts ``r_lo`` (None: zeros); ``table`` holds one df-plane row per
    candidate bin.  The bin pass, scatter, df probe and unsort kernels
    for CUDA tensors, which split the queries themselves; for CPU tensors
    the plain version, :func:`cand_rows_df_plain`.  Returns (id_best,
    aux, vals_hi (B, V), vals_lo (B, V)) in query order."""
    if table.device.type == "cuda":
        _check_table(table, lay)
        _, _, perm, slot = bin_order_cuda(r, rmin, inv_h, shape)
        id_best, aux, vals = cand_rows_binned_cuda(
            table, r, perm, slot, rmin, inv_h, shape, lay, eps, ovf_base,
            r_lo=r_lo)
        n = len(lay.var_roles)
        return id_best, aux, vals[:, :n], vals[:, n:]
    if table.device.type == "cpu":
        return cand_rows_df_plain(table, r, r_lo, rmin, inv_h, shape, lay,
                                  eps, ovf_base, chunk)
    raise ValueError(f"no candidate probe for device {table.device}")
