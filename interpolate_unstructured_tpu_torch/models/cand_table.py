"""The candidate table: its sizing, lists, row packing and row layout.

A cold query reads one packed row of its bin: the face planes of every
cell that intersects the bin, with the values of the leading point-data
variables fused in.  This module alone knows that format.  One column
map per row kind (:func:`quantized`, :func:`simplex`, :func:`quad`,
:func:`qdf`) gives the floats a candidate takes, the trailing columns
and the roles of the ids and of each fused variable; the capacity K and
fused count nv (:func:`sizing`), the cover rule, the packers
(:func:`pack`, :func:`build_df_table`) and the ``RowLayout`` the probe
receives (:func:`layout`, :func:`df_layout`) all derive from it.  The
lists are built by :func:`build_lists`; :func:`stale` is the rule by
which a loaded checkpoint rebuilds them.

Rows are role-major (role j of candidate k is column ``j*K + k``) and
are the JAX package's rows bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable

import numpy as np
import torch

from ..ops import cand_kernel, geometry
from ..utils.config import huge_distance
from .grid import Grid, _np_dtype, _sync, _to

QCAND_NSCALE = 32767.0  # int16 full scale for unit normal components


# ---------------------------------------------------------------------------
# Column maps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Columns:
    """The column map of one row kind with ``nv`` fused variables.

    per: floats (roles) a candidate takes; trailing: columns after the
      K candidates (count, then dscale for the quantized kinds);
    id_role: role of the cell ids; var_role0 / var_step: first role of
      fused variable 0 and the roles between two variables.
    """

    kind: str
    nf: int
    nv: int
    per: int
    trailing: int
    id_role: int
    var_role0: int
    var_step: int

    def floats(self, k: int) -> int:
        """Floats a row of ``k`` candidates needs."""
        return self.per * k + self.trailing

    def width(self, k: int, itemsize: int) -> int:
        """Physical row width: the needed floats rounded up to a
        512-byte multiple, as in the JAX package."""
        step = 512 // itemsize
        return -(-self.floats(k) // step) * step

    def layout(self, k: int, var_slots) -> cand_kernel.RowLayout:
        """The probe's :class:`cand_kernel.RowLayout` of rows of ``k``
        candidates, reading the fused variables ``var_slots``."""
        if any(not 0 <= s < self.nv for s in var_slots):
            raise ValueError("var_slots outside the fused variable range")
        return cand_kernel.RowLayout(
            kind=self.kind, nf=self.nf, k=k, id_role=self.id_role,
            count_col=self.per * k,
            var_roles=tuple(self.var_role0 + self.var_step * s
                            for s in var_slots),
        )


def _quantized_head(nf: int) -> int:
    """Roles of the int16 probe geometry: ceil(3nf/2) int16-pair normal
    slots + ceil(nf/2) local-offset slots."""
    return -(-3 * nf // 2) + -(-nf // 2)


def quantized(cell_type: str, nv: int) -> Columns:
    """Quantized rows (f32 simplices, :func:`_pack_qcand_rows`): the
    int16 probe geometry, one f32 value plane (gx, gy, gz, c) per fused
    variable and the id; then count and dscale."""
    nf = geometry.N_POINTS_PER_CELL[cell_type]
    base = _quantized_head(nf)
    return Columns("quantized", nf, nv, per=base + 4 * nv + 1, trailing=2,
                   id_role=base + 4 * nv, var_role0=base, var_step=4)


def qdf(cell_type: str, nv: int) -> Columns:
    """Accurate mode's df-plane rows (:func:`_pack_qdf_rows`): the
    quantized probe geometry, an (hi, lo) df32 value plane (ghx ghy ghz
    glx gly glz c_hi c_lo) per fused variable and the id; then count and
    dscale."""
    nf = geometry.N_POINTS_PER_CELL[cell_type]
    base = _quantized_head(nf)
    return Columns("qdf", nf, nv, per=base + 8 * nv + 1, trailing=2,
                   id_role=base + 8 * nv, var_role0=base, var_step=8)


def simplex(cell_type: str, nv: int) -> Columns:
    """Unquantized simplex rows (:func:`_pack_cand_rows_plain_layout`):
    unit face planes, the id, and each variable's vertex data
    premultiplied by the opposite inverse height; then count."""
    nf = npc = geometry.N_POINTS_PER_CELL[cell_type]
    id_role = 4 * nf
    return Columns("simplex", nf, nv, per=id_role + 1 + npc * nv,
                   trailing=1, id_role=id_role, var_role0=id_role + 1,
                   var_step=npc)


def quad(cell_type: str, nv: int) -> Columns:
    """Quad rows (:func:`_pack_cand_rows_plain_layout`): face planes,
    vertices, the id and each variable's raw vertex data; then count."""
    nf = npc = geometry.N_POINTS_PER_CELL[cell_type]
    id_role = 4 * nf + 3 * npc
    return Columns("quad", nf, nv, per=id_role + 1 + npc * nv, trailing=1,
                   id_role=id_role, var_role0=id_role + 1, var_step=npc)


def is_quantized(cell_type: str, dtype, config) -> bool:
    """Whether this grid's candidate rows use the int16-quantized
    layout (IUConfig.cand_quantized).  Simplices only: the quad
    inverse-bilinear weights need f32 vertices, and f64 grids keep the
    f64 layout (quantization fuzz would dwarf their tolerance)."""
    return bool(
        config.cand_quantized
        and cell_type in ("triangle", "tetra")
        and dtype == torch.float32
    )


def columns(cell_type: str, dtype, config, nv: int) -> Columns:
    """The column map of a grid's main and extension rows."""
    if is_quantized(cell_type, dtype, config):
        return quantized(cell_type, nv)
    return (quad if cell_type == "quad" else simplex)(cell_type, nv)


# ---------------------------------------------------------------------------
# Sizing
# ---------------------------------------------------------------------------


def capacity(cell_type, dtype, config, n_point_data=0):
    """(K, nv): candidates per packed row and how many live point-data
    variables are fused into it.  Fusing stops before K drops below
    ``config.cand_min_k``."""
    row_floats = config.cand_row_bytes // dtype.itemsize
    min_k = max(1, config.cand_min_k)
    for nv in range(n_point_data, -1, -1):
        cols = columns(cell_type, dtype, config, nv)
        k = (row_floats - cols.trailing) // cols.per
        if k >= min_k or nv == 0:
            return k, nv
    return 0, 0


@dataclasses.dataclass(frozen=True)
class Sizing:
    """What a list build asks for: the capacity K, the fused-variable
    count nv at that K, and the cover rule (max count -> widen K?)."""

    k: int
    nv: int
    cover_ok: Callable[[int], bool]


def sizing(grid: Grid) -> Sizing:
    """The sizing of ``grid``'s candidate lists under its config and
    dtype.  Capacity is evaluated at the build-time fused-variable count
    (the ``cand_nv`` pin), not the current n_point_data: variables
    appended after the build (fuse=False) shrink the capacity K for a
    hypothetical repack but say nothing about the stored lists.  An
    unpinned grid (a new build, a pre-v4 checkpoint) takes
    n_point_data.

    The cover rule (IUConfig.cand_cover_row_bytes), which the builder
    calls with the worst bin's exact count once that is known, widens K
    to that count when the widened row (with the same nv) fits the cover
    budget AND, for the unquantized layouts, the widened K stays out of
    the post-hoc derivation hole of :func:`_capacity_nv` (a K that fits
    config rows bare but not with data would repack with nv = 0)."""
    ct, dt, cfg = grid.cell_type, grid.dtype, grid.config
    n = grid.n_point_data
    if grid.cand_nv >= 0:
        n = min(grid.cand_nv, n)
    k_max, nv = capacity(ct, dt, cfg, n)
    cfg_f = cfg.cand_row_bytes // dt.itemsize
    cov_f = cfg.cand_cover_row_bytes // dt.itemsize
    cols, bare = columns(ct, dt, cfg, nv), columns(ct, dt, cfg, 0)
    quant = is_quantized(ct, dt, cfg)

    def cover_ok(max_count: int) -> bool:
        if cov_f <= 0 or max_count <= k_max:
            return False
        need = cols.floats(max_count)
        if quant:
            return need <= max(cfg_f, cov_f)
        if need <= cfg_f:
            return True  # widens within the config row — always safe
        if need > cov_f:
            return False  # worst bin doesn't fit a cover row
        return bare.floats(max_count) > cfg_f  # hole check

    return Sizing(k_max, nv, cover_ok)


def fused_nv(grid: Grid) -> int:
    """How many leading point-data variables are fused into the
    candidate rows: pinned in ``grid.cand_nv`` once packed, else the
    capacity-derived count (:func:`_capacity_nv`)."""
    if grid.cand_ids is None:
        return 0
    if grid.cand_nv >= 0:
        return grid.cand_nv
    return _capacity_nv(grid)


def _capacity_nv(grid: Grid) -> int:
    """Capacity-derived fused-variable count for THIS n_point_data —
    what a (re)pack would choose.  The budget is ``cand_row_bytes``
    normally; a grid whose K doesn't even fit that row bare (nv = 0)
    is a cover-all build (K widened to the worst bin count) and
    budgets ``cand_cover_row_bytes``."""
    itemsize = grid.dtype.itemsize
    k_max = grid.cand_ids.shape[1]
    cfg = grid.config
    ct, dt = grid.cell_type, grid.dtype
    if is_quantized(ct, dt, cfg):
        # Deterministic reconstruction of the build's choice: accept the
        # stored K as the capacity K of any variable count <= the
        # current one, largest first, where the nv round-trips.
        for n_try in range(grid.n_point_data, -1, -1):
            k_t, nv_t = capacity(ct, dt, cfg, n_try)
            if k_t == k_max:
                k_rt, nv_rt = capacity(ct, dt, cfg, nv_t)
                if k_rt == k_max and nv_rt == nv_t:
                    return nv_t
        # No capacity K matches: the K was cover-widened; the capacity
        # nv survives iff the widened row fits the larger budget
        _, nv_cfg = capacity(ct, dt, cfg, grid.n_point_data)
        budget = max(cfg.cand_row_bytes, cfg.cand_cover_row_bytes) // itemsize
        return nv_cfg if quantized(ct, nv_cfg).floats(k_max) <= budget else 0
    row_floats = cfg.cand_row_bytes // itemsize
    if columns(ct, dt, cfg, 0).floats(k_max) > row_floats:
        row_floats = cfg.cand_cover_row_bytes // itemsize
    nv = 0
    while (
        nv < grid.n_point_data
        and columns(ct, dt, cfg, nv + 1).floats(k_max) <= row_floats
    ):
        nv += 1
    return nv


# ---------------------------------------------------------------------------
# What the probe reads
# ---------------------------------------------------------------------------


def layout(grid: Grid, k: int, var_slots) -> cand_kernel.RowLayout:
    """The :class:`cand_kernel.RowLayout` of this grid's rows with ``k``
    candidates per row (main table: K; extension table: k_ext)."""
    cols = columns(grid.cell_type, grid.dtype, grid.config, fused_nv(grid))
    return cols.layout(k, var_slots)


def df_layout(grid: Grid, var_slots) -> cand_kernel.RowLayout:
    """The :class:`cand_kernel.RowLayout` of the df-plane rows
    (``grid.cand_df_table``)."""
    return qdf(grid.cell_type, fused_nv(grid)).layout(
        grid.cand_ids.shape[1], var_slots)


def fuses(grid: Grid, slots) -> bool:
    """Whether the rows carry every one of the (non-empty) ``slots``."""
    nv = fused_nv(grid)
    return bool(slots) and all(0 <= s < nv for s in slots)


def probe_eps(grid: Grid) -> float:
    """Inside tolerance of the probe: int16 rounding makes quantized
    planes fuzzy within grid.cand_qeps of the true faces, so the
    tolerance widens by it and interior points are never lost."""
    return grid.config.eps_inside + grid.cand_qeps


def probe_chunk(grid: Grid, table=None) -> int:
    """Queries per chunk of the plain probe: the gathered rows
    (chunk x row bytes) stay near ``config.cand_chunk_bytes``; rounded
    to a multiple of 8192; ``config.cand_chunk_queries`` overrides."""
    cfg = grid.config
    if cfg.cand_chunk_queries is not None:
        return cfg.cand_chunk_queries
    tab = grid.cand_table if table is None else table
    row_b = tab.shape[1] * tab.element_size()
    return max(1 << 13, (cfg.cand_chunk_bytes // row_b) >> 13 << 13)


def probe_inputs(grid: Grid, r):
    """(idx (B,) int32, rq (B, 3)) of the plain probe in query order:
    each query's bin, and the query in that bin's local frame when the
    rows are quantized (the extension rows share the frame)."""
    return cand_kernel.probe_inputs_plain(
        r, grid.cand_rmin, grid.cand_inv_h, grid.cand_shape,
        is_quantized(grid.cell_type, grid.dtype, grid.config))


def bin_centers(grid: Grid, bin_idx=None) -> torch.Tensor:
    """(n,) flat bin indices (default: every bin) -> (n, 3) bin centers
    (the quantized rows' local frame origins)."""
    if bin_idx is None:
        bin_idx = torch.arange(grid.cand_ids.shape[0], dtype=torch.int32,
                               device=grid.device)
    cx, cy, cz = geometry.cand_bin_center_cols(
        grid.cand_rmin, grid.cand_inv_h,
        *geometry.cand_bin_decode(
            bin_idx, grid.cand_shape[1], grid.cand_shape[2]
        ),
    )
    return torch.stack([cx, cy, cz], dim=1)


# ---------------------------------------------------------------------------
# Lists
# ---------------------------------------------------------------------------


def build_candidate_bins_dispatch(
    cell_points, normals, face_offsets, rmin, rmax, ndim, k_max,
    dtype, config, cover_ok=None, device="cuda",
):
    """Candidate-bin construction with backend dispatch, as the JAX
    package dispatches: the device pipeline (ops/cand_build.py, kernels
    D1 and D2 on a CUDA ``device``) for meshes of at least
    ``config.cand_build_device_min_cells`` cells under "auto", or always
    under "device"; the host builder (ops/geometry.py) for smaller
    meshes or where the device pipeline declines (extreme AABB spans).
    Both apply the same build-side eps inflation (2 * eps_inside), which
    strictly dominates the query-side inside tolerance plus rounding, so
    no containing cell can be filtered out of its bin's candidate list.
    The device builder's tables are tensors on ``device``, the host
    builder's numpy arrays."""
    from ..ops import cand_build

    mode = config.cand_build
    if mode not in ("auto", "host", "device"):
        raise ValueError(f"Unknown cand_build mode {mode!r}")
    kwargs = dict(
        bins_per_cell=config.cand_bins_per_cell,
        max_bins=config.cand_max_bins,
        eps=2.0 * config.eps_inside,
        ext_max_k=config.cand_ext_max_k,
        cover_ok=cover_ok,
    )
    res = None
    if mode == "device" or (
        mode == "auto"
        and len(cell_points) >= config.cand_build_device_min_cells
    ):
        res = cand_build.build_candidate_bins_device(
            cell_points, normals, face_offsets, rmin, rmax, ndim, k_max,
            dtype, device=device, **kwargs,
        )
        if res is None and mode == "device":
            raise ValueError(
                "cand_build='device' but the mesh exceeds the device "
                "offset budget (strongly graded cell sizes)"
            )
    if res is None:
        res = geometry.build_candidate_bins(
            cell_points, normals, face_offsets, rmin, rmax, ndim, k_max,
            **kwargs,
        )
    return res


def build_lists(grid: Grid, cell_points, normals, face_offsets, rmin, rmax,
                size: Sizing) -> Grid:
    """The grid with candidate lists built from the float64 host
    geometry (cell vertices, unit face normals, face offsets, the
    bounding box) by the builder ``config.cand_build`` picks, sized by
    ``size``; the rows are left to :func:`pack`, and the fused-variable
    pin is cleared: it described the lists this build replaces."""
    dtype, device = grid.dtype, grid.device
    (
        cand_ids, cand_count, cand_shape, cand_rmin, cand_inv_h,
        ext_ids, ext_slot,
    ) = build_candidate_bins_dispatch(
        cell_points, normals, face_offsets, rmin, rmax, grid.ndim, size.k,
        dtype, grid.config, cover_ok=size.cover_ok, device=device,
    )
    cand_count = _to(cand_count, torch.int32, device)
    return dataclasses.replace(
        grid,
        cand_ids=_to(cand_ids, torch.int32, device),
        cand_count=cand_count,
        cand_shape=cand_shape,
        cand_rmin=_to(cand_rmin, dtype, device),
        cand_inv_h=_to(cand_inv_h, dtype, device),
        cand_ext_ids=(
            _to(ext_ids, torch.int32, device) if ext_ids.shape[1] else None
        ),
        cand_ext_slot=_to(ext_slot, torch.int32, device),
        # cand_ids.shape[1], not the capacity k_max: the builder may
        # have cover-widened K to the worst bin
        cand_ext_covers=bool(
            int(cand_count.max()) <= cand_ids.shape[1] + ext_ids.shape[1]
        ),
        cand_nv=-1,
    )


def stale(grid: Grid, size: Sizing, dtype_changed: bool, max_count: int,
          rmin, rmax) -> bool:
    """Whether a loaded grid's candidate lists no longer match this
    session and must be rebuilt (:func:`build_lists`, with ``size``):

    (a) a coarser load dtype (``dtype_changed``) widens the query-side
    inside tolerance past the save-time inflation, which could admit
    points into cells filtered out of their bin; (b) a K other than this
    config's capacity K, or its cover-widened K for the stored worst
    count ``max_count``, would overflow or underfill the packed rows;
    (c) a bin shape more than one bin off the one this config would
    choose for the stored bounds ``rmin`` / ``rmax`` (host float64)
    means the save used another cand_bins_per_cell / cand_max_bins;
    (d) a pre-v4 checkpoint lacks the extension lists."""
    cfg = grid.config
    want_k = max_count if size.cover_ok(max_count) else size.k
    want_shape, _, _, _ = geometry._bin_grid_shape(
        rmin, rmax, grid.ndim,
        min(max(int(cfg.cand_bins_per_cell * grid.n_cells), 1),
            cfg.cand_max_bins),
    )
    # The save-time shape came from exact f64 point bounds while
    # rmin/rmax were stored in the grid dtype, so the rounding inside
    # _bin_grid_shape can flip a dim by one on an f32 grid — tolerate
    # that; real config changes move dims by >= 2.
    shape_moved = any(abs(int(w) - int(s)) > 1
                      for w, s in zip(want_shape, grid.cand_shape))
    return (
        dtype_changed
        or grid.cand_ids.shape[1] != want_k
        or shape_moved
        or (grid.cand_ext_slot is None and cfg.cand_ext_max_k > 0)
    )


# ---------------------------------------------------------------------------
# Row packing (on the grid's device)
# ---------------------------------------------------------------------------


def _sum3(x):
    """Sum over a trailing axis of 3 in a fixed order, ((x0+x1)+x2)."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _sum_axis2(x):
    """Sequential sum over axis 2 ((x0+x1)+x2)+..., a fixed order."""
    acc = x[:, :, 0]
    for i in range(1, x.shape[2]):
        acc = acc + x[:, :, i]
    return acc


def _roles(x):
    """(n_rows, K, m) -> (n_rows, m*K): K-wide role columns, column =
    role*K + k — the layout the packers and the probe kernel share."""
    return x.transpose(1, 2).reshape(x.shape[0], -1)


def _bits(x):
    """f32 tensor -> its int32 bit pattern (a view, no arithmetic)."""
    return x.contiguous().view(torch.int32)


def _records(parts, itemsize: int) -> torch.Tensor:
    """Per-cell pack-source records: the (n_cells, m) ``parts`` side by
    side, padded to a 256-byte-multiple stride as the JAX package pads
    them (kept so the records match)."""
    rows = torch.cat(parts, dim=1)
    step = 256 // itemsize
    pad = -(-rows.shape[1] // step) * step - rows.shape[1]
    return torch.nn.functional.pad(rows, (0, pad))


def _pack_source_chunk(k_max: int, src_floats: int, itemsize: int) -> int:
    """Rows per packing step, sized so the materialized (chunk, K, S)
    record gather stays ~<= 128 MB."""
    per_row = max(k_max * src_floats * itemsize, 1)
    c = (128 << 20) // per_row
    return max(1 << 12, min(1 << 18, 1 << max(int(c).bit_length() - 1, 0)))


def _pack_src_rows(grid: Grid, nv: int) -> torch.Tensor:
    """One record per cell carrying everything the candidate-row
    packers read per candidate."""
    n_cells, nf = grid.face_offsets.shape
    npc = grid.n_points_per_cell
    parts = [
        grid.face_normals.reshape(n_cells, nf * 3),
        grid.face_offsets,
        grid.cell_points.reshape(n_cells, npc * 3),
    ]
    if nv:
        vtx = grid.point_data[:, :nv][grid.cells.long()]  # (C, npc, nv)
        parts.append(vtx.reshape(n_cells, npc * nv))
    return _records(parts, grid.dtype.itemsize)


def _split_src(g, nf, npc, nv):
    """Slice a gathered (n, K, S) record block back into its fields:
    (normals (n,K,nf,3), offs (n,K,nf), cp (n,K,npc,3),
    vtx (n,K,npc,nv) or None)."""
    n, k = g.shape[:2]
    normals = g[..., : nf * 3].reshape(n, k, nf, 3)
    offs = g[..., nf * 3: nf * 4]
    cp = g[..., nf * 4: nf * 4 + npc * 3].reshape(n, k, npc, 3)
    vtx = None
    if nv:
        o = nf * 4 + npc * 3
        vtx = g[..., o: o + npc * nv].reshape(n, k, npc, nv)
    return normals, offs, cp, vtx


def _pack_i16_pairs(comp: torch.Tensor) -> torch.Tensor:
    """(n, K, m) int32 in [-32767, 32767] -> (n, K, ceil(m/2)) int32
    words: two int16 halves per 4-byte slot (lo = even comp, hi = odd).
    The words ride the f32 rows as raw bits: many are NaN patterns when
    read as float, so they are only ever moved as int32."""
    m = comp.shape[-1]
    if m % 2:
        comp = torch.nn.functional.pad(comp, (0, 1))
    lo = comp[..., 0::2] & 0xFFFF
    hi = comp[..., 1::2] & 0xFFFF
    return lo | (hi << 16)


def _quantize_probe_geometry(normals, offs, ids, centers):
    """int16 probe geometry of the quantized rows.

    ``normals``/``offs`` are the gathered per-candidate face planes —
    (n, K, nf, 3) and (n, K, nf).  Returns (centers f32, head_parts,
    ds): ``head_parts`` are the packed [qn | qd] role columns (int32
    words) that open every quantized row; ``ds`` the per-row dscale.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    valid = ids >= 0
    normals = normals.to(torch.float32)
    offs = offs.to(torch.float32)
    centers = centers.to(torch.float32)

    d_loc = offs - _sum3(normals * centers[:, None, None, :])
    absd = torch.where(
        valid[..., None], torch.abs(d_loc), torch.zeros_like(d_loc)
    )
    ds = absd.amax(dim=(1, 2)) / QCAND_NSCALE  # (n,)
    ds_safe = torch.clamp_min(ds, float(np.finfo(np.float32).tiny))
    qd = torch.clamp(
        torch.round(d_loc / ds_safe[:, None, None]), -32767, 32767
    ).to(torch.int32)
    qn = torch.clamp(
        torch.round(normals * QCAND_NSCALE), -32767, 32767
    ).to(torch.int32)

    n_rows, k_max = ids.shape
    nf = normals.shape[2]
    head_parts = [
        _roles(_pack_i16_pairs(qn.reshape(n_rows, k_max, nf * 3))),
        _roles(_pack_i16_pairs(qd)),
    ]
    return centers, head_parts, ds


def _inverse_heights(normals, offs, cp):
    """(fv, iv): the face opposite each vertex (face v + 1) and the
    inverse of each vertex's height over it, (n, K, npc)."""
    npc = cp.shape[2]
    fv = (torch.arange(npc, device=cp.device) + 1) % npc
    opp = (torch.arange(npc, device=cp.device) - 1) % npc  # vertex opp. f
    m_opp = offs - _sum3(normals * cp[:, :, opp])
    inv_f = 1.0 / torch.where(m_opp == 0, torch.ones_like(m_opp), m_opp)
    return fv, inv_f[..., fv]


def _finish_rows(parts, cols: Columns, k: int, row_floats: int):
    """Concatenate the role columns (and the trailing ones) into rows of
    the width ``cols`` gives ``k`` candidates, padded with zeros to the
    physical row width; int32 bit columns come back as float32 (a bit
    view)."""
    rows = torch.cat(parts, dim=1)
    if rows.shape[1] != cols.floats(k):
        raise AssertionError(
            f"{cols.kind} rows of {k} candidates packed {rows.shape[1]} "
            f"columns, the column map says {cols.floats(k)}")
    rows = torch.nn.functional.pad(rows, (0, row_floats - rows.shape[1]))
    return rows.view(torch.float32) if rows.dtype == torch.int32 else rows


def _finish_quantized(parts, ids, count_vals, ds, cols, row_floats):
    """The quantized kinds' rows: the role columns ``parts``, then the
    ids, the count and the dscale columns, as int32 bits."""
    parts += [
        _bits(ids.to(torch.float32)),
        _bits(count_vals.to(torch.float32)[:, None]),
        _bits(ds.to(torch.float32)[:, None]),
    ]
    return _finish_rows(parts, cols, ids.shape[1], row_floats)


def _pack_qcand_rows(src, ids, count_vals, centers, cols, row_floats):
    """Quantized candidate rows (f32 simplices; IUConfig.cand_quantized).

    Role layout (K-wide roles, column role*K + k; :func:`quantized`):

      [qn (ceil(3nf/2) int16-pair slots) | qd (ceil(nf/2) slots)
       | plane (gx gy gz c) per fused var | id] * K  | count | dscale

    ``qn`` = round(n * 32767) of the unit face normals, face-major
    component order (f*3 + d).  ``qd`` = round(d_local / dscale) with
    ``d_local = off_f - n_f . c_bin`` the face offset in the query bin's
    local frame and ``dscale`` the row's max |d_local| / 32767.  The
    probe margin is ``qd * dscale - (qn . r_local) / 32767``.

    Values come from exact f32 per-cell planes, value = g . r_local + c
    with g = -sum_v (data_v - mean) * inv_height_v * n_f(v) and c
    anchored at the bin center.  Padding slots keep id -1; the probe
    masks their margins by the id sign."""
    n_rows, k_max = ids.shape
    nf = npc = cols.nf
    nv = cols.nv

    g = src[ids.clamp_min(0).long()]  # (n, K, S) — one record gather
    normals, offs, cp, vtx = _split_src(g, nf, npc, nv)
    centers, parts, ds = _quantize_probe_geometry(normals, offs, ids, centers)
    normals = normals.to(torch.float32)
    offs = offs.to(torch.float32)
    if nv:
        fv, iv_vertex = _inverse_heights(normals, offs, cp)  # (n, K, npc)
        n_fv = normals[:, :, fv]  # (n, K, npc, 3)
        off_fv = offs[..., fv]  # (n, K, npc)

        d_mean = _sum_axis2(vtx) / npc  # (n, K, nv)
        coef = (vtx - d_mean[:, :, None, :]) * iv_vertex[..., None]
        gs = [-_sum_axis2(coef * n_fv[..., d: d + 1]) for d in range(3)]
        c0 = _sum_axis2(coef * off_fv[..., None]) + d_mean
        c_loc = c0
        for d in range(3):
            c_loc = c_loc + gs[d] * centers[:, None, d: d + 1]
        plane = torch.stack(gs + [c_loc], dim=-1)  # (n, K, nv, 4)
        parts.append(_bits(_roles(plane.reshape(n_rows, k_max, nv * 4))))
    return _finish_quantized(parts, ids, count_vals, ds, cols, row_floats)


def _pack_cand_rows_plain_layout(src, ids, count_vals, centers, cols,
                                 row_floats):
    """Unquantized fused candidate rows (f64 grids, quads, and f32
    simplices with ``cand_quantized=False``), role-major
    (:func:`simplex`, :func:`quad`):

      tri/tet: [nx_f | ny_f | nz_f | off_f | id | data(var,vtx) | count]
      quad:    [nx_f | ny_f | nz_f | off_f | vtx(v,dim) | id | data | count]

    Simplex data of vertex v is premultiplied by its inverse height, so
    the probe forms values straight from the face margins.  Invalid
    (padding) slots get -huge offsets so their margin can never win.
    ``centers`` is unused: these rows keep the global frame."""
    n_rows, k_max = ids.shape
    nf = npc = cols.nf
    nv = cols.nv
    dtype = src.dtype

    g = src[ids.clamp_min(0).long()]  # (n, K, S) — one record gather
    normals, offs, cp, vtx = _split_src(g, nf, npc, nv)
    offs = torch.where(
        (ids >= 0)[..., None], offs,
        torch.full_like(offs, -huge_distance(_np_dtype(dtype))),
    )
    parts = [
        _roles(normals[..., 0]),
        _roles(normals[..., 1]),
        _roles(normals[..., 2]),
        _roles(offs),
    ]
    if cols.kind == "quad":
        parts.append(_roles(cp.reshape(n_rows, k_max, npc * 3)))
    parts.append(ids.to(dtype))
    if nv:
        if cols.kind != "quad":
            vtx = vtx * _inverse_heights(normals, offs, cp)[1][..., None]
        parts.append(
            _roles(vtx.transpose(2, 3).reshape(n_rows, k_max, -1))
        )
    parts.append(count_vals.to(dtype)[:, None])
    return _finish_rows(parts, cols, k_max, row_floats)


def _pack_table(packer, src, ids, count_vals, centers, cols, dtype,
                device):
    """A table of ``cols``' rows for the lists ``ids``, packed from the
    per-cell source records ``src`` by ``packer`` in row chunks straight
    into one preallocated table, so the (chunk, K, S) record gather
    stays memory-bounded.  ``centers`` (bin centers per row) are the
    quantized rows' local frames; their int16 words move as int32 bits
    (they are often NaN patterns)."""
    k = ids.shape[1]
    row_floats = cols.width(k, dtype.itemsize)
    chunk = _pack_source_chunk(k, src.shape[1], dtype.itemsize)
    n = ids.shape[0]
    out = torch.empty((n, row_floats), dtype=dtype, device=device)
    dst = out.view(torch.int32) if cols.kind in ("quantized", "qdf") else out
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        rows = packer(src, ids[lo:hi], count_vals[lo:hi],
                      None if centers is None else centers[lo:hi], cols,
                      row_floats)
        dst[lo:hi] = rows.view(dst.dtype)
    return out


def pack(grid: Grid, nv: int | None = None) -> dict:
    """Main + overflow-extension candidate tables of the grid's lists,
    as grid fields (``cand_table``, ``cand_ext_table``, ``cand_nv``,
    ``cand_qeps``; ``cand_df_table`` cleared).

    The main table's count column encodes overflow redirection: the
    exact count where it fits K, else ``K + 1 + ext_slot`` — the probe
    recovers both the overflow flag and the extension row from the
    value it already reads.  The extension rows' count column carries
    the bin's exact total count.

    ``nv`` overrides the fused-variable count (clamped to the capacity);
    ``set_point_data`` and a checkpoint load pass the pinned count so
    that a repack never fuses a variable added with ``fuse=False``."""
    k_max = grid.cand_ids.shape[1]
    cap_nv = _capacity_nv(grid)
    nv = cap_nv if nv is None or nv < 0 else min(nv, cap_nv)
    cols = columns(grid.cell_type, grid.dtype, grid.config, nv)
    quant = cols.kind == "quantized"
    out = {
        "cand_nv": nv,
        "cand_ext_table": None,
        # any repack invalidates the accurate-mode df-plane rows (their
        # fused values and nv would go stale); prepare_accurate rebuilds
        # them, and interpolate_at_acc takes the at-known-cell path
        # meanwhile
        "cand_df_table": None,
        "cand_qeps": 0.0,
    }
    count, ext = grid.cand_count, {}
    if grid.cand_ext_ids is not None:
        count = torch.where(
            grid.cand_count > k_max,
            k_max + 1 + grid.cand_ext_slot.clamp_min(0),
            grid.cand_count,
        )
        # overflow-bin indices in ext-slot order: ext_slot is assigned
        # in ascending bin order, and a stable sort of the "not
        # overflow" flag lists those bins first in that same order
        over_order = torch.sort(
            (grid.cand_ext_slot < 0).to(torch.int8), stable=True
        ).indices[: grid.cand_ext_ids.shape[0]]
        ext["cand_ext_table"] = (grid.cand_ext_ids,
                                 grid.cand_count[over_order], over_order)
    # name: (lists, count column, the rows' bins: None = all, in order)
    tables = {"cand_table": (grid.cand_ids, count, None), **ext}
    packer = _pack_qcand_rows if quant else _pack_cand_rows_plain_layout
    ds_max = 0.0
    for name, (ids, counts, bins) in tables.items():
        out[name] = _pack_table(
            packer, _pack_src_rows(grid, nv), ids, counts,
            bin_centers(grid, bins) if quant else None, cols, grid.dtype,
            grid.device)
        if quant:  # the dscale column follows the count
            ds_max = max(ds_max, float(
                out[name][:, cols.per * ids.shape[1] + 1].max()))
    if quant:
        # Margin fuzz bound of the quantized probe: offset rounding
        # (0.5 dscale) + normal rounding over |r_local| <= h/2 per dim.
        inv_h = grid.cand_inv_h.detach().cpu().numpy().astype(np.float64)
        h_sum = float(
            np.where(inv_h > 0, 1.0 / np.where(inv_h > 0, inv_h, 1), 0.0).sum()
        )
        out["cand_qeps"] = 0.5 * ds_max + (0.25 / QCAND_NSCALE) * h_sum
    return out


def refresh(grid: Grid, i_var: int | None = None,
            extend: bool = True) -> Grid:
    """Re-pack the candidate rows after a point-data mutation — they
    carry fused copies of the leading variables' vertex values.

    Pass the mutated column as ``i_var`` to skip the repack when that
    column would not be fused into the rows.  With ``extend=True``
    (add_point_data) the comparison uses the CAPACITY nv — appending a
    variable that fits extends the fusion.  With ``extend=False``
    (set_point_data) only a column that is CURRENTLY fused triggers a
    repack, which keeps the pinned nv: updating a variable added with
    ``fuse=False`` neither pays the repack nor fuses the column."""
    if grid.cand_ids is None:
        return grid
    nv_now = fused_nv(grid)
    limit = _capacity_nv(grid) if extend else nv_now
    if i_var is not None and i_var >= limit:
        return grid
    return dataclasses.replace(
        grid, **pack(grid, nv=None if extend else nv_now)
    )


# ---------------------------------------------------------------------------
# Accurate-mode df-plane rows
# ---------------------------------------------------------------------------


def _pack_dfsrc_rows(face_normals, face_offsets, plane_hi, plane_lo, nv):
    """Per-cell accurate-mode pack-source records (f32):
    [normals nf*3 | offsets nf | plane_hi nv*4 | plane_lo nv*4]."""
    n_cells, nf = face_offsets.shape
    return _records([
        face_normals.to(torch.float32).reshape(n_cells, nf * 3),
        face_offsets.to(torch.float32),
        plane_hi.reshape(n_cells, nv * 4),
        plane_lo.reshape(n_cells, nv * 4),
    ], 4)


def _pack_qdf_rows(src, ids, count_vals, centers, cols, row_floats):
    """Accurate-mode candidate rows: the quantized int16 probe geometry
    (the same words as _pack_qcand_rows) + df32 value planes.  ``src``
    is the per-cell df record table (_pack_dfsrc_rows).

    The planes are the (hi, lo) float32 split of the per-cell float64
    interpolant v(r) = g . r + c (exact for simplices, solved on the host
    by solve_cell_planes_f64).  The offset is re-anchored at the bin
    center in df32, c_loc = c + g . c_bin, so the probe evaluates
    v = g . r_local + c_loc with r_local = r - c_bin carried as an exact
    (hi, lo) pair.

    Role layout (K-wide roles, column role*K + k; :func:`qdf`):
      [qn | qd | (ghx ghy ghz glx gly glz ch cl) per var | id] * K
      | count | dscale
    """
    from ..ops import df32

    n_rows, k_max = ids.shape
    nf, nv = cols.nf, cols.nv
    g = src[ids.clamp_min(0).long()]  # (n, K, S) — one record gather
    normals = g[..., : nf * 3].reshape(n_rows, k_max, nf, 3)
    offs = g[..., nf * 3: nf * 4]
    centers, parts, ds = _quantize_probe_geometry(normals, offs, ids, centers)
    o = nf * 4
    ph = g[..., o: o + nv * 4].reshape(n_rows, k_max, nv, 4)
    plo = g[..., o + nv * 4: o + nv * 8].reshape(n_rows, k_max, nv, 4)
    gd = [(ph[..., d], plo[..., d]) for d in range(3)]  # df pairs (n, K, nv)
    acc = (ph[..., 3], plo[..., 3])
    for d in range(3):
        cb = centers[:, None, None, d].expand(ph.shape[:3]).contiguous()
        acc = df32.add(acc, df32.mul(gd[d], (cb, torch.zeros_like(cb))))
    planes = torch.stack(
        [gd[0][0], gd[1][0], gd[2][0], gd[0][1], gd[1][1], gd[2][1],
         acc[0], acc[1]],
        dim=-1,
    )  # (n, K, nv, 8)
    parts.append(_bits(_roles(planes.reshape(n_rows, k_max, nv * 8))))
    return _finish_quantized(parts, ids, count_vals, ds, cols, row_floats)


def solve_cell_planes_f64(points64, cells, data64):
    """Per-cell float64 affine interpolant v(r) = g . r + c (numpy).

    Barycentric interpolation on a simplex is affine, so for tets the
    plane through the 4 (vertex, value) pairs IS the interpolant; for
    triangles (a rank-3 system in 3D) the minimum-norm in-plane solution
    is used.  Solved anchored at the cell centroid, vectorized over all
    cells; degenerate (zero-volume) tets go through the pseudo-inverse.
    Returns (g (n, nv, 3), c (n, nv)) float64.
    """
    p = points64[cells]  # (n, npc, 3)
    d = data64[cells]  # (n, npc, nv)
    npc = p.shape[1]
    anchor = p.mean(axis=1)  # (n, 3)
    dp = p - anchor[:, None, :]
    if npc == 4:
        a = np.concatenate([dp, np.ones_like(dp[..., :1])], axis=2)
        # det(a) = 6 * signed volume; relative to the cell scale
        det = np.linalg.det(a)
        scale = np.abs(dp).max(axis=(1, 2), initial=0.0) ** 3
        bad = ~(np.abs(det) > 1e-14 * scale)
        if bad.any():
            sol = np.empty(a.shape[:1] + (4, d.shape[2]), np.float64)
            good = ~bad
            if good.any():
                sol[good] = np.linalg.solve(a[good], d[good])
            sol[bad] = np.einsum(
                "nij,njv->niv", np.linalg.pinv(a[bad]), d[bad]
            )
        else:
            sol = np.linalg.solve(a, d)  # (n, 4, nv): g rows + c
        g = sol[:, :3].transpose(0, 2, 1)  # (n, nv, 3)
        c0 = sol[:, 3]  # (n, nv)
    elif npc == 3:
        # minimum-norm least squares via the pseudo-inverse of the
        # (3, 4) system [dp 1] — exact on the triangle's plane
        a = np.concatenate([dp, np.ones_like(dp[..., :1])], axis=2)
        sol = np.einsum("nij,njv->niv", np.linalg.pinv(a), d)  # (n, 4, nv)
        g = sol[:, :3].transpose(0, 2, 1)
        c0 = sol[:, 3]
    else:
        raise ValueError("df planes are defined for simplices only")
    # de-anchor: v = g . (r - anchor) + c0 = g . r + (c0 - g . anchor)
    c = c0 - np.einsum("nvd,nd->nv", g, anchor)
    return g, c


def df_supported(grid: Grid) -> bool:
    """Gate for the fused accurate rows: float32 simplex cover grids
    with quantized candidate tables and at least one fused variable."""
    return (
        grid.cand_ids is not None
        and grid.cand_ext_table is None
        and grid.cand_ext_covers
        and is_quantized(grid.cell_type, grid.dtype, grid.config)
        and fused_nv(grid) >= 1
    )


def _host_f64(hi, lo):
    """hi (+ lo when stored) as a float64 host array."""
    a = hi.detach().cpu().numpy().astype(np.float64)
    if lo is not None:
        a = a + lo.detach().cpu().numpy().astype(np.float64)
    return a


def build_df_table(grid: Grid, timings: dict | None = None):
    """Assemble the accurate-mode fused candidate rows (see
    _pack_qdf_rows).  The planes are solved on the host in float64 from
    the stored (hi, lo) mesh and data split; without stored residuals
    accuracy is bounded by the float32 representation.  The rows are
    packed on the grid's device in chunks written straight into one
    table (as int32 bits: the int16 words are often NaN patterns).

    ``timings``, when given, gets ``plane_solve_s`` (host solve and the
    transfer of the planes) and ``df_pack_s`` (the device packing)."""
    t0 = time.perf_counter()
    nv = fused_nv(grid)
    dev = grid.device
    pts64 = _host_f64(grid.points, grid.points_lo)
    pd64 = _host_f64(
        grid.point_data[:, :nv],
        None if grid.point_data_lo is None else grid.point_data_lo[:, :nv],
    )
    g64, c64 = solve_cell_planes_f64(
        pts64, grid.cells.cpu().numpy(), pd64
    )
    plane64 = np.concatenate([g64, c64[:, :, None]], axis=2)  # (n, nv, 4)
    plane_hi = plane64.astype(np.float32)
    plane_lo = (plane64 - plane_hi.astype(np.float64)).astype(np.float32)
    src = _pack_dfsrc_rows(
        grid.face_normals, grid.face_offsets,
        _to(plane_hi, torch.float32, dev), _to(plane_lo, torch.float32, dev),
        nv,
    )
    del pts64, pd64, g64, c64, plane64, plane_hi, plane_lo
    if timings is not None:
        _sync(dev)
        timings["plane_solve_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

    out = _pack_table(_pack_qdf_rows, src, grid.cand_ids, grid.cand_count,
                      bin_centers(grid), qdf(grid.cell_type, nv),
                      torch.float32, dev)
    if timings is not None:
        _sync(dev)
        timings["df_pack_s"] = time.perf_counter() - t0
    return out
