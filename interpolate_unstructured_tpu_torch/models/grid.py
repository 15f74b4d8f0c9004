"""``Grid`` — the unstructured grid as a frozen dataclass of torch tensors.

The port of the JAX package's ``models/grid.py`` (``UGrid``): the same
SoA schema (0-based, batch-first ``(n_cells, npc, 3)`` layouts), the
same per-face ``face_offsets``, the same seed, walk and packed
candidate-row tables, bit for bit, so that the CUDA kernels
(``ops/cand_kernel.py``, ``ops/walk_kernel.py``) read exactly the rows
the TPU kernels read.  Every tensor of a grid lies on one device
(``Grid.device``).

Float32 grids also keep the accurate-mode residuals ``points_lo`` and
``point_data_lo``, the exact float64 remainders of the downcast, bit for
bit as the JAX package stores them; the accurate-mode tables
(``acc_table``, ``cand_df_table``) are built by
``ops.interp_acc.prepare_accurate``.  Host preprocessing runs in float64
numpy, then the tensors move to the device, where the walk and
candidate rows are assembled.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from ..ops import geometry
from ..utils.config import (
    DEFAULT_CONFIG,
    IUConfig,
    huge_distance,
    resolve_config,
    walk_tolerances,
)

# Tensor fields of UGrid (the JAX package's data_fields), in its order
DATA_FIELDS = (
    "points", "cells", "neighbors", "cell_points", "face_normals",
    "face_offsets", "cell_volume", "point_is_at_boundary", "point_data",
    "cell_data", "icell_data", "rmin", "rmax", "bin_table", "bin_rmin",
    "bin_inv_h", "bin_pack", "walk_table", "kd_node_points", "kd_node_ids",
    "cand_ids", "cand_count", "cand_table", "cand_rmin", "cand_inv_h",
    "cand_ext_ids", "cand_ext_slot", "cand_ext_table", "points_lo",
    "point_data_lo", "acc_table", "cand_df_table",
)
META_FIELDS = (
    "cell_type", "bin_shape", "cand_shape", "cand_ext_covers", "cand_nv",
    "cand_qeps", "kd_max_depth", "point_data_names", "cell_data_names",
    "icell_data_names", "locate_mode", "config",
)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Unstructured grid state (schema parity: iu_grid_t, SURVEY.md §2.1)."""

    # --- geometry -----------------------------------------------------------
    points: Any  # (n_points, 3) vertex coordinates (always 3D)
    cells: Any  # (n_cells, npc) int32 connectivity, 0-based
    neighbors: Any  # (n_cells, nf) int32, cell across face k, -1 = boundary
    cell_points: Any  # (n_cells, npc, 3) gathered vertex coords
    face_normals: Any  # (n_cells, nf, 3) outward unit face normals
    face_offsets: Any  # (n_cells, nf) dot(face point, face normal)
    cell_volume: Any  # (n_cells,) area (2D) / signed volume (3D)
    point_is_at_boundary: Any  # (n_points,) bool
    point_data: Any  # (n_points, >= n_point_data)
    cell_data: Any  # (n_cells, >= n_cell_data)
    icell_data: Any  # (n_cells, >= n_icell_data) int32
    rmin: Any  # (3,) bounding box min
    rmax: Any  # (3,) bounding box max
    # --- seed and walk tables ------------------------------------------------
    bin_table: Any = None  # (n_bins,) int32 seed cell per bin
    bin_rmin: Any = None  # (3,)
    bin_inv_h: Any = None  # (3,), 0 for unused dims
    bin_pack: Any = None  # (n_bins, 4): seed id as float | seed center xyz
    walk_table: Any = None  # (n_cells, 512 bytes) packed walk rows
    kd_node_points: Any = None  # (n_cells, 3) kd-tree nodes (seed_mode="kdtree")
    kd_node_ids: Any = None  # (n_cells,) int32
    # --- per-bin candidate tables (ops.geometry.build_candidate_bins) -------
    cand_ids: Any = None  # (n_cand_bins, K) int32, -1 padded
    cand_count: Any = None  # (n_cand_bins,) int32 exact intersection count
    cand_table: Any = None  # (n_cand_bins, row_floats) packed rows
    cand_rmin: Any = None  # (3,)
    cand_inv_h: Any = None  # (3,)
    cand_ext_ids: Any = None  # (n_overflow_bins, k_ext) int32
    cand_ext_slot: Any = None  # (n_cand_bins,) int32, -1 = not overflow
    cand_ext_table: Any = None  # (n_overflow_bins, ext_row_floats)
    # --- accurate mode (ops.interp_acc) ---------------------------------------
    # Exact float64 remainders of the float32 downcast (None on float64
    # grids), and the tables prepare_accurate builds from them.
    points_lo: Any = None  # (n_points, 3) f32
    point_data_lo: Any = None  # (n_points, n_point_data) f32
    acc_table: Any = None  # (n_cells, acc_row_width) f32 hi/lo cell rows
    cand_df_table: Any = None  # (n_cand_bins, df row floats) df-plane rows
    # --- static metadata -----------------------------------------------------
    cell_type: str = "triangle"
    bin_shape: tuple = (1, 1, 1)
    cand_shape: tuple = (1, 1, 1)
    # True when every bin's candidate count fits K + k_ext
    cand_ext_covers: bool = True
    # Leading point-data variables fused into the candidate rows, pinned
    # at pack time (-1 = not packed)
    cand_nv: int = -1
    # Quantized-probe margin fuzz bound (0.0 for f32/f64 row layouts)
    cand_qeps: float = 0.0
    kd_max_depth: int = 0
    point_data_names: tuple = ()
    cell_data_names: tuple = ()
    icell_data_names: tuple = ()
    locate_mode: str = "bruteforce"  # "bruteforce" | "walk"
    config: IUConfig = DEFAULT_CONFIG
    # (nudge, eps_arrive) of every walk on the grid: walk_tolerances of
    # its dtype and extent as Python floats, computed once as the grid
    # is made (dataclasses.replace and to() included), so that no walk
    # reads rmin / rmax back; None on the meta device, which holds no
    # extent to read
    walk_tol: tuple = dataclasses.field(init=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "walk_tol", None if self.rmin.is_meta
                           else walk_tolerances(self.dtype, self.rmin,
                                                self.rmax))

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_points_per_cell(self) -> int:
        return self.cells.shape[1]

    @property
    def n_faces_per_cell(self) -> int:
        # == n_points_per_cell for tri/quad/tet (:865)
        return self.cells.shape[1]

    @property
    def ndim(self) -> int:
        """Spatial dimension of the cells (2 or 3)."""
        return geometry.NDIM_OF_CELL_TYPE[self.cell_type]

    @property
    def n_point_data(self) -> int:
        return len(self.point_data_names)

    @property
    def n_cell_data(self) -> int:
        return len(self.cell_data_names)

    @property
    def n_icell_data(self) -> int:
        return len(self.icell_data_names)

    @property
    def dtype(self) -> torch.dtype:
        return self.points.dtype

    @property
    def device(self) -> torch.device:
        return self.points.device

    def cell_centers(self) -> torch.Tensor:
        """Cell centroid = mean of vertices (iu_get_cell_center,
        :264-269), (n_cells, 3) in the grid's dtype and device: the
        vertices summed left to right, times the reciprocal of their
        count, the JAX package's ``jnp.mean`` bit for bit."""
        cp = self.cell_points
        acc = cp[:, 0]
        for k in range(1, cp.shape[1]):
            acc = acc + cp[:, k]
        return acc * (1.0 / cp.shape[1])

    def to(self, device) -> "Grid":
        """The grid with every tensor leaf on ``device`` (dtypes, bits,
        None leaves and metadata kept); ``self`` if it is there
        already."""
        device = torch.device(device)
        if self.device == device:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in DATA_FIELDS
            if getattr(self, f) is not None})


# The JAX package's name for the grid class
UGrid = Grid


def host_array(t) -> np.ndarray:
    """A tensor (or array) as a host numpy array: one device -> host
    copy for a tensor."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def build_grid(
    points: np.ndarray,
    cells: np.ndarray,
    neighbors: np.ndarray,
    cell_type: str,
    point_data: dict | None = None,
    cell_data: dict | None = None,
    icell_data: dict | None = None,
    coord_scale_factor: float | None = None,
    dtype: torch.dtype | None = None,
    config: IUConfig = DEFAULT_CONFIG,
    locate_mode: str = "auto",
    device: str | torch.device | None = None,
    timings: dict | None = None,
) -> Grid:
    """Build a grid on ``device`` from host arrays.

    Preprocessing (cell point gather, outward unit normals, volumes,
    boundary flags, bbox, seed table, kd-tree, candidate lists) runs on
    the host in float64 — the batch equivalent of iu_read_grid's
    preprocessing chain (:916-925) — then the tensors move to
    ``device`` in ``dtype``, and the walk and candidate rows are
    assembled there.  Walk grids without candidate tables then reseed
    their bin table with the cell containing each bin center
    (``config.refine_bin_seeds``), a walk of every bin center.

    Args:
      points: (n_points, >=2) coordinates; padded to 3D.
      cells: (n_cells, npc) 0-based connectivity.
      neighbors: (n_cells, nf) 0-based adjacency, negative = boundary.
      cell_type: "triangle" | "quad" | "tetra".
      point_data/cell_data/icell_data: name -> 1D array registries.
      coord_scale_factor: optional scaling of coordinates (:858-860).
      dtype: float dtype of the grid; defaults to
        ``torch.get_default_dtype()``.  On the card the kernels of
        both dtypes answer the queries (float64: B1, B2 and B3 in
        double; accurate mode and the fused tracer take float32 grids).
      locate_mode: "auto" picks brute force for meshes of at most
        ``config.bruteforce_max_cells`` cells, walks (seeded by candidate
        rows, bins or the kd-tree) above.
      device: where the grid's tensors live; by default the CUDA device,
        and a process without one raises (pass ``"cpu"`` for the host).
      timings: optional dict, filled with the build's phase split —
        ``host_geometry_s``, ``seed_table_s`` (bin seed table and
        kd-tree), ``transfer_s`` (host arrays -> device, walk rows),
        ``cand_build_s`` (candidate lists, by the host builder or on
        the device by ``ops/cand_build.py``), ``cand_pack_s`` (row
        packing on the device), ``refine_s`` (the bin-seed refine).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_grid puts the grid on the CUDA device by default, "
                "and torch.cuda.is_available() is false; pass device='cpu' "
                "to build on the host"
            )
        device = "cuda"
    device = torch.device(device)
    want_timings = timings is not None
    if timings is None:
        timings = {}
    t0 = time.perf_counter()

    def mark(key):
        nonlocal t0
        if want_timings:
            _sync(device)
        now = time.perf_counter()
        timings[key] = timings.get(key, 0.0) + (now - t0)
        t0 = now

    if cell_type not in geometry.CELL_TYPES:
        raise ValueError(f"Unsupported cell type {cell_type!r}")

    points = np.asarray(points, dtype=np.float64)
    if points.ndim != 2:
        raise ValueError("points must be 2D")
    if points.shape[1] < 3:
        points = np.pad(points, ((0, 0), (0, 3 - points.shape[1])))
    if coord_scale_factor is not None:
        points = points * coord_scale_factor

    cells = np.asarray(cells, dtype=np.int32)
    neighbors = np.asarray(neighbors, dtype=np.int32)
    npc_expected = geometry.N_POINTS_PER_CELL[cell_type]
    if cells.shape[1] != npc_expected:
        raise ValueError(
            f"{cell_type} cells need {npc_expected} vertices, "
            f"got {cells.shape[1]}"
        )
    if neighbors.shape != cells.shape:
        raise ValueError("neighbors must have the same shape as cells")

    n_points = len(points)
    n_cells = len(cells)

    cell_points = geometry.gather_cell_points(points, cells)
    normals, at_boundary = geometry.face_normals_and_boundary(
        cell_points, cells, neighbors, cell_type, n_points
    )
    face_offsets = np.einsum("cki,cki->ck", cell_points, normals)
    volume = geometry.cell_volumes(cell_points, cell_type)
    mark("host_geometry_s")

    if dtype is None:
        dtype = torch.get_default_dtype()
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"grid dtype must be float32 or float64, got {dtype}")
    # Cell ids ride the packed rows as floats: exact while n_cells < 2^24
    # (float32 mantissa); guard so the tables are never silently lossy.
    if n_cells >= (1 << 24) and dtype == torch.float32:
        raise ValueError(
            "float32 grids support up to 2^24 cells (packed walk and "
            "candidate rows); build with dtype=torch.float64"
        )

    rmin = points.min(axis=0)
    rmax = points.max(axis=0)

    if locate_mode == "auto":
        locate_mode = (
            "bruteforce" if n_cells <= config.bruteforce_max_cells else "walk"
        )
    if locate_mode not in ("bruteforce", "walk"):
        raise ValueError(f"Unknown locate_mode {locate_mode!r}")
    if config.seed_mode not in ("bins", "kdtree"):
        raise ValueError(f"Unknown seed_mode {config.seed_mode!r}")
    # Candidate bins take over the whole cold path; an explicit
    # seed_mode="kdtree" opts into kd-seeded cold walks instead
    # (kdtree2 parity, m_interp_unstructured.f90:272-288)
    will_use_cand = (
        config.use_candidate_bins
        and locate_mode == "walk"
        and config.seed_mode != "kdtree"
    )

    ndim = geometry.NDIM_OF_CELL_TYPE[cell_type]
    centers = cell_points.mean(axis=1)
    # When candidate tables own the cold path the nearest-center seed
    # table is only a fallback: keep it coarse there (one cKDTree query
    # per bin).
    bin_table, bin_shape, bin_rmin, bin_inv_h = geometry.build_bin_seed_table(
        centers, rmin, rmax, ndim,
        bins_per_cell=(
            min(config.bins_per_cell, 0.05) if will_use_cand
            else config.bins_per_cell
        ),
        max_bins=config.max_bins,
    )
    # Packed seed rows: [cell id as float | cell center xyz] — a cold
    # start reads one 4-value row instead of id + center
    bin_pack = np.concatenate(
        [bin_table[:, None].astype(np.float64), centers[bin_table]], axis=1
    )
    kd = None
    if config.seed_mode == "kdtree":
        from ..ops import kdtree

        kd = kdtree.build_kdtree(centers, dtype=dtype, device=device)
    mark("seed_table_s")

    # Dtype/domain-scaled inside tolerance (repo invariant: scale every
    # epsilon to the dtype)
    config = resolve_config(config, _np_dtype(dtype), rmin, rmax)

    def stack_registry(reg, n_rows):
        """(names, host array (n_rows, n_names)) of a registry."""
        reg = reg or {}
        names = tuple(reg.keys())
        if names:
            cols = [np.asarray(reg[k]).reshape(n_rows) for k in names]
            data = np.stack(cols, axis=1)
        else:
            data = np.zeros((n_rows, 0))
        return names, data

    pd_names, pd_host = stack_registry(point_data, n_points)
    cd_names, cd_host = stack_registry(cell_data, n_cells)
    icd_names, icd_host = stack_registry(icell_data, n_cells)

    # Accurate-mode residuals (ops.interp_acc): the exact float64
    # remainder of downcasting coordinates and point data to float32
    points_lo = point_data_lo = None
    if dtype == torch.float32:
        points_lo = _to(_f32_residual(points), torch.float32, device)
        point_data_lo = _to(_f32_residual(pd_host), torch.float32, device)

    grid = Grid(
        points=_to(points, dtype, device),
        cells=_to(cells, torch.int32, device),
        neighbors=_to(neighbors, torch.int32, device),
        cell_points=_to(cell_points, dtype, device),
        face_normals=_to(normals, dtype, device),
        face_offsets=_to(face_offsets, dtype, device),
        cell_volume=_to(volume, dtype, device),
        point_is_at_boundary=_to(at_boundary, torch.bool, device),
        point_data=_to(pd_host, dtype, device),
        cell_data=_to(cd_host, dtype, device),
        icell_data=_to(icd_host, torch.int32, device),
        rmin=_to(rmin, dtype, device),
        rmax=_to(rmax, dtype, device),
        bin_table=_to(bin_table, torch.int32, device),
        bin_rmin=_to(bin_rmin, dtype, device),
        bin_inv_h=_to(bin_inv_h, dtype, device),
        bin_pack=_to(bin_pack, dtype, device),
        kd_node_points=None if kd is None else kd.node_points,
        kd_node_ids=None if kd is None else kd.node_ids,
        points_lo=points_lo,
        point_data_lo=point_data_lo,
        cell_type=cell_type,
        bin_shape=bin_shape,
        kd_max_depth=0 if kd is None else kd.max_depth,
        point_data_names=pd_names,
        cell_data_names=cd_names,
        icell_data_names=icd_names,
        locate_mode=locate_mode,
        config=config,
    )
    grid = dataclasses.replace(grid, walk_table=_build_walk_table(grid))
    mark("transfer_s")

    if will_use_cand:
        grid = _add_cand_tables(grid, cell_points, normals, face_offsets,
                                rmin, rmax, ndim, mark)
    if (
        config.refine_bin_seeds
        and locate_mode == "walk"
        and grid.cand_table is None
    ):
        # Bin seeds only matter when cold starts walk (kd-tree mode or
        # candidates off); the refine is one batched self-locate of
        # every bin center
        grid = _refine_bin_seeds(grid, centers)
        mark("refine_s")
    return grid


def _add_cand_tables(grid, cell_points, normals, face_offsets, rmin, rmax,
                     ndim, mark):
    """The grid with its candidate lists (host or device builder, as
    ``config.cand_build`` picks) and packed rows (device), unless the
    row budget holds no candidate."""
    config, dtype, device = grid.config, grid.dtype, grid.device
    cell_type = grid.cell_type
    k_max, nv = candidate_row_capacity(
        cell_type, dtype, config, n_point_data=grid.n_point_data
    )
    if k_max < 1:
        return grid
    (
        cand_ids, cand_count, cand_shape, cand_rmin, cand_inv_h,
        ext_ids, ext_slot,
    ) = build_candidate_bins_dispatch(
        cell_points, normals, face_offsets, rmin, rmax, ndim, k_max,
        dtype, config,
        cover_ok=_make_cover_ok(cell_type, dtype, config, nv, k_max),
        device=device,
    )
    grid = dataclasses.replace(
        grid,
        **_cand_fields(cand_ids, cand_count, cand_shape, cand_rmin,
                       cand_inv_h, ext_ids, ext_slot, dtype, device),
    )
    mark("cand_build_s")
    grid = dataclasses.replace(grid, **_build_cand_tables(grid))
    mark("cand_pack_s")
    return grid


def _cand_fields(cand_ids, cand_count, cand_shape, cand_rmin, cand_inv_h,
                 ext_ids, ext_slot, dtype, device) -> dict:
    """The grid fields of a candidate builder's 7-tuple (host arrays or
    device tensors), on ``device``."""
    cand_count = _to(cand_count, torch.int32, device)
    return dict(
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
    )


def _build_walk_table(grid: Grid) -> torch.Tensor:
    """Packed per-cell walk rows, assembled on the grid's device from the
    tensors already there: face normals (nf*3) | face offsets (nf) |
    neighbor ids as floats (nf) | cell vertex coords (npc*3) | volume,
    zero-padded to a 512-byte row — the JAX package's layout, unchanged,
    so both packages walk bit-identical rows.  Ids are exact as floats
    while n_cells < 2^24 (checked by build_grid)."""
    n_cells, nf = grid.face_offsets.shape
    npc = grid.n_points_per_cell
    cols = torch.cat(
        [
            grid.face_normals.reshape(n_cells, nf * 3),
            grid.face_offsets,
            grid.neighbors.to(grid.dtype),
            grid.cell_points.reshape(n_cells, npc * 3),
            grid.cell_volume[:, None],
        ],
        dim=1,
    )
    row_width = 512 // grid.dtype.itemsize
    pad = max(row_width, cols.shape[1]) - cols.shape[1]
    return torch.nn.functional.pad(cols, (0, pad)).contiguous()


def _refine_bin_seeds(grid: Grid, centers: np.ndarray) -> Grid:
    """Reseed the bin table with the cell *containing* each bin center.

    The nearest-center seed (geometry.build_bin_seed_table) can sit a
    few face hops from the bin itself; one batched self-locate of all
    bin centers (``get_cell`` guessed by the current seeds, so walks of
    kernel B3) replaces it with the containing cell, so cold walks start
    at most a bin radius from their target.  Bin centers in holes or
    outside the domain keep their nearest-center seed.  The bin centers
    are computed in float64 from the grid-dtype origin and sizes, as
    the JAX package computes them.
    """
    from ..ops import locate

    nbx, nby, nbz = grid.bin_shape
    inv_h = grid.bin_inv_h.cpu().numpy()
    h = np.divide(1.0, inv_h, out=np.zeros(3), where=inv_h > 0)
    rmin = grid.bin_rmin.cpu().numpy()
    ax = rmin[0] + (np.arange(nbx) + 0.5) * h[0]
    ay = rmin[1] + (np.arange(nby) + 0.5) * h[1]
    az = rmin[2] + (np.arange(nbz) + 0.5) * h[2]
    gx, gy, gz = np.meshgrid(ax, ay, az, indexing="ij")
    bc = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    if h[2] == 0:  # 2D grids: probe in the mesh plane
        bc[:, 2] = centers[:, 2].mean() if len(centers) else 0.0

    ic, found = locate.get_cell(grid, _to(bc, grid.dtype, grid.device),
                                grid.bin_table)
    new_table = torch.where(found, ic, grid.bin_table).to(torch.int32)
    new_centers = _to(centers, grid.dtype, grid.device)[new_table.long()]
    new_pack = torch.cat(
        [new_table[:, None].to(grid.dtype), new_centers], dim=1
    )
    return dataclasses.replace(grid, bin_table=new_table, bin_pack=new_pack)


def _to(a, dtype: torch.dtype, device) -> torch.Tensor:
    """Host array (or tensor) -> tensor of ``dtype`` on ``device`` (one
    transfer at most)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype)


def grid_from_numpy(leaves: dict, meta: dict, device) -> Grid:
    """A grid from host arrays of the JAX package's ``UGrid`` state.

    ``leaves`` maps data-field names (:data:`DATA_FIELDS`) to numpy
    arrays or None; ``meta`` maps meta-field names to values.  Arrays
    keep their dtype and their bits (float tables are copied, never
    converted), so a grid carried over this way probes exactly the
    tables the JAX package built.  ``meta["config"]`` may be the JAX
    package's ``IUConfig``: its fields are the same.
    """
    unknown = set(leaves) - set(DATA_FIELDS) | set(meta) - set(META_FIELDS)
    if unknown:
        raise ValueError(f"unknown grid fields: {sorted(unknown)}")
    if leaves.get("walk_table") is None:
        raise ValueError("grid_from_numpy needs the walk table")
    device = torch.device(device)
    kw = {}
    for name, a in leaves.items():
        if a is None:
            kw[name] = None
            continue
        kw[name] = torch.from_numpy(np.array(a, order="C")).to(device)
    meta = dict(meta)
    cfg = meta.get("config", DEFAULT_CONFIG)
    if not isinstance(cfg, IUConfig):
        fields = cfg if isinstance(cfg, dict) else dataclasses.asdict(cfg)
        meta["config"] = IUConfig(**fields)
    for key in ("bin_shape", "cand_shape"):
        if key in meta:
            meta[key] = tuple(int(s) for s in meta[key])
    return Grid(**kw, **meta)


def read_grid(
    filename,
    coord_scale_factor: float | None = None,
    dtype: torch.dtype | None = None,
    config: IUConfig = DEFAULT_CONFIG,
    locate_mode: str = "auto",
    device: str | torch.device | None = None,
) -> Grid:
    """Load a grid from a mesh file (converted and cached to .binda) or
    a .binda container directly — parity with iu_read_grid (:820-927),
    in-process instead of shelling out to a converter subprocess.

    The arguments are ``build_grid``'s; ``device`` too: the CUDA device
    by default, and a process without one raises unless
    ``device="cpu"`` is passed."""
    import os

    from ..io.binda import read_binda
    from ..io.convert import convert_to_binda

    filename = os.fspath(filename)
    if not filename.endswith(".binda"):
        filename = convert_to_binda(filename)

    bf = read_binda(filename)

    ix = bf.index("cells")
    if ix < 0:
        raise ValueError("cells not found in binda file")
    # the readers return views of the file's bytes: copy them, so that
    # no tensor of the grid shares read-only memory
    cells = np.array(bf.read_int32(ix))
    cell_type = bf.entries[ix].metadata
    if cell_type not in geometry.CELL_TYPES:
        raise ValueError(f"Cell type {cell_type!r} not supported")

    ix = bf.index("points")
    if ix < 0:
        raise ValueError("points not found in binda file")
    points = np.array(bf.read_float64(ix))

    ix = bf.index("cell_neighbors")
    if ix < 0:
        raise ValueError("cell_neighbors not found in binda file")
    neighbors = np.array(bf.read_int32(ix))

    point_data, cell_data, icell_data = {}, {}, {}
    for i, e in enumerate(bf.entries):
        if e.name == "point_data":
            point_data[e.metadata] = np.array(bf.read_float64(i))
        elif e.name == "cell_data":
            cell_data[e.metadata] = np.array(bf.read_float64(i))
        elif e.name == "icell_data":
            icell_data[e.metadata] = np.array(bf.read_int32(i))

    return build_grid(
        points,
        cells,
        neighbors,
        cell_type,
        point_data=point_data,
        cell_data=cell_data,
        icell_data=icell_data,
        coord_scale_factor=coord_scale_factor,
        dtype=dtype,
        config=config,
        locate_mode=locate_mode,
        device=device,
    )


def _make_cover_ok(cell_type, dtype, config, nv, k_max):
    """Predicate deciding cover-all K widening (see
    IUConfig.cand_cover_row_bytes): the builder calls it with the worst
    bin's exact candidate count once that is known.

    Widening to ``max_count`` is allowed when the widened row (with the
    same ``nv`` fused variables) fits the cover budget AND, for the
    unquantized layouts, the widened K stays out of the post-hoc
    derivation hole of :func:`_cand_capacity_nv` (a K that fits config
    rows bare but not with data would repack with nv = 0)."""
    its = dtype.itemsize
    cfg_f = config.cand_row_bytes // its
    cov_f = config.cand_cover_row_bytes // its
    if cand_is_quantized(cell_type, dtype, config):
        pern = _qcand_floats_per(cell_type, nv)

        def cover_ok_q(max_count: int) -> bool:
            if cov_f <= 0 or max_count <= k_max:
                return False
            return pern * max_count + 2 <= max(cfg_f, cov_f)

        return cover_ok_q
    pern = _cand_floats_per(cell_type, nv)
    per0 = _cand_floats_per(cell_type, 0)

    def cover_ok(max_count: int) -> bool:
        if cov_f <= 0 or max_count <= k_max:
            return False
        need = pern * max_count + 1
        if need <= cfg_f:
            return True  # widens within the config row — always safe
        if need > cov_f:
            return False  # worst bin doesn't fit a cover row
        return per0 * max_count + 1 > cfg_f  # hole check

    return cover_ok


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


def cand_is_quantized(cell_type: str, dtype, config) -> bool:
    """Whether this grid's candidate rows use the int16-quantized
    layout (IUConfig.cand_quantized).  Simplices only: the quad
    inverse-bilinear weights need f32 vertices, and f64 grids keep the
    f64 layout (quantization fuzz would dwarf their tolerance)."""
    return bool(
        config.cand_quantized
        and cell_type in ("triangle", "tetra")
        and dtype == torch.float32
    )


def _qcand_floats_per(cell_type: str, nv: int) -> int:
    """Floats per candidate in a QUANTIZED row (_pack_qcand_rows):
    ceil(3nf/2) int16-pair normal slots + ceil(nf/2) local-offset
    slots + one f32 value plane (gx, gy, gz, c) per fused variable +
    id.  Rows also carry TWO trailing columns (count, dscale)."""
    nf = geometry.N_POINTS_PER_CELL[cell_type]
    return -(-3 * nf // 2) + -(-nf // 2) + 4 * nv + 1


def _qdf_floats_per(cell_type: str, nv: int) -> int:
    """Floats per candidate in an accurate-mode df-plane row
    (_pack_qdf_rows): the quantized probe geometry plus an (hi, lo)
    df32 value plane — (ghx ghy ghz glx gly glz c_hi c_lo) — per fused
    variable, plus id."""
    nf = geometry.N_POINTS_PER_CELL[cell_type]
    return -(-3 * nf // 2) + -(-nf // 2) + 8 * nv + 1


def _cand_floats_per(cell_type: str, nv: int) -> int:
    """Floats per candidate in an unquantized fused row
    (_pack_cand_rows_plain_layout): unit face planes + id + vertex data
    premultiplied by the opposite inverse height (simplices), or planes
    + vertices + id + raw vertex data (quads)."""
    nf = npc = geometry.N_POINTS_PER_CELL[cell_type]
    per = 4 * nf + 1 + npc * nv
    if cell_type == "quad":
        per = 4 * nf + 3 * npc + 1 + npc * nv
    return per


def candidate_row_capacity(cell_type, dtype, config, n_point_data=0):
    """(K, nv): candidates per packed row and how many live point-data
    variables are fused into it.  Fusing stops before K drops below
    ``config.cand_min_k``."""
    row_floats = config.cand_row_bytes // dtype.itemsize
    min_k = max(1, config.cand_min_k)
    if cand_is_quantized(cell_type, dtype, config):
        per_fn, overhead = _qcand_floats_per, 2
    else:
        per_fn, overhead = _cand_floats_per, 1
    for nv in range(n_point_data, -1, -1):
        k = (row_floats - overhead) // per_fn(cell_type, nv)
        if k >= min_k or nv == 0:
            return k, nv
    return 0, 0


def cand_fused_nv(grid: Grid) -> int:
    """How many leading point-data variables are fused into the
    candidate rows: pinned in ``grid.cand_nv`` once packed, else the
    capacity-derived count (:func:`_cand_capacity_nv`)."""
    if grid.cand_ids is None:
        return 0
    if grid.cand_nv >= 0:
        return grid.cand_nv
    return _cand_capacity_nv(grid)


def _cand_capacity_nv(grid: Grid) -> int:
    """Capacity-derived fused-variable count for THIS n_point_data —
    what a (re)pack would choose.  The budget is ``cand_row_bytes``
    normally; a grid whose K doesn't even fit that row bare (nv = 0)
    is a cover-all build (K widened to the worst bin count) and
    budgets ``cand_cover_row_bytes``."""
    if grid.cand_ids is None:
        return 0
    itemsize = grid.dtype.itemsize
    k_max = grid.cand_ids.shape[1]
    cfg = grid.config
    if cand_is_quantized(grid.cell_type, grid.dtype, cfg):
        # Deterministic reconstruction of the build's choice: accept the
        # stored K as the capacity K of any variable count <= the
        # current one, largest first, where the nv round-trips.
        for n_try in range(grid.n_point_data, -1, -1):
            k_t, nv_t = candidate_row_capacity(
                grid.cell_type, grid.dtype, cfg, n_try
            )
            if k_t == k_max:
                k_rt, nv_rt = candidate_row_capacity(
                    grid.cell_type, grid.dtype, cfg, nv_t
                )
                if k_rt == k_max and nv_rt == nv_t:
                    return nv_t
        # No capacity K matches: the K was cover-widened; the capacity
        # nv survives iff the widened row fits the larger budget
        _, nv_cfg = candidate_row_capacity(
            grid.cell_type, grid.dtype, cfg, grid.n_point_data
        )
        budget = max(cfg.cand_row_bytes, cfg.cand_cover_row_bytes) // itemsize
        ok = _qcand_floats_per(grid.cell_type, nv_cfg) * k_max + 2 <= budget
        return nv_cfg if ok else 0
    row_floats = cfg.cand_row_bytes // itemsize
    if _cand_floats_per(grid.cell_type, 0) * k_max + 1 > row_floats:
        row_floats = cfg.cand_cover_row_bytes // itemsize
    nv = 0
    while (
        nv < grid.n_point_data
        and _cand_floats_per(grid.cell_type, nv + 1) * k_max + 1 <= row_floats
    ):
        nv += 1
    return nv


# ---------------------------------------------------------------------------
# Candidate-row packing (on the grid's device)
# ---------------------------------------------------------------------------

QCAND_NSCALE = 32767.0  # int16 full scale for unit normal components


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


def _pad_record_stride(used: int, itemsize: int) -> int:
    """Record width padded to a 256-byte multiple, as the JAX package
    pads it (kept so the pack-source records match)."""
    step = 256 // itemsize
    return -(-used // step) * step


def _pack_source_chunk(k_max: int, src_floats: int, itemsize: int) -> int:
    """Rows per packing step, sized so the materialized (chunk, K, S)
    record gather stays ~<= 128 MB."""
    per_row = max(k_max * src_floats * itemsize, 1)
    c = (128 << 20) // per_row
    return max(1 << 12, min(1 << 18, 1 << max(int(c).bit_length() - 1, 0)))


def _pack_src_rows(grid: Grid, nv: int) -> torch.Tensor:
    """Per-cell pack-source records: one row per cell carrying
    everything the candidate-row packers read per candidate."""
    n_cells, nf = grid.face_offsets.shape
    npc = grid.n_points_per_cell
    cols = [
        grid.face_normals.reshape(n_cells, nf * 3),
        grid.face_offsets,
        grid.cell_points.reshape(n_cells, npc * 3),
    ]
    if nv:
        vtx = grid.point_data[:, :nv][grid.cells.long()]  # (C, npc, nv)
        cols.append(vtx.reshape(n_cells, npc * nv))
    rows = torch.cat(cols, dim=1)
    pad = _pad_record_stride(rows.shape[1], grid.dtype.itemsize) - rows.shape[1]
    return torch.nn.functional.pad(rows, (0, pad))


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


def _finish_rows(parts_bits, row_floats):
    """Concatenate int32 bit columns into rows padded with zeros to the
    physical row width, returned as float32 (a bit view)."""
    rows = torch.cat(parts_bits, dim=1)
    pad = max(row_floats, rows.shape[1]) - rows.shape[1]
    return torch.nn.functional.pad(rows, (0, pad)).view(torch.float32)


def _pack_qcand_rows(src, ids, count_vals, centers, *, cell_type,
                     row_floats, nv):
    """Quantized candidate rows (f32 simplices; IUConfig.cand_quantized).

    Role layout (K-wide roles, column role*K + k; _qcand_floats_per):

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
    nf = npc = geometry.N_POINTS_PER_CELL[cell_type]

    g = src[ids.clamp_min(0).long()]  # (n, K, S) — one record gather
    normals, offs, cp, vtx = _split_src(g, nf, npc, nv)
    centers, parts, ds = _quantize_probe_geometry(normals, offs, ids, centers)
    normals = normals.to(torch.float32)
    offs = offs.to(torch.float32)
    if nv:
        dev = ids.device
        fv = (torch.arange(npc, device=dev) + 1) % npc  # face of vertex v
        opp = (torch.arange(nf, device=dev) - 1) % npc  # vertex opp. face f
        p_opp = cp[:, :, opp]
        m_opp = offs - _sum3(normals * p_opp)
        inv_f = 1.0 / torch.where(m_opp == 0, torch.ones_like(m_opp), m_opp)
        iv_vertex = inv_f[..., fv]  # (n, K, npc)
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
    parts += [
        _bits(ids.to(torch.float32)),
        _bits(count_vals.to(torch.float32)[:, None]),
        _bits(ds.to(torch.float32)[:, None]),
    ]
    return _finish_rows(parts, row_floats)


def _pack_cand_rows_plain_layout(src, ids, count_vals, *, cell_type,
                                 row_floats, nv, dtype):
    """Unquantized fused candidate rows (f64 grids, quads, and f32
    simplices with ``cand_quantized=False``), role-major:

      tri/tet: [nx_f | ny_f | nz_f | off_f | id | data(var,vtx) | count]
      quad:    [nx_f | ny_f | nz_f | off_f | vtx(v,dim) | id | data | count]

    Simplex data of vertex v is premultiplied by its inverse height, so
    the probe forms values straight from the face margins.  Invalid
    (padding) slots get -huge offsets so their margin can never win."""
    n_rows, k_max = ids.shape
    nf = npc = geometry.N_POINTS_PER_CELL[cell_type]

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
    if cell_type == "quad":
        parts.append(_roles(cp.reshape(n_rows, k_max, npc * 3)))
    parts.append(ids.to(dtype))
    if nv:
        if cell_type != "quad":
            dev = ids.device
            opp = (torch.arange(nf, device=dev) - 1) % npc
            p_opp = cp[:, :, opp]  # (n, K, nf, 3)
            m_opp = offs - _sum3(normals * p_opp)
            inv_f = 1.0 / torch.where(
                m_opp == 0, torch.ones_like(m_opp), m_opp
            )
            iv_vertex = inv_f[..., (torch.arange(npc, device=dev) + 1) % npc]
            vtx = vtx * iv_vertex[..., None]
        parts.append(
            _roles(vtx.transpose(2, 3).reshape(n_rows, k_max, -1))
        )
    parts.append(count_vals.to(dtype)[:, None])
    rows = torch.cat(parts, dim=1)
    pad = max(row_floats, rows.shape[1]) - rows.shape[1]
    return torch.nn.functional.pad(rows, (0, pad))


def _pack_cand_rows(grid: Grid, ids, count_vals, row_floats, nv,
                    centers=None):
    """Candidate-row packer: build the per-cell source record once, then
    pack row chunks straight into one preallocated table, so the
    (chunk, K, S) record gather stays memory-bounded.  ``centers``
    (bin centers per row) selects the quantized layout."""
    src = _pack_src_rows(grid, nv)
    chunk = _pack_source_chunk(ids.shape[1], src.shape[1],
                               grid.dtype.itemsize)
    n = ids.shape[0]
    out = None
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        if centers is not None:
            rows = _pack_qcand_rows(
                src, ids[lo:hi], count_vals[lo:hi], centers[lo:hi],
                cell_type=grid.cell_type, row_floats=row_floats, nv=nv,
            )
        else:
            rows = _pack_cand_rows_plain_layout(
                src, ids[lo:hi], count_vals[lo:hi],
                cell_type=grid.cell_type, row_floats=row_floats, nv=nv,
                dtype=grid.dtype,
            )
        if out is None:
            out = torch.empty((n, rows.shape[1]), dtype=rows.dtype,
                              device=rows.device)
        # copy as int32 bits where rows carry packed int16 words
        if centers is not None:
            out.view(torch.int32)[lo:hi] = rows.view(torch.int32)
        else:
            out[lo:hi] = rows
    if out is None:
        out = torch.zeros((0, row_floats), dtype=grid.dtype,
                          device=grid.device)
    return out


def cand_bin_centers(grid: Grid, bin_idx: torch.Tensor) -> torch.Tensor:
    """(n,) flat bin indices -> (n, 3) bin centers (the quantized rows'
    local frame origins)."""
    cx, cy, cz = geometry.cand_bin_center_cols(
        grid.cand_rmin, grid.cand_inv_h,
        *geometry.cand_bin_decode(
            bin_idx, grid.cand_shape[1], grid.cand_shape[2]
        ),
    )
    return torch.stack([cx, cy, cz], dim=1)


def _build_cand_tables(grid: Grid, nv: int | None = None) -> dict:
    """Main + overflow-extension candidate tables.

    The main table's count column encodes overflow redirection: the
    exact count where it fits K, else ``K + 1 + ext_slot`` — the probe
    recovers both the overflow flag and the extension row from the
    value it already reads.  The extension rows' count column carries
    the bin's exact total count.

    The physical row width is the needed floats for this grid's K
    rounded up to a 512-byte multiple, as in the JAX package, so both
    packages build tables of the same shape.  ``nv`` overrides the
    fused-variable count (clamped to the capacity); ``set_point_data``
    passes the pinned count so that a repack never fuses a variable
    added with ``fuse=False``."""
    k_max = grid.cand_ids.shape[1]
    cap_nv = _cand_capacity_nv(grid)
    nv = cap_nv if nv is None or nv < 0 else min(nv, cap_nv)
    quantized = cand_is_quantized(grid.cell_type, grid.dtype, grid.config)
    step = 512 // grid.dtype.itemsize
    if quantized:
        per = _qcand_floats_per(grid.cell_type, nv)
        overhead = 2  # count + dscale columns
    else:
        per = _cand_floats_per(grid.cell_type, nv)
        overhead = 1
    row_floats = -(-(per * k_max + overhead) // step) * step
    dev = grid.device
    centers = (
        cand_bin_centers(
            grid,
            torch.arange(grid.cand_ids.shape[0], dtype=torch.int32,
                         device=dev),
        )
        if quantized
        else None
    )
    if grid.cand_ext_ids is not None:
        count_enc = torch.where(
            grid.cand_count > k_max,
            k_max + 1 + grid.cand_ext_slot.clamp_min(0),
            grid.cand_count,
        )
    else:
        count_enc = grid.cand_count
    out = {
        "cand_table": _pack_cand_rows(
            grid, grid.cand_ids, count_enc, row_floats, nv,
            centers=centers,
        ),
        "cand_nv": nv,
        # any repack invalidates the accurate-mode df-plane rows (their
        # fused values and nv would go stale); prepare_accurate rebuilds
        # them, and interpolate_at_acc takes the at-known-cell path
        # meanwhile
        "cand_df_table": None,
    }
    ds_max = 0.0
    if quantized:
        ds_max = float(out["cand_table"][:, per * k_max + 1].max())
    if grid.cand_ext_ids is not None:
        k_ext = grid.cand_ext_ids.shape[1]
        ext_floats = -(-(k_ext * per + overhead) // step) * step
        # overflow-bin indices in ext-slot order: ext_slot is assigned
        # in ascending bin order, and a stable sort of the "not
        # overflow" flag lists those bins first in that same order
        over_order = torch.sort(
            (grid.cand_ext_slot < 0).to(torch.int8), stable=True
        ).indices[: grid.cand_ext_ids.shape[0]]
        over_count = grid.cand_count[over_order]
        out["cand_ext_table"] = _pack_cand_rows(
            grid, grid.cand_ext_ids, over_count, ext_floats, nv,
            centers=cand_bin_centers(grid, over_order) if quantized else None,
        )
        if quantized:
            ds_max = max(
                ds_max,
                float(out["cand_ext_table"][:, per * k_ext + 1].max()),
            )
    else:
        out["cand_ext_table"] = None
    if quantized:
        # Margin fuzz bound of the quantized probe: offset rounding
        # (0.5 dscale) + normal rounding over |r_local| <= h/2 per dim.
        inv_h = grid.cand_inv_h.detach().cpu().numpy().astype(np.float64)
        h_sum = float(
            np.where(inv_h > 0, 1.0 / np.where(inv_h > 0, inv_h, 1), 0.0).sum()
        )
        out["cand_qeps"] = 0.5 * ds_max + (0.25 / QCAND_NSCALE) * h_sum
    else:
        out["cand_qeps"] = 0.0
    return out


# ---------------------------------------------------------------------------
# Accurate-mode df-plane candidate rows
# ---------------------------------------------------------------------------


def _pack_dfsrc_rows(face_normals, face_offsets, plane_hi, plane_lo, nv):
    """Per-cell accurate-mode pack-source records (f32):
    [normals nf*3 | offsets nf | plane_hi nv*4 | plane_lo nv*4],
    padded to a 256-byte-multiple stride."""
    n_cells, nf = face_offsets.shape
    rows = torch.cat(
        [
            face_normals.to(torch.float32).reshape(n_cells, nf * 3),
            face_offsets.to(torch.float32),
            plane_hi.reshape(n_cells, nv * 4),
            plane_lo.reshape(n_cells, nv * 4),
        ],
        dim=1,
    )
    pad = _pad_record_stride(rows.shape[1], 4) - rows.shape[1]
    return torch.nn.functional.pad(rows, (0, pad))


def _pack_qdf_rows(src, ids, count_vals, centers, *, cell_type, row_floats,
                   nv):
    """Accurate-mode candidate rows: the quantized int16 probe geometry
    (the same words as _pack_qcand_rows) + df32 value planes.  ``src``
    is the per-cell df record table (_pack_dfsrc_rows).

    The planes are the (hi, lo) float32 split of the per-cell float64
    interpolant v(r) = g . r + c (exact for simplices, solved on the host
    by solve_cell_planes_f64).  The offset is re-anchored at the bin
    center in df32, c_loc = c + g . c_bin, so the probe evaluates
    v = g . r_local + c_loc with r_local = r - c_bin carried as an exact
    (hi, lo) pair.

    Role layout (K-wide roles, column role*K + k; _qdf_floats_per):
      [qn | qd | (ghx ghy ghz glx gly glz ch cl) per var | id] * K
      | count | dscale
    """
    from ..ops import df32

    n_rows, k_max = ids.shape
    nf = geometry.N_POINTS_PER_CELL[cell_type]
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
    cols = torch.stack(
        [gd[0][0], gd[1][0], gd[2][0], gd[0][1], gd[1][1], gd[2][1],
         acc[0], acc[1]],
        dim=-1,
    )  # (n, K, nv, 8)
    parts.append(_bits(_roles(cols.reshape(n_rows, k_max, nv * 8))))
    parts += [
        _bits(ids.to(torch.float32)),
        _bits(count_vals.to(torch.float32)[:, None]),
        _bits(ds.to(torch.float32)[:, None]),
    ]
    return _finish_rows(parts, row_floats)


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


def cand_df_supported(grid: Grid) -> bool:
    """Gate for the fused accurate rows: float32 simplex cover grids
    with quantized candidate tables and at least one fused variable."""
    return (
        grid.cand_ids is not None
        and grid.cand_ext_table is None
        and grid.cand_ext_covers
        and grid.cell_type in ("triangle", "tetra")
        and grid.dtype == torch.float32
        and cand_is_quantized(grid.cell_type, grid.dtype, grid.config)
        and cand_fused_nv(grid) >= 1
    )


def _host_f64(hi, lo):
    """hi (+ lo when stored) as a float64 host array."""
    a = hi.detach().cpu().numpy().astype(np.float64)
    if lo is not None:
        a = a + lo.detach().cpu().numpy().astype(np.float64)
    return a


def build_cand_df_table(grid: Grid, timings: dict | None = None):
    """Assemble the accurate-mode fused candidate rows (see
    _pack_qdf_rows).  The planes are solved on the host in float64 from
    the stored (hi, lo) mesh and data split; without stored residuals
    accuracy is bounded by the float32 representation.  The rows are
    packed on the grid's device in chunks written straight into one
    table (as int32 bits: the int16 words are often NaN patterns).

    ``timings``, when given, gets ``plane_solve_s`` (host solve and the
    transfer of the planes) and ``df_pack_s`` (the device packing)."""
    t0 = time.perf_counter()
    nv = cand_fused_nv(grid)
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

    k_max = grid.cand_ids.shape[1]
    per = _qdf_floats_per(grid.cell_type, nv)
    step = 512 // 4
    row_floats = -(-(per * k_max + 2) // step) * step
    n = grid.cand_ids.shape[0]
    centers = cand_bin_centers(
        grid, torch.arange(n, dtype=torch.int32, device=dev)
    )
    chunk = _pack_source_chunk(k_max, src.shape[1], 4)
    out = torch.zeros((n, row_floats), dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        rows = _pack_qdf_rows(
            src, grid.cand_ids[lo:hi], grid.cand_count[lo:hi],
            centers[lo:hi], cell_type=grid.cell_type,
            row_floats=row_floats, nv=nv,
        )
        out.view(torch.int32)[lo:hi] = rows.view(torch.int32)
    if timings is not None:
        _sync(dev)
        timings["df_pack_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Data registry
# ---------------------------------------------------------------------------


def get_point_data_index(grid: Grid, name: str) -> int:
    """Index of a point-data variable, -1 if absent (:106-116)."""
    try:
        return grid.point_data_names.index(name)
    except ValueError:
        return -1


def get_cell_data_index(grid: Grid, name: str) -> int:
    """Index of a cell-data variable, -1 if absent."""
    try:
        return grid.cell_data_names.index(name)
    except ValueError:
        return -1


def get_icell_data_index(grid: Grid, name: str) -> int:
    """Index of an integer cell-data variable, -1 if absent."""
    try:
        return grid.icell_data_names.index(name)
    except ValueError:
        return -1


def _reserve(data, n_extra):
    pad = torch.zeros((data.shape[0], n_extra), dtype=data.dtype,
                      device=data.device)
    return torch.cat([data, pad], dim=1)


def reserve_point_data_storage(grid: Grid, n: int) -> Grid:
    """Grow point-data storage by n zero-initialized columns (:204-221).

    Reserved columns don't change ``n_point_data``; a later ``add`` fills
    them without reallocating."""
    return dataclasses.replace(grid, point_data=_reserve(grid.point_data, n))


def reserve_cell_data_storage(grid: Grid, n: int) -> Grid:
    """Grow cell-data storage by n zero-initialized columns."""
    return dataclasses.replace(grid, cell_data=_reserve(grid.cell_data, n))


def reserve_icell_data_storage(grid: Grid, n: int) -> Grid:
    """Grow integer cell-data storage by n zero-initialized columns."""
    return dataclasses.replace(grid, icell_data=_reserve(grid.icell_data, n))


def _column(values, n_rows, like):
    """``values`` (None = zeros) as an (n_rows,) tensor of ``like``'s
    dtype on its device."""
    if values is None:
        return torch.zeros(n_rows, dtype=like.dtype, device=like.device)
    return torch.as_tensor(values).to(
        dtype=like.dtype, device=like.device).reshape(n_rows)


def _add_column(data, names, name, values, n_rows):
    """Fill the first reserved column, or grow by one.  The grid's old
    tensor is left as it was (grids are values, as in the JAX package).

    Each family checks its *own* capacity: the reference reuses the
    point-data count in all three adders (capacity bug, :124/:139; see
    SURVEY.md §2.2 'known bug — don't replicate')."""
    i_var = len(names)
    col = _column(values, n_rows, data)
    if data.shape[1] > i_var:  # reserved capacity available
        data = data.clone()
        data[:, i_var] = col
    else:
        data = torch.cat([data, col[:, None]], dim=1)
    return data, names + (name,), i_var


def _f32_residual(a64):
    """Exact float64 -> float32 downcast remainder, elementwise (numpy,
    any shape)."""
    a64 = np.asarray(a64, np.float64)
    return (a64 - a64.astype(np.float32).astype(np.float64)).astype(np.float32)


def _f32_residual_column(values, n_points, device):
    """Accurate-mode residual of one point-data column: the exact
    float64 -> float32 remainder as an (n_points,) float32 tensor on
    ``device``, zeros when the input carries no float64 information
    (None, or a typed array or tensor of another dtype).  Scalars
    broadcast.  The one definition that build_grid, add_point_data and
    set_point_data share, so that their hi + lo sums agree."""
    zeros = torch.zeros(n_points, dtype=torch.float32, device=device)
    if values is None:
        return zeros
    if isinstance(values, torch.Tensor):
        if values.dtype != torch.float64:
            return zeros
        v = values.to(device).broadcast_to((n_points,))
        return (v - v.to(torch.float32).to(torch.float64)).to(torch.float32)
    v = np.asarray(values)
    if v.dtype != np.float64:
        return zeros
    return _to(_f32_residual(np.broadcast_to(v, (n_points,))),
               torch.float32, device)


def _refresh_cand_data(grid: Grid, i_var: int | None = None,
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
    nv_now = cand_fused_nv(grid)
    limit = _cand_capacity_nv(grid) if extend else nv_now
    if i_var is not None and i_var >= limit:
        return grid
    return dataclasses.replace(
        grid, **_build_cand_tables(grid, nv=None if extend else nv_now)
    )


def add_point_data(grid: Grid, name: str, values=None, fuse: bool = True):
    """Append a named point-data variable (iu_add_point_data, :149-161).

    Returns ``(new_grid, i_var)``.  ``values`` defaults to zeros.

    ``fuse=False`` skips extending the fused candidate rows to the new
    variable (a repack of every row): the variable still interpolates
    through the generic path and the tracer, it just does not ride the
    one-row candidate probe.

    On float32 grids the accurate-mode residual registry gets the
    column's exact float64 remainder (zeros unless float64 values were
    given), and an ``acc_table`` is rebuilt for the new width."""
    data, names, i_var = _add_column(
        grid.point_data, grid.point_data_names, name, values, grid.n_points
    )
    grid = dataclasses.replace(grid, point_data=data, point_data_names=names)
    if grid.point_data_lo is not None:
        lo, _, _ = _add_column(
            grid.point_data_lo, grid.point_data_names[:-1], name,
            _f32_residual_column(values, grid.n_points, grid.device),
            grid.n_points,
        )
        grid = dataclasses.replace(grid, point_data_lo=lo)
    if grid.acc_table is not None:
        from ..ops.interp_acc import build_acc_table

        grid = dataclasses.replace(grid, acc_table=build_acc_table(grid))
    if not fuse:
        return grid, i_var
    return _refresh_cand_data(grid, i_var), i_var


def add_cell_data(grid: Grid, name: str, values=None):
    """Append a named cell-data variable; returns ``(new_grid, i_var)``."""
    data, names, i_var = _add_column(
        grid.cell_data, grid.cell_data_names, name, values, grid.n_cells
    )
    return (
        dataclasses.replace(grid, cell_data=data, cell_data_names=names),
        i_var,
    )


def add_icell_data(grid: Grid, name: str, values=None):
    """Append a named integer cell-data variable; returns
    ``(new_grid, i_var)``."""
    data, names, i_var = _add_column(
        grid.icell_data, grid.icell_data_names, name, values, grid.n_cells
    )
    return (
        dataclasses.replace(grid, icell_data=data, icell_data_names=names),
        i_var,
    )


def set_point_data(grid: Grid, i_var: int, values) -> Grid:
    """Overwrite one point-data column (test_tetra.f90:37-40 pattern).

    The accurate-mode residual column and the column's ``acc_table``
    slots follow (the exact float64 remainder when float64 values were
    given, zeros otherwise)."""
    nv = grid.n_point_data
    i_var = int(i_var)
    if not -nv <= i_var < nv:
        raise ValueError(f"i_var {i_var} outside the live point-data range")
    i_var %= nv  # python-style wrap, normalized so the fused-column
    #              skip below sees a real slot
    data = grid.point_data.clone()
    data[:, i_var] = torch.as_tensor(values).to(dtype=data.dtype,
                                                device=data.device)
    grid = dataclasses.replace(grid, point_data=data)
    if grid.point_data_lo is not None:
        lo = grid.point_data_lo.clone()
        lo[:, i_var] = _f32_residual_column(values, grid.n_points, grid.device)
        grid = dataclasses.replace(grid, point_data_lo=lo)
    if grid.acc_table is not None:
        from ..ops.interp_acc import update_acc_table_column

        grid = dataclasses.replace(
            grid, acc_table=update_acc_table_column(grid, i_var)
        )
    return _refresh_cand_data(grid, i_var, extend=False)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


def write_vtk(grid: Grid, filename) -> None:
    """Write the grid and all live data arrays to a .vtu file — parity
    with iu_write_vtk (:929-985); the same bytes as the JAX package's
    ``write_vtk`` of the same grid."""
    from ..io.vtk import write_vtu

    write_vtu(
        filename,
        host_array(grid.points).astype(np.float64),
        host_array(grid.cells),
        grid.cell_type,
        point_data={
            name: host_array(grid.point_data[:, i]).astype(np.float64)
            for i, name in enumerate(grid.point_data_names)
        },
        cell_data={
            name: host_array(grid.cell_data[:, i]).astype(np.float64)
            for i, name in enumerate(grid.cell_data_names)
        },
        icell_data={
            name: host_array(grid.icell_data[:, i])
            for i, name in enumerate(grid.icell_data_names)
        },
    )
