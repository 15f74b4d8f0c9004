"""``Grid`` — the unstructured grid as a frozen dataclass of torch tensors.

The port of the JAX package's ``models/grid.py`` (``UGrid``): the same
SoA schema (0-based, batch-first ``(n_cells, npc, 3)`` layouts), the
same per-face ``face_offsets``, the same seed, walk and packed
candidate-row tables, bit for bit, so that the CUDA kernels
(``ops/cand_kernel.py``, ``ops/walk_kernel.py``) read exactly the rows
the TPU kernels read.  The candidate table's format, sizing, lists and
packing live in ``models/cand_table.py``.  Every tensor of a grid lies
on one device (``Grid.device``).

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
    # --- per-bin candidate tables (models/cand_table.py) -------------------
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
        from . import cand_table

        size = cand_table.sizing(grid)
        if size.k >= 1:  # the row budget holds a candidate
            grid = cand_table.build_lists(grid, cell_points, normals,
                                          face_offsets, rmin, rmax, size)
            mark("cand_build_s")
            grid = dataclasses.replace(grid, **cand_table.pack(grid))
            mark("cand_pack_s")
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
    from .cand_table import refresh

    return refresh(grid, i_var), i_var


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
    from .cand_table import refresh

    return refresh(grid, i_var, extend=False)


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
