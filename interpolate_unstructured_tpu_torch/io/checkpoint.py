"""Grid checkpointing: save/load a fully preprocessed ``Grid``.

The port of the JAX package's ``io/checkpoint.py``, in its binda v5
layout, so that each package loads what the other saved: the same
entries, names, dtypes and metadata strings, and the same bytes for the
same grid.

The reference's only persistence is the ``.binda`` cache of the
*converted* mesh (convert_to_binary.py:180-183) — preprocessing
(normals, volumes, seed tables, candidate lists) reruns on every load.
Here the whole preprocessed grid state round-trips through the same
binda container format, so reloading a large grid skips the host
geometry and the candidate builder.

The container is self-describing: scalar metadata rides in the entry
metadata strings, data-family names in per-column entries, so the files
remain readable by any binda tool (including the Fortran reader).
Each array entry's metadata is its numpy dtype name (``"float32"``,
``"int32"``, ``"bool"``), which both packages restore on load.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models import cand_table
from .binda import BindaWriter, read_binda

# v4 adds overflow-extension candidate lists; v5 sheds the two
# device-derivable leaves from the container: cell_points (=
# points[cells], a pure gather, so deriving it at load is bit-exact in
# every dtype path) and the zero-padded cand_ids rectangle, stored
# ragged as cand_flat + cand_count instead.
_FORMAT_VERSION = "5"

# Grid tensor leaves stored verbatim (name -> attribute)
_ARRAY_FIELDS = [
    "points",
    "cells",
    "neighbors",
    "face_normals",
    "face_offsets",
    "cell_volume",
    "point_is_at_boundary",
    "point_data",
    "cell_data",
    "icell_data",
    "rmin",
    "rmax",
    "bin_table",
    "bin_rmin",
    "bin_inv_h",
    "bin_pack",
]

# Optional leaves: stored when present, reconstructed/None otherwise.
# The packed derived tables (walk_table, cand_table, cand_ext_table) are
# NOT stored: they are assembled on the device from the leaves above at
# load time (models.grid._build_walk_table / models.cand_table.pack).
_OPTIONAL_FIELDS = [
    "kd_node_points",
    "kd_node_ids",
    "cand_count",
    "cand_rmin",
    "cand_inv_h",
    "cand_ext_ids",
    "cand_ext_slot",
    # accurate-mode float64 residuals (f32 grids; ops.interp_acc).
    # acc_table and cand_df_table are derived — prepare_accurate
    # rebuilds them.
    "points_lo",
    "point_data_lo",
]

_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def _expand_cand_rows(flat, counts, k):
    """Re-expand ragged v5 candidate lists to the (bins, K) rectangle on
    the tensors' device (row-major live slots -> rows padded with -1)."""
    if flat.numel() == 0:
        return torch.full((counts.shape[0], k), -1, dtype=torch.int32,
                          device=counts.device)
    # counts can exceed K (overflow-extension entries are counted); the
    # stored row carries the first min(count, K) slots
    eff = counts.clamp_max(k).to(torch.int64)
    offs = torch.cumsum(eff, 0) - eff
    kk = torch.arange(k, dtype=torch.int64, device=counts.device)
    idx = (offs[:, None] + kk[None, :]).clamp_(0, flat.numel() - 1)
    vals = flat[idx]
    return torch.where(kk[None, :] < eff[:, None], vals,
                       torch.full_like(vals, -1))


def save_grid(grid, filename) -> None:
    """Serialize a preprocessed grid (tensor leaves + registry names +
    static metadata) into a binda container."""
    from ..models.grid import host_array as _host

    w = BindaWriter()
    meta = ",".join(
        [
            _FORMAT_VERSION,
            grid.cell_type,
            grid.locate_mode,
            "x".join(str(s) for s in grid.bin_shape),
            str(grid.kd_max_depth),
            "x".join(str(s) for s in grid.cand_shape),
            "1" if grid.cand_ext_covers else "0",
            str(grid.cand_nv),
            # v5: the padded candidate-list width K — cand_ids is
            # stored ragged, so its rectangle shape must ride here
            str(-1 if grid.cand_ids is None else grid.cand_ids.shape[1]),
        ]
    )
    w.add_entry("ugrid_header", np.zeros(1, dtype=np.int32), meta)
    for name in _ARRAY_FIELDS + _OPTIONAL_FIELDS:
        value = getattr(grid, name)
        if value is None:  # optional leaves (kd-tree seed backend)
            continue
        arr = _host(value)
        orig_dtype = str(arr.dtype)  # numpy name, before the bool cast
        if arr.dtype == np.bool_:
            arr = arr.astype(np.int32)
        w.add_entry(f"grid/{name}", arr, orig_dtype)
    if grid.cand_ids is not None:
        # Ragged candidate lists: live slots only, row-major.  The
        # (bins, K) rectangle is re-expanded on the device at load from
        # cand_count (stored above).
        ids = _host(grid.cand_ids)
        # cand_count counts ALL candidates of a bin including the
        # overflow-extension entries, so it can exceed K: the main row
        # holds the first min(count, K), front-packed
        cnt = np.minimum(_host(grid.cand_count), ids.shape[1])
        mask = np.arange(ids.shape[1], dtype=np.int32)[None, :] < cnt[:, None]
        w.add_entry("grid/cand_flat", ids[mask], "int32")
    for i, nm in enumerate(grid.point_data_names):
        w.add_entry("point_data_name", np.array([i], dtype=np.int32), nm)
    for i, nm in enumerate(grid.cell_data_names):
        w.add_entry("cell_data_name", np.array([i], dtype=np.int32), nm)
    for i, nm in enumerate(grid.icell_data_names):
        w.add_entry("icell_data_name", np.array([i], dtype=np.int32), nm)
    w.write_to_file(filename)


def load_grid(filename, config=None, dtype=None, resave_on_rebuild=False,
              timings=None, device=None):
    """Reload a grid saved by :func:`save_grid` (by either package) onto
    ``device`` — no host preprocessing when the session's config matches.

    ``device``: as in ``build_grid``, the CUDA device by default; a
    process without one raises unless ``device="cpu"`` is passed.

    ``timings``: optional dict, filled with the load's phase split —
    ``read_s`` (checkpoint bytes -> host arrays -> device tensors, the
    candidate rows re-expanded), ``rebuild_s`` (candidate-list rebuild,
    ~0 on a config-matching load), and ``tables_s`` (walk and candidate
    row packing on the device).  The device is synchronized at each
    phase end only when timings are asked for.

    The saved float dtype is restored exactly: a float64 checkpoint
    loads as a float64 grid, as ``build_grid(dtype=torch.float64)``
    builds one.  ``dtype=torch.float32`` downcasts explicitly, with
    ``build_grid``'s 2^24-cell float32 guard.

    When the stored candidate lists no longer match this session's
    config (capacity or bin-shape drift, a dtype change, a pre-v4 file),
    they are rebuilt on load from the stored geometry by the builder
    that ``config.cand_build`` picks (``cand_table.stale`` decides,
    ``cand_table.build_lists`` rebuilds, in the load dtype, on
    ``device``), as the JAX package rebuilds.
    ``resave_on_rebuild`` writes the refreshed grid back to ``filename``
    so the cost is paid once, never across a dtype change.
    """
    from ..models.grid import Grid, _sync
    from ..utils.config import DEFAULT_CONFIG, resolve_config

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "load_grid puts the grid on the CUDA device by default, "
                "and torch.cuda.is_available() is false; pass device='cpu' "
                "to load on the host"
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
        timings[key] = now - t0
        t0 = now

    bf = read_binda(filename)
    ix = bf.index("ugrid_header")
    if ix < 0:
        raise ValueError(f"{filename} is not a saved UGrid container")
    parts = bf.entries[ix].metadata.split(",")
    version, cell_type, locate_mode, bin_shape_s = parts[:4]
    if version not in ("1", "2", "3", "4", "5"):
        raise ValueError(f"Unsupported grid checkpoint version {version}")
    kd_max_depth = int(parts[4]) if len(parts) > 4 else 0
    bin_shape = tuple(int(s) for s in bin_shape_s.split("x"))
    cand_shape = (
        tuple(int(s) for s in parts[5].split("x"))
        if len(parts) > 5
        else (1, 1, 1)
    )
    ext_covers = parts[6] == "1" if len(parts) > 6 else True
    cand_nv = int(parts[7]) if len(parts) > 7 else -1
    cand_k = int(parts[8]) if len(parts) > 8 else -1  # v5 ragged width

    host_arrays = {}
    for i, e in enumerate(bf.entries):
        if e.name.startswith("grid/"):
            # binda readers widen (int64/float64); restore the exact
            # dtype recorded at save time
            host_arrays[e.name[len("grid/") :]] = bf.read(i).astype(e.metadata)

    saved_dtype = host_arrays["points"].dtype
    target = (
        saved_dtype
        if dtype is None
        else np.dtype(str(dtype).replace("torch.", ""))
    )
    if target not in _TORCH_DTYPE:
        raise ValueError(f"grid dtype must be float32 or float64, got {dtype}")
    n_cells = host_arrays["cells"].shape[0]
    if target == np.float32 and n_cells >= (1 << 24):
        raise ValueError(
            "float32 grids support up to 2^24 cells (packed walk table); "
            "load with dtype=torch.float64"
        )
    t_dtype = _TORCH_DTYPE[target]

    arrays = {}
    for name, arr in host_arrays.items():
        if arr.dtype.kind == "f" and arr.dtype != target:
            arr = arr.astype(target)
        arrays[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    # v5 sheds device-derivable leaves from the container:
    if "cell_points" not in arrays:
        # points[cells] is a pure gather — casting commutes with
        # indexing, so deriving it here is bit-exact in every dtype
        # path (including the f64 -> f32 downcast load)
        arrays["cell_points"] = arrays["points"][arrays["cells"].long()]
    flat = arrays.pop("cand_flat", None)
    if flat is not None:
        arrays["cand_ids"] = _expand_cand_rows(
            flat, arrays["cand_count"], cand_k
        )

    def names_of(kind):
        return tuple(
            bf.entries[i].metadata for i in bf.indices(f"{kind}_name")
        )

    config = resolve_config(
        config or DEFAULT_CONFIG,
        target,
        host_arrays["rmin"],
        host_arrays["rmax"],
    )
    mark("read_s")
    grid = Grid(
        **arrays,
        cell_type=cell_type,
        bin_shape=bin_shape,
        cand_shape=cand_shape,
        cand_ext_covers=ext_covers,
        cand_nv=cand_nv,
        kd_max_depth=kd_max_depth,
        point_data_names=names_of("point_data"),
        cell_data_names=names_of("cell_data"),
        icell_data_names=names_of("icell_data"),
        locate_mode=locate_mode,
        config=config,
    )
    rebuilt = False
    if grid.cand_ids is not None:
        size = cand_table.sizing(grid)
        # host_arrays still holds the counts and bounds: reading them
        # back off the device would add a blocking round-trip to every
        # load
        rebuilt = cand_table.stale(
            grid, size, dtype_changed=target != saved_dtype,
            max_count=int(host_arrays["cand_count"].max(initial=0)),
            rmin=host_arrays["rmin"].astype(np.float64),
            rmax=host_arrays["rmax"].astype(np.float64),
        )
    if rebuilt:
        if "cell_points" not in host_arrays:  # v5 container
            host_arrays["cell_points"] = host_arrays["points"][
                host_arrays["cells"]
            ]
        grid = cand_table.build_lists(
            grid,
            *(host_arrays[f].astype(np.float64) for f in (
                "cell_points", "face_normals", "face_offsets", "rmin",
                "rmax")),
            size,
        )
        if resave_on_rebuild and target == saved_dtype:
            # Never resave across a dtype change: overwriting a float64
            # master checkpoint with a downcast grid would destroy the
            # higher-precision original.  The lists changed, so the
            # file's fused-variable pin is cleared (build_lists clears
            # it): the next load packs at this session's capacity.
            save_grid(grid, filename)
    mark("rebuild_s")
    if grid.walk_table is None:  # build_grid always carries one
        from ..models.grid import _build_walk_table

        grid = dataclasses.replace(grid, walk_table=_build_walk_table(grid))
    if grid.cand_ids is not None:
        # Honor the checkpointed fused-variable pin (variables added
        # with fuse=False stay unfused across the round-trip); after a
        # candidate-list rebuild the pin is cleared and the pack
        # re-derives capacity nv.
        grid = dataclasses.replace(grid, **cand_table.pack(grid, grid.cand_nv))
    mark("tables_s")
    return grid
