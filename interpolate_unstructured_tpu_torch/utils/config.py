"""Framework configuration and numeric constants.

The reference configures behavior via per-call arguments and compile-time
flags (SURVEY.md §5.6); here the knobs live in one dataclass that can be
passed to ``build_grid``.  This is the port's copy of the JAX package's
``utils/config.py`` (numpy only), so that grids built by both packages
resolve the same tolerances.  ``dtype`` arguments are numpy dtypes
(``models.grid`` converts), except :func:`walk_tolerances`, which also
takes torch dtypes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .timing import host_read


@dataclasses.dataclass(frozen=True)
class IUConfig:
    """Tunables for grid construction and point location.

    The same fields and defaults as the JAX package's ``IUConfig``, so a
    config converts between the packages with ``dataclasses.asdict``.
    Fields of slices the port does not have yet (tracer, the compacted
    fallback) are carried and not read.
    """

    # Inside-test tolerance: point is inside a cell iff
    # (r_face - r) . n >= -eps_inside for all faces
    # (m_interp_unstructured.f90:773, small_number = 1e-10); scaled to the
    # dtype and domain by resolve_config
    eps_inside: float = 1e-10

    # Meshes up to this many cells locate by brute force (containment
    # against every cell); larger meshes use the per-bin candidate rows
    bruteforce_max_cells: int = 1024

    # Step caps of the neighbor walk and of the tracer's short walks
    # (tracer slice)
    max_walk_steps: int = 1024
    trace_walk_max_steps: int = 128

    # Fused tracer rounds: lane tile width and straggler compaction
    # (tracer slice)
    trace_tile: int = 1024
    trace_compact_divisor: int = 8
    trace_compact_min_batch: int = 16384

    # Cold-start seed backend of walks: "bins" (uniform-grid seed table)
    # or "kdtree" (exact nearest cell center, m_interp_unstructured.f90:
    # 272-288); and the seed table's sizing: bins ~= bins_per_cell *
    # n_cells, capped by max_bins
    seed_mode: str = "bins"
    bins_per_cell: float = 4.0
    max_bins: int = 1 << 23

    # Per-bin candidate tables (walk-mode grids): each bin of a regular
    # grid stores the cells that intersect it, packed with their face
    # planes (and fused values) into one wide row, so a cold query
    # resolves containment and interpolation from a single row.
    use_candidate_bins: bool = True
    # bins ~= cand_bins_per_cell * n_cells, capped by cand_max_bins
    cand_bins_per_cell: float = 2.0
    cand_max_bins: int = 1 << 22
    # Row budget that sets K, the candidates per row
    cand_row_bytes: int = 1024
    # Quantized rows (f32 tri/tet grids): probe geometry as int16 —
    # unit face normals at a fixed 1/32767 scale and face offsets in the
    # query bin's local frame at a per-row scale — with interpolation
    # from exact f32 per-cell value planes (value = g . r_local + c).
    # The quantization fuzz (~h/2e4, grid.cand_qeps) widens the inside
    # tolerance, so interior points are never lost to it.
    cand_quantized: bool = True
    # Overflow bins store their candidates ranked K..K+k_ext in an
    # extension table probed by the same kernel; a bin needs a walk only
    # when it exceeds K + cand_ext_max_k candidates.
    cand_ext_max_k: int = 32
    # Fusing a point-data variable into the rows costs candidate slots;
    # stop fusing before K drops below this floor.
    cand_min_k: int = 7
    # Cover-all rows: when the worst bin's complete list fits a row of
    # at most this many bytes, K widens to that count and every miss is
    # exact (no extension table).  0 disables.
    cand_cover_row_bytes: int = 2048
    # Candidate-bin construction backend: "auto", "host" or "device".
    # "auto" takes the device pipeline (ops/cand_build.py) from
    # cand_build_device_min_cells cells, the host builder below, or
    # where the device pipeline declines a strongly graded mesh.
    cand_build: str = "auto"
    cand_build_device_min_cells: int = 100_000
    # Compacted fallback buffer size of the JAX package's query path
    cand_fallback_divisor: int = 32
    # Plain (CPU) candidate probe: rows are gathered chunk by chunk so
    # the gathered block stays near cand_chunk_bytes; the per-chunk query
    # count is derived from the row width unless cand_chunk_queries
    # sets it.
    cand_chunk_bytes: int = 64 << 20
    cand_chunk_queries: int | None = None

    # Two-phase walk: walk_phase1_steps steps on the full batch, then
    # the stragglers resume from where they stopped, once the batch has
    # at least walk_compact_min_batch queries (walk_compact_divisor is
    # the JAX package's compaction buffer size, not read here)
    walk_phase1_steps: int = 2
    walk_compact_divisor: int = 8
    walk_compact_min_batch: int = 1 << 16

    # The JAX package's switch for its Pallas brute-force kernel; the
    # port picks kernel or plain version by the tensors' device instead
    use_pallas: bool = True

    # Relocate every seed-bin center after the build and reseed with the
    # containing cell (walk grids without candidate tables)
    refine_bin_seeds: bool = True


DEFAULT_CONFIG = IUConfig()


def resolve_config(config: IUConfig, dtype, rmin, rmax) -> IUConfig:
    """Scale ``eps_inside`` to the compute dtype and domain extent.

    The reference's fixed 1e-10 assumes float64 with O(1) coordinates;
    for float32 grids it sits below margin rounding noise, so near-face
    queries would be misreported as not-found.  The resolved tolerance
    is ``max(eps_inside, 32 * eps(dtype) * max|coord|)`` — a no-op in
    float64 on O(1) domains (3e-14 < 1e-10), a few-ulp band in float32.
    """
    extent = float(
        max(np.max(np.abs(np.asarray(rmin))), np.max(np.abs(np.asarray(rmax))))
    )
    eps = max(
        config.eps_inside, 32.0 * float(np.finfo(dtype).eps) * max(extent, 1.0)
    )
    if eps != config.eps_inside:
        config = dataclasses.replace(config, eps_inside=eps)
    return config


def tiny_distance(dtype) -> float:
    """Degenerate-walk short-circuit threshold (reference: 1e-100, :20).

    Scaled to the compute dtype: 1e-100 underflows float32, so use a value
    safely below any meaningful float32 distance instead.
    """
    if np.dtype(dtype) == np.float32:
        return 1e-30
    return 1e-100


def huge_distance(dtype) -> float:
    """Sentinel 'no face hit' distance (reference: 1e100, :738)."""
    if np.dtype(dtype) == np.float32:
        return 1e30
    return 1e100


def walk_tolerances(dtype, rmin, rmax):
    """(nudge, eps_arrive) shared by every walk consumer.

    ``nudge``: forward overshoot past a crossed face — under batched f32
    rounding the post-hop position can land on the wrong side of the
    face it just crossed, producing zero-length A<->B hop cycles.  A
    few-ulp overshoot guarantees progress and is far below the
    inside-test tolerance.

    ``eps_arrive``: arrival band absorbing the walk's own rounding so a
    target exactly ON a face cannot coin-flip between "arrived" and
    "crossed".  Deliberately a few-ulp band like ``nudge``, not
    eps_inside (the unsigned-area weights lose linearity outside their
    cell, m_interp_unstructured.f90:542-549).

    ``16 * eps(dtype) * max|coord|`` and 4x that, the JAX package's
    values bit for bit: the factors are powers of two, so the products
    are exact in the grid dtype.  ``dtype`` is a numpy or torch float
    dtype; ``rmin``/``rmax`` are arrays or tensors.  Returns Python
    floats, each exactly representable in ``dtype``.  Tensors on the
    card are read back: a host read (``utils/timing.host_read``).
    """
    np_dtype = np.dtype(str(dtype).replace("torch.", ""))

    def absmax(a):
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        return float(np.max(np.abs(np.asarray(a, np.float64))))

    with host_read("walk_tolerances", rmin, rmax):
        extent = np_dtype.type(max(absmax(rmin), absmax(rmax)))
    nudge = float(np_dtype.type(16.0 * float(np.finfo(np_dtype).eps)) * extent)
    return nudge, 4.0 * nudge

