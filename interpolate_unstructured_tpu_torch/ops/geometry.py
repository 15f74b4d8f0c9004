"""Vectorized mesh geometry preprocessing.

Batch (whole-mesh) vectorizations of the per-cell loops in the reference:

* cell vertex gather        — set_cell_points, m_interp_unstructured.f90:291-302
* outward unit face normals — set_face_normal_vectors, :306-370
* boundary point marking    — :338-339, :361-362
* cell volumes/areas        — set_cell_volumes, :372-410

These run once per grid load, on the host in float64 (numpy), so that
derived geometry is exact regardless of the device compute dtype.  The
face convention is load-bearing and shared with the converter: face ``k``
of a cell consists of vertices ``(k, k+1)`` for tri/quad and
``(k, k+1, k+2)`` cyclic for tets; vertex ``k`` always lies ON face ``k``
(exploited by ray-face distances, :751, and inside tests, :779).

The port's copy of the JAX package's ``ops/geometry.py``: the host
builders stay numpy so that their candidate lists are bit-identical to
the JAX package's, and only the bin helpers (:func:`bin_ijk`,
:func:`bin_flat`, :func:`cand_bin_center_cols`, :func:`cand_local_frame`)
work on torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timing import env_ticker

CELL_TYPES = ("triangle", "quad", "tetra")
N_POINTS_PER_CELL = {"triangle": 3, "quad": 4, "tetra": 4}
# n_faces_per_cell == n_points_per_cell for tri/quad/tet (:865)
NDIM_OF_CELL_TYPE = {"triangle": 2, "quad": 2, "tetra": 3}


def gather_cell_points(points: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """(n_points,3),(n_cells,npc) -> (n_cells,npc,3) per-cell vertex coords."""
    return points[cells]


def face_normals_and_boundary(
    cell_points: np.ndarray, cells: np.ndarray, neighbors: np.ndarray,
    cell_type: str, n_points: int
):
    """Outward unit face normals + boundary point flags.

    Returns:
      normals: (n_cells, nf, 3) outward unit normal of face k
      point_is_at_boundary: (n_points,) bool, True for points on faces
        with no neighbor
    """
    p = cell_points  # (C, npc, 3)
    npc = p.shape[1]
    center = p.mean(axis=1, keepdims=True)  # (C, 1, 3)

    if cell_type in ("triangle", "quad"):
        # Cell-plane normal assuming flat cell (:322-324)
        normal_cell = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 1])  # (C, 3)
        k1 = (np.arange(npc) + 1) % npc
        edge = p[:, k1] - p  # (C, npc, 3)
        normals = np.cross(edge, normal_cell[:, None, :])  # (C, npc, 3)
        face_pts_idx = np.stack([np.arange(npc), k1], axis=1)  # (npc, 2)
    elif cell_type == "tetra":
        k1 = (np.arange(npc) + 1) % npc
        k2 = (np.arange(npc) + 2) % npc
        normals = np.cross(p[:, k1] - p, p[:, k2] - p[:, k1])  # (C, 4, 3)
        face_pts_idx = np.stack([np.arange(npc), k1, k2], axis=1)  # (npc, 3)
    else:
        raise ValueError(f"Unsupported cell type {cell_type!r}")

    # Sign-fix outward: vertex k lies on face k, so (p_k - center) . n > 0
    outward = np.einsum("cki,cki->ck", p - center, normals)
    normals = np.where((outward < 0)[..., None], -normals, normals)
    normals = normals / np.linalg.norm(normals, axis=-1, keepdims=True)

    # Boundary points: vertices of faces with no neighbor
    point_is_at_boundary = np.zeros(n_points, dtype=bool)
    no_neighbor = neighbors < 0  # (C, nf)
    for k in range(npc):
        cells_k = cells[no_neighbor[:, k]]  # cells whose face k is boundary
        if len(cells_k):
            point_is_at_boundary[cells_k[:, face_pts_idx[k]].reshape(-1)] = True

    return normals, point_is_at_boundary


def cell_volumes(cell_points: np.ndarray, cell_type: str) -> np.ndarray:
    """Area (2D) / volume (3D) per cell (:372-410).

    Triangle: 0.5*|e1 x e2|; quad: split into triangles (p1,p2,p3) +
    (p1,p3,p4); tetra: signed triple product / 6 (assumes positive
    orientation, :400-408).
    """
    p = cell_points
    if cell_type == "triangle":
        return 0.5 * np.linalg.norm(
            np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1
        )
    if cell_type == "quad":
        a1 = 0.5 * np.linalg.norm(
            np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1
        )
        a2 = 0.5 * np.linalg.norm(
            np.cross(p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]), axis=-1
        )
        return a1 + a2
    if cell_type == "tetra":
        v12 = p[:, 1] - p[:, 0]
        v13 = p[:, 2] - p[:, 0]
        v14 = p[:, 3] - p[:, 0]
        return np.einsum("ci,ci->c", v12, np.cross(v13, v14)) / 6.0
    raise ValueError(f"Unsupported cell type {cell_type!r}")


def build_bin_seed_table(
    cell_centers: np.ndarray,
    rmin: np.ndarray,
    rmax: np.ndarray,
    ndim: int,
    bins_per_cell: float = 2.0,
    max_bins: int = 1 << 22,
):
    """Uniform-grid cold-start seed table: for every bin of a regular grid
    over the bounding box, the cell whose center is nearest the bin center.

    This replaces the reference's kd-tree cold start
    (find_nearby_cell_kdtree, m_interp_unstructured.f90:272-288) with an
    O(1) lookup: ``seed = table[bin_of(r)]``.  The contract only requires
    a *nearby* cell (README.md:5-6) since the neighbor walk corrects the
    rest.  The nearest centers come from scipy's ``cKDTree`` on all host
    cores.

    Returns (table, bin_shape, bin_rmin, bin_inv_h):
      table: (prod(bin_shape),) int32 seed cell per bin (C-order flat)
      bin_shape: tuple of 3 ints (1 for unused dims)
      bin_rmin: (3,) float64 grid origin
      bin_inv_h: (3,) float64 inverse bin size (0 for unused dims)
    """
    from scipy.spatial import cKDTree

    n_cells = len(cell_centers)
    n_bins_target = min(max(int(bins_per_cell * n_cells), 1), max_bins)
    bin_shape, h, inv_h, active = _bin_grid_shape(
        rmin, rmax, ndim, n_bins_target
    )
    rmin = np.asarray(rmin, dtype=np.float64)

    # Bin centers (flat, C-order)
    axes = [
        (np.arange(bin_shape[d]) + 0.5) * h[d] + rmin[d]
        if active[d]
        else np.array([0.5 * (rmin[d] + rmax[d])])
        for d in range(3)
    ]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    bin_centers = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)

    tree = cKDTree(cell_centers)
    _, seed = tree.query(bin_centers, k=1, workers=-1)
    return (
        seed.astype(np.int32),
        tuple(int(s) for s in bin_shape),
        np.asarray(rmin, dtype=np.float64),
        inv_h,
    )


def cand_bin_center_cols(rmin, inv_h, i, j, k):
    """Candidate-bin center components from integer bin coordinates.

    THE single definition of the bin-local frame origin: the quantized
    candidate packer (models/grid._pack_qcand_rows) and the query side
    (ops/locate) must produce bitwise-identical centers or the stored
    local offsets drift against the query's local coordinates.  The
    arithmetic is the JAX package's, step for step, so both packages
    produce the same f32 centers.  Inactive dims (inv_h == 0) anchor at
    rmin.  ``rmin``/``inv_h`` are (3,) tensors of the grid dtype."""

    def c(idx, d):
        ih = inv_h[d]
        pos = ih > 0
        h = torch.where(
            pos, 1.0 / torch.where(pos, ih, torch.ones_like(ih)),
            torch.zeros_like(ih),
        )
        return rmin[d] + (idx.to(rmin.dtype) + 0.5) * h

    return c(i, 0), c(j, 1), c(k, 2)


def bin_ijk(r, rmin, inv_h, shape, dtype):
    """Clipped integer bin coordinates [(B,) ``dtype``] * 3 of (B, 3)
    queries on a bin grid (origin ``rmin``, inverse sizes ``inv_h``,
    ``shape`` bins per axis): floor((r - rmin) * inv_h) per axis,
    clipped before the integer conversion, as the JAX package computes
    them (``csrc/bins.cuh:bin_coord``).  Seed bins index with int64,
    candidate bins with int32."""
    return [
        torch.clamp(torch.floor((r[:, d] - rmin[d]) * inv_h[d]), 0,
                    shape[d] - 1).to(dtype)
        for d in range(3)
    ]


def bin_flat(ijk, shape):
    """Flat bin index of integer bin coordinates: THE encode ``(i*nby +
    j)*nbz + k`` (inverse: :func:`cand_bin_decode`)."""
    return (ijk[0] * shape[1] + ijk[1]) * shape[2] + ijk[2]


def cand_local_frame(r, rmin, inv_h, ijk):
    """(B, 3) queries in their candidate bin's local frame: r minus the
    bin center of :func:`cand_bin_center_cols`, bitwise-matching the
    packer."""
    cx, cy, cz = cand_bin_center_cols(rmin, inv_h, *ijk)
    return torch.stack([r[:, 0] - cx, r[:, 1] - cy, r[:, 2] - cz], dim=1)


def cand_bin_decode(bin_idx, nby, nbz):
    """Flat candidate-bin index -> (i, j, k) integer coordinates.

    THE single definition of the decode (inverse of
    :func:`bin_flat`, the encode used by the builders and the
    queries): every packer feeding
    :func:`cand_bin_center_cols` must agree on the axis order or the
    quantized rows' local frame drifts against the query side."""
    return bin_idx // (nby * nbz), (bin_idx // nbz) % nby, bin_idx % nbz


def _bin_grid_shape(rmin, rmax, ndim, n_bins_target):
    """Regular bin grid over the bbox: shape, sizes, inverse sizes.

    Bins are distributed across active dims proportionally to extent
    (geometric-mean normalization); unused dims collapse to one bin.
    ``n_bins_target`` is a hard cap: prod(bin_shape) <= n_bins_target,
    so table memory is strictly bounded by the sizing knobs.
    """
    extent = np.asarray(rmax, dtype=np.float64) - np.asarray(rmin, np.float64)
    active = np.zeros(3, dtype=bool)
    active[:ndim] = extent[:ndim] > 0
    n_active = int(active.sum())
    bin_shape = np.ones(3, dtype=np.int64)
    if n_active > 0:
        geo_mean = np.exp(np.log(extent[active]).mean())
        per_unit = (n_bins_target ** (1.0 / n_active)) / geo_mean
        bin_shape[active] = np.maximum(
            1, np.round(extent[active] * per_unit).astype(np.int64)
        )
        # Per-dim rounding can overshoot the product by ~1.5x/dim; keep
        # the knob a hard cap. floor(s*scale) per dim brings the product
        # under target; the decrement loop mops up +1s from the >=1 clamp.
        prod = int(bin_shape.prod())
        if prod > n_bins_target:
            scale = (n_bins_target / prod) ** (1.0 / n_active)
            bin_shape[active] = np.maximum(
                1, np.floor(bin_shape[active] * scale).astype(np.int64)
            )
        while int(bin_shape.prod()) > n_bins_target:
            d = int(np.argmax(bin_shape))
            if bin_shape[d] <= 1:
                break
            bin_shape[d] -= 1
    h = np.where(active, extent / bin_shape, 1.0)
    inv_h = np.where(active, 1.0 / h, 0.0)
    return bin_shape, h, inv_h, active


def build_candidate_bins(
    cell_points: np.ndarray,
    face_normals: np.ndarray,
    face_offsets: np.ndarray,
    rmin: np.ndarray,
    rmax: np.ndarray,
    ndim: int,
    k_max: int,
    bins_per_cell: float = 1.0,
    max_bins: int = 1 << 21,
    eps: float = 0.0,
    pair_chunk: int = 1 << 23,
    ext_max_k: int = 0,
    cover_ok=None,
):
    """Per-bin candidate-cell lists: which cells intersect each bin of a
    regular grid over the bounding box.

    This is the build side of the one-gather cold locate: at query time
    the bin of ``r`` is inspected and containment is tested against the
    bin's (at most ``k_max``) candidate cells directly, so most cold
    queries resolve with ZERO walk steps — the replacement for the
    reference's kd-tree-seed-then-walk cold path (README.md:3-6,
    m_interp_unstructured.f90:272-288 + :664-725).

    Candidate lists are *complete* unless a bin intersects more than
    ``k_max`` cells: where ``count <= k_max``, "no candidate contains r"
    is an exact not-found; overflowing bins keep the ``k_max`` cells
    whose bin-center margin is largest (best bin coverage) and defer
    unresolved queries to a neighbor walk seeded at the best candidate.

    Cell-bin intersection is AABB overlap refined by the cell's face
    planes (exact for axis-separations and face-separations; the few
    edge-axis-only separations of the SAT are kept conservatively —
    extra candidates cost list slots, never correctness).  All tests are
    inflated by ``eps`` so the query-time inside tolerance can never
    admit a point into a cell that was filtered out of its bin.

    Overflow bins additionally get an EXTENSION list holding their
    candidates ranked ``k_max..k_max+k_ext`` (k_ext sized to the worst
    bin, capped by ``ext_max_k``), so the query side can resolve even
    overflow-bin misses with one more row gather instead of a neighbor
    walk — and "no candidate anywhere" stays an exact not-found
    wherever ``count <= k_max + k_ext``.

    Returns:
      cand_ids:  (n_bins, k_max) int32, -1 padded
      cand_count: (n_bins,) int32 — the EXACT intersection count
        (may exceed k_max; that flags overflow bins)
      bin_shape, bin_rmin, bin_inv_h: grid params (as the seed table)
      ext_ids: (n_overflow_bins, k_ext) int32, -1 padded (k_ext may be
        0 -> shape (0, 0))
      ext_slot: (n_bins,) int32 — overflow bins' row in ext_ids, -1
        elsewhere
    """
    _tick = env_ticker("IU_BUILD_PROFILE", "cand-build")
    n_cells = len(cell_points)
    rmin = np.asarray(rmin, dtype=np.float64)
    n_target = min(max(int(bins_per_cell * n_cells), 1), max_bins)
    bin_shape, h, inv_h, active = _bin_grid_shape(rmin, rmax, ndim, n_target)
    nbx, nby, nbz = (int(s) for s in bin_shape)
    n_bins = nbx * nby * nbz

    # Cell AABBs -> bin index ranges, inflated by eps (+1 ulp guard)
    pad = eps + 1e-300
    lo = cell_points.min(axis=1) - pad
    hi = cell_points.max(axis=1) + pad
    b0 = np.clip(
        np.floor((lo - rmin) * inv_h).astype(np.int64), 0, bin_shape - 1
    )
    b1 = np.clip(
        np.floor((hi - rmin) * inv_h).astype(np.int64), 0, bin_shape - 1
    )
    cnt = b1 - b0 + 1  # (C, 3)
    n_pairs_per_cell = cnt.prod(axis=1)
    pair_end = np.cumsum(n_pairs_per_cell)
    total_pairs = int(pair_end[-1]) if n_cells else 0
    pair_start = pair_end - n_pairs_per_cell

    half = np.where(active, 0.5 * h, 0.0)  # bin half-extent per dim
    # planar-mesh probe plane: loop-invariant, hoisted out of the loop
    zmean = float(cell_points[:, :, 2].mean()) if n_cells else 0.0

    out_bin, out_cell, out_score = [], [], []
    # Chunk over cells so pair arrays stay bounded (~pair_chunk rows)
    c_lo = 0
    while c_lo < n_cells:
        c_hi = int(
            np.searchsorted(pair_end, pair_end[c_lo] - 1 + pair_chunk, "right")
        )
        c_hi = max(c_hi, c_lo + 1)
        sl = slice(c_lo, c_hi)
        base = pair_start[c_lo]
        p = int(pair_end[c_hi - 1] - base)
        pc = np.repeat(
            np.arange(c_lo, c_hi, dtype=np.int64),
            n_pairs_per_cell[sl],
        )
        rank = np.arange(p, dtype=np.int64) - (pair_start[pc] - base)
        cz = cnt[pc, 2]
        iz = rank % cz
        t = rank // cz
        cy = cnt[pc, 1]
        iy = t % cy
        ix = t // cy
        bx = b0[pc, 0] + ix
        by = b0[pc, 1] + iy
        bz = b0[pc, 2] + iz
        pbin = (bx * nby + by) * nbz + bz

        # Bin centers of each pair (preallocated, not np.stack'ed)
        cb = np.empty((p, 3), np.float64)
        cb[:, 0] = rmin[0] + (bx + 0.5) * (h[0] * active[0])
        cb[:, 1] = rmin[1] + (by + 0.5) * (h[1] * active[1])
        cb[:, 2] = rmin[2] + (bz + 0.5) * (h[2] * active[2])
        if not active[2] and ndim == 2:
            # planar meshes: probe in the mesh plane
            cb[:, 2] = zmean

        nrm = face_normals[pc]  # (P, nf, 3)
        off = face_offsets[pc]  # (P, nf)
        # multiply-reduce: numpy's c_einsum runs ~3x slower here
        proj = (nrm * cb[:, None, :]).sum(-1)  # n . bin_center
        reach = np.abs(nrm) @ half  # (P, nf) max |n . (x - cb)| over bin
        # Face-plane separation: whole bin strictly outside face k
        separated = (proj - reach > off + eps).any(axis=1)
        keep = ~separated
        out_bin.append(pbin[keep].astype(np.int64))
        out_cell.append(pc[keep].astype(np.int32))
        # Rank candidates by bin-center interiority (covers-most first)
        out_score.append(
            (off - proj).min(axis=1)[keep].astype(np.float32)
        )
        _tick(f"chunk {c_lo}-{c_hi}")
        c_lo = c_hi

    if total_pairs:
        pbin = np.concatenate(out_bin)
        pcell = np.concatenate(out_cell)
        score = np.concatenate(out_score)
    else:
        pbin = np.zeros(0, np.int64)
        pcell = np.zeros(0, np.int32)
        score = np.zeros(0, np.float32)

    _tick("concat")
    order = np.lexsort((-score, pbin))
    _tick("lexsort")
    pbin = pbin[order]
    pcell = pcell[order]

    cand_count = np.zeros(n_bins, dtype=np.int32)
    np.add.at(cand_count, pbin, 1)
    # rank within bin = position - first position of that bin
    first = np.zeros(n_bins + 1, dtype=np.int64)
    first[1:] = np.cumsum(cand_count)
    rank_in_bin = np.arange(len(pbin), dtype=np.int64) - first[pbin]
    max_count = int(cand_count.max()) if n_bins else 0
    if cover_ok is not None and cover_ok(max_count):
        # Cover-all rows: widen K to the worst bin so every bin's list
        # is complete — no extension table, no query-side fallback
        k_max = max_count
    keep = rank_in_bin < k_max

    _tick("rank")
    cand_ids = np.full((n_bins, k_max), -1, dtype=np.int32)
    cand_ids[pbin[keep], rank_in_bin[keep]] = pcell[keep]
    _tick("fill main")

    over = np.where(cand_count > k_max)[0]
    k_ext = 0
    if len(over) and ext_max_k > 0:
        k_ext = min(int(cand_count.max()) - k_max, ext_max_k)
    ext_slot = np.full(n_bins, -1, dtype=np.int32)
    ext_slot[over] = np.arange(len(over), dtype=np.int32)
    ext_ids = np.full((len(over) if k_ext else 0, k_ext), -1, np.int32)
    if k_ext:
        keep2 = (rank_in_bin >= k_max) & (rank_in_bin < k_max + k_ext)
        ext_ids[
            ext_slot[pbin[keep2]], rank_in_bin[keep2] - k_max
        ] = pcell[keep2]
    _tick("ext")
    return (
        cand_ids,
        cand_count,
        (nbx, nby, nbz),
        rmin,
        inv_h,
        ext_ids,
        ext_slot,
    )
