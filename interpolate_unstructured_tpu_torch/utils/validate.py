"""Grid validation — the debug-mode analogue of the reference's
``DEBUG=1`` / ``-fcheck=all`` runtime checks.

``validate_grid`` checks structural and geometric invariants on the
host and raises with a readable report: the JAX package's checks, on
the port's ``Grid``, whose tensors are copied to the host first.
Intended for use after custom grid construction or suspicious results,
not in hot paths.
"""

from __future__ import annotations

import numpy as np

from ..models.grid import host_array as _host


def validate_grid(grid, strict: bool = True):
    """Check UGrid invariants; returns a list of problem strings (empty
    when healthy). Raises ValueError when ``strict`` and problems exist."""
    problems = []
    n_cells = grid.n_cells
    n_points = grid.n_points
    npc = grid.n_points_per_cell

    cells = _host(grid.cells)
    neighbors = _host(grid.neighbors)
    points = _host(grid.points)
    normals = _host(grid.face_normals)
    volume = _host(grid.cell_volume)

    cells_ok = not (
        cells.min(initial=0) < 0 or cells.max(initial=-1) >= n_points
    )
    if not cells_ok:
        problems.append("connectivity indices out of range")
    neighbors_ok = neighbors.max(initial=-1) < n_cells
    if not neighbors_ok:
        problems.append("neighbor indices out of range")

    # Adjacency symmetry: if neighbors[c,k] == d, some face of d -> c
    # (only checkable once the indices themselves are in range — the
    # very grids this validator exists to report must not crash it)
    if neighbors_ok:
        valid = neighbors >= 0
        c_ids = np.repeat(np.arange(n_cells), npc)[valid.reshape(-1)]
        d_ids = neighbors.reshape(-1)[valid.reshape(-1)]
        back = (neighbors[d_ids] == c_ids[:, None]).any(axis=1)
        if not back.all():
            problems.append(
                f"{(~back).sum()} asymmetric neighbor links"
            )

    # Unit outward normals
    norm_err = np.abs(np.linalg.norm(normals, axis=-1) - 1.0).max()
    if norm_err > 1e-6:
        problems.append(f"non-unit face normals (max err {norm_err:.2e})")
    cp = _host(grid.cell_points)
    centers = cp.mean(axis=1, keepdims=True)
    outward = np.einsum("cki,cki->ck", cp - centers, normals)
    if (outward <= 0).any():
        problems.append(
            f"{(outward <= 0).sum()} inward-pointing face normals"
        )

    # Volumes: positive (tets must be positively oriented, :400-408)
    if (volume <= 0).any():
        problems.append(f"{(volume <= 0).sum()} non-positive cell volumes")

    # Geometry consistency: cell_points matches points[cells]
    if cells_ok and not np.allclose(cp, points[cells], atol=0):
        problems.append("cell_points inconsistent with points[cells]")

    # Seed tables
    bt = _host(grid.bin_table)
    if bt.min(initial=0) < 0 or bt.max(initial=-1) >= n_cells:
        problems.append("bin seed table references invalid cells")

    # Registry consistency
    for fam, names in [
        ("point_data", grid.point_data_names),
        ("cell_data", grid.cell_data_names),
        ("icell_data", grid.icell_data_names),
    ]:
        width = getattr(grid, fam).shape[1]
        if len(names) > width:
            problems.append(
                f"{fam}: {len(names)} names but storage width {width}"
            )

    if problems and strict:
        raise ValueError(
            "Grid validation failed:\n  - " + "\n  - ".join(problems)
        )
    return problems
