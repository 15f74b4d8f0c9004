"""Basic usage of the PyTorch port: build a grid, interpolate point data
at query points.

The flow of ``examples/01_interpolate.py`` (the reference's
test_triangle.f90: load mesh -> cold interpolation -> warm re-query) on
``interpolate_unstructured_tpu_torch``, with an in-memory mesh.  Runs on
the CUDA device; ``--device cpu`` runs the kernels' plain versions on
the host:

    python examples/torch_port/01_interpolate.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import interpolate_unstructured_tpu_torch as tiu  # noqa: E402
from interpolate_unstructured_tpu_torch.io.convert import (  # noqa: E402
    get_cell_neighbors,
)


def unit_square_triangulation(n: int):
    """Structured (n x n) triangulation of the unit square."""
    xs = np.linspace(0.0, 1.0, n + 1)
    px, py = np.meshgrid(xs, xs, indexing="ij")
    points = np.column_stack([px.ravel(), py.ravel(), np.zeros(px.size)])
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = (i * (n + 1) + j).ravel()
    v10, v01 = v00 + (n + 1), v00 + 1
    v11 = v10 + 1
    cells = np.concatenate(
        [np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)]
    )
    return points, cells


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device of the grid and queries (default cuda)")
    device = torch.device(p.parse_args(argv).device)
    points, cells = unit_square_triangulation(32)
    neighbors = get_cell_neighbors(cells, points, n_points_face=2)
    grid = tiu.build_grid(
        points,
        cells,
        neighbors,
        "triangle",
        # any linear function is reproduced exactly by the kernels
        point_data={"Polynomial": points[:, 0] + points[:, 1] + 1.0},
        dtype=torch.float32,
        device=device,
    )
    i_var = tiu.get_point_data_index(grid, "Polynomial")

    rng = np.random.default_rng(0)
    r = torch.from_numpy(
        rng.uniform(0.05, 0.95, size=(100_000, 3)) * [1, 1, 0]
    ).float().to(device)

    # Cold pass: no cell guesses (benchmark.f90:44-51 protocol)
    values, i_cell, found = tiu.interpolate_scalar_at(grid, r, i_var)
    exact = r[:, 0] + r[:, 1] + 1.0
    print(
        f"cold: {int(found.sum())}/{len(r)} found, "
        f"max |err| = {float((values - exact).abs().max()):.3e}"
    )

    # Warm pass: advect the points slightly and reuse the found cells as
    # guesses (benchmark.f90:57-65 protocol)
    r2 = r + torch.tensor([0.003, -0.002, 0.0], device=device)
    values2, _, found2 = tiu.interpolate_scalar_at(grid, r2, i_var,
                                                   guess=i_cell)
    exact2 = r2[:, 0] + r2[:, 1] + 1.0
    print(
        f"warm: {int(found2.sum())}/{len(r2)} found, "
        f"max |err| = {float((values2 - exact2).abs().max()):.3e}"
    )

    # Queries outside the domain report found=False (the reference's
    # silent miss, made explicit) and take fill_value.
    outside = torch.tensor([[2.0, 2.0, 0.0]], device=device)
    v, _, f = tiu.interpolate_scalar_at(grid, outside, i_var, fill_value=-1.0)
    print(f"outside query: found={bool(f[0])}, value={float(v[0])}")
    if not (bool(found.all()) and bool(found2.all()) and not bool(f[0])):
        raise SystemExit("a query inside the mesh was lost or one outside found")


if __name__ == "__main__":
    main()
