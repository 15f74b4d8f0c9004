"""Accurate mode with the PyTorch port: float64-grade interpolation from
a float32 grid, as ``examples/04_accurate_mode.py``.

Each value is stored as an exact (hi, lo) float32 pair and the kernels
run error-free-transform (df32) arithmetic, recovering ~1e-12 accuracy
from float32 storage.  The grid's coordinates and data genuinely need
the residuals (scaled by pi, random O(1) data); plain float32, accurate
mode and the exact values are compared.

    python examples/torch_port/04_accurate_mode.py [--device cpu]
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device of the grid and queries (default cuda)")
    device = torch.device(p.parse_args(argv).device)
    rng = np.random.default_rng(0)
    n = 24
    xs = np.linspace(0.0, np.pi, n + 1)
    px, py = np.meshgrid(xs, xs, indexing="ij")
    points = np.column_stack([px.ravel(), py.ravel(), np.zeros(px.size)])
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = (i * (n + 1) + j).ravel()
    v10, v01 = v00 + (n + 1), v00 + 1
    v11 = v10 + 1
    cells = np.concatenate(
        [np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)]
    )
    neighbors = get_cell_neighbors(cells, points, n_points_face=2)

    # float64 data with O(1) inter-vertex jumps: the f32 representation
    # alone loses ~1e-7
    data = rng.standard_normal(len(points))
    grid = tiu.build_grid(
        points, cells, neighbors, "triangle",
        point_data={"rough": data}, dtype=torch.float32, device=device,
    )
    grid = tiu.prepare_accurate(grid)

    r64 = rng.uniform(0.1, np.pi - 0.1, size=(10_000, 3)) * [1, 1, 0]
    r = torch.from_numpy(r64).to(device)

    # Plain f32 path
    v32, ic, found = tiu.interpolate_scalar_at(grid, r.float(), 0)
    if not bool(found.all()):
        raise SystemExit("a query inside the mesh was lost")

    # Accurate path: float64 queries, split into (hi, lo) float32 pairs
    vh, vl, found_a, ic_a = tiu.interpolate_at_acc(grid, r, (0,))
    v_acc = vh.double().cpu().numpy() + vl.double().cpu().numpy()

    # Exact reference: f64 barycentric interpolation on the same cells
    exact = _exact_interp(points, cells, data, r64, ic_a.cpu().numpy())

    err32 = np.abs(v32.double().cpu().numpy() - exact).max()
    err_acc = np.abs(v_acc[:, 0] - exact).max()
    print(f"plain float32 max |err| : {err32:.3e}")
    print(f"accurate mode max |err| : {err_acc:.3e}")
    print(f"improvement             : {err32 / err_acc:.0f}x")
    if not (bool(found_a.all()) and err_acc <= 1e-10):
        raise SystemExit("accurate mode missed its 1e-10 gate")


def _exact_interp(points, cells, data, r, ic):
    p = points[cells[ic]]  # (B, 3, 3)
    a = p[:, 1] - p[:, 0]
    b = p[:, 2] - p[:, 0]
    q = r - p[:, 0]
    det = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    w1 = (q[:, 0] * b[:, 1] - q[:, 1] * b[:, 0]) / det
    w2 = (a[:, 0] * q[:, 1] - a[:, 1] * q[:, 0]) / det
    w0 = 1.0 - w1 - w2
    d = data[cells[ic]]
    return w0 * d[:, 0] + w1 * d[:, 1] + w2 * d[:, 2]


if __name__ == "__main__":
    main()
