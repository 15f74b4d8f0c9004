"""Field-line tracing with the PyTorch port: the reference's
test_trace_field.f90 scenario, as ``examples/02_trace_field_lines.py``.

A spiral field (vx, vy) = (-y + a*x, x + a*y) is attached to a
triangulated square; field lines spiral outward from the origin until
they leave the domain (boundary code -1).  A batch of seeds is traced
with the adaptive RK23 integrator, carrying one extra ODE variable (arc
length, d(length)/ds = 1) through the user callback, the
`integrate_sub_t` interface of the reference
(m_interp_unstructured.f90:61-74).  The grid and the lines are written
as .vtu files in the current directory.

    python examples/torch_port/02_trace_field_lines.py [--device cpu]
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


def square_triangulation(lo, hi, n):
    xs = np.linspace(lo, hi, n + 1)
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
                   help="torch device of the grid and seeds (default cuda)")
    device = torch.device(p.parse_args(argv).device)
    points, cells = square_triangulation(-2.0, 2.0, 48)
    neighbors = get_cell_neighbors(cells, points, n_points_face=2)
    grid = tiu.build_grid(
        points,
        cells,
        neighbors,
        "triangle",
        point_data={
            "vx": -points[:, 1] + 0.1 * points[:, 0],
            "vy": points[:, 0] + 0.1 * points[:, 1],
        },
        dtype=torch.float32,
        device=device,
    )
    i_field = [
        tiu.get_point_data_index(grid, "vx"),
        tiu.get_point_data_index(grid, "vy"),
    ]

    # Seeds along the +x axis; third state entry = arc length, start 0.
    radii = np.linspace(0.5, 1.8, 8)
    y0 = torch.from_numpy(np.column_stack([radii, 0 * radii, 0 * radii]))

    result = tiu.integrate_along_field(
        grid,
        y0,
        i_field,
        nvar=1,
        sub_int=lambda field, y: torch.ones_like(y[:1]),  # d(length)/ds = 1
        min_dx=1e-5,
        max_dx=0.1,
        max_steps=2000,
        rtol=1e-4,
        atol=1e-4,
    )

    # Inner seeds spiral for many turns before exiting; every line ends
    # at the domain boundary (code -1).
    for k, R in enumerate(radii):
        n = int(result.n_steps[k])
        x, y, length = (float(v) for v in result.y[k, n - 1])
        turns = length / (2 * np.pi * R)
        r_end = float(np.hypot(x, y))
        print(
            f"R0={R:5.2f}: {n:4d} accepted steps, arc length {length:7.3f} "
            f"(~{turns:5.2f} turns of the start circle), "
            f"|r_end|={r_end:5.3f}, "
            f"boundary_code={int(result.boundary_material[k])}"
        )
    if not bool((result.boundary_material == -1).all()):
        raise SystemExit("a line did not end at the domain boundary")

    # Export the grid (with the field) and the traced polylines for
    # side-by-side visualization.
    tiu.write_vtk(grid, "trace_example_grid.vtu")
    tiu.write_trace_vtk(result, "trace_example_lines.vtu")
    print("wrote trace_example_grid.vtu + trace_example_lines.vtu")


if __name__ == "__main__":
    main()
