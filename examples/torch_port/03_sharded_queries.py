"""Multi-device query sharding with the PyTorch port: grid replicated,
query batch split across devices, as ``examples/03_sharded_queries.py``.

The grid is copied to every device of the mesh and the query batch is
split into one shard per mesh entry; each shard is interpolated on its
own device, with no communication in the hot loop.  On the card the mesh
is every visible CUDA device; ``--device cpu`` splits the batch over 8
CPU entries, as the JAX example's 8 virtual devices.  Across processes,
``distribute_queries`` and ``collect_results`` do the same over
``torch.distributed`` (see the package's ``parallel/sharding.py``).

    python examples/torch_port/03_sharded_queries.py [--device cpu]
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
from interpolate_unstructured_tpu_torch.parallel import (  # noqa: E402
    sharding as ps,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda: a mesh of every visible card (the default); "
                   "another device: a mesh of 8 entries of it")
    device = torch.device(p.parse_args(argv).device)
    mesh = ps.make_mesh() if device.type == "cuda" else ps.make_mesh(
        [device] * 8)
    print(f"mesh: {[str(d) for d in mesh]}")

    # Same structured triangulation as example 01
    n = 32
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
    neighbors = get_cell_neighbors(cells, points, n_points_face=2)
    grid = tiu.build_grid(
        points, cells, neighbors, "triangle",
        point_data={"Polynomial": points[:, 0] + points[:, 1] + 1.0},
        dtype=torch.float32, device=mesh[0],
    )
    i_var = tiu.get_point_data_index(grid, "Polynomial")
    grid_r = ps.replicate_grid(grid, mesh)

    rng = np.random.default_rng(1)
    r = torch.from_numpy(
        rng.uniform(0.05, 0.95, size=(1_000_003, 3)) * [1, 1, 0]).float()
    r_sharded, b = ps.shard_batch(r, mesh)  # pads to a device multiple

    interp = ps.sharded_interpolate_at(mesh)
    values, i_cell, found = interp(grid_r, r_sharded, [i_var])
    values = ps.collect_results(values, b)  # host arrays, padding trimmed
    found = ps.collect_results(found, b)

    exact = (r[:, 0] + r[:, 1] + 1.0).numpy()
    err = float(np.abs(values[:, 0] - exact).max())
    print(
        f"{b} queries over {len(mesh)} shards: "
        f"{int(found.sum())} found, max |err| = {err:.3e}"
    )
    if not found.all():
        raise SystemExit("a query inside the mesh was lost")


if __name__ == "__main__":
    main()
