"""Worker process for test_torch_multiprocess.py: one of N
``torch.distributed`` gloo processes driving the port's multi-process
pipeline end to end, two ``cpu`` mesh entries each, with UNEQUAL
contributions.

Scenarios:
  interp       distribute_queries -> sharded_interpolate_at ->
               collect_results; rank p contributes 5 + 4p queries.
  interp_zero  the same, with rank 1 contributing none (the zero filler).
  trace        distribute_queries of circle seeds (3 + 2p on rank p) ->
               sharded_trace -> collect_results of every TraceResult
               field.

Invoked as:
    python tests/_torch_mh_worker.py <port> <world_size> <rank> \
        <outfile> <scenario>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import interpolate_unstructured_tpu_torch as tiu  # noqa: E402
from interpolate_unstructured_tpu_torch.parallel import sharding as ps  # noqa: E402
from interpolate_unstructured_tpu_torch.utils import meshgen  # noqa: E402


def interp_grid():
    """The tet box with linear data, identical in every process."""
    points, cells, neighbors = meshgen.tet_box_mesh(4, 4, 4)
    return tiu.build_grid(
        points, cells, neighbors, "tetra", dtype=torch.float64,
        point_data={"Polynomial": points.sum(axis=1) + 1.0},
        locate_mode="walk", device="cpu")


def interp_queries(rank, scenario):
    b_local = 0 if scenario == "interp_zero" and rank == 1 else 5 + 4 * rank
    return np.random.default_rng(100 + rank).random((b_local, 3))


def trace_grid():
    """2-D triangles with the circular field (-(y - 1), x - 1)."""
    points, cells, neighbors = meshgen.triangle_rect_mesh(4, 4)
    return tiu.build_grid(
        points, cells, neighbors, "triangle", dtype=torch.float64,
        point_data={"vx": -(points[:, 1] - 1.0), "vy": points[:, 0] - 1.0},
        device="cpu")


def trace_seeds(rank):
    """3 + 2 rank seeds on the radius-0.5 circle around (1, 1)."""
    angles = 2 * np.pi * (rank * 97 + np.arange(3 + 2 * rank)) / 31.0
    return np.stack([1.0 + 0.5 * np.cos(angles),
                     1.0 + 0.5 * np.sin(angles)], axis=1)


TRACE_KW = dict(min_dx=1e-5, max_dx=0.05, max_steps=60, rtol=1e-6, atol=1e-8)


def main():
    port, world, rank, outfile, scenario = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
        sys.argv[5])
    torch.set_num_threads(1)
    # the first float32 sqrt of a thread may be off on some hosts
    # (PERF.md §7): run one before any plain version does
    torch.sqrt(torch.rand(1 << 16) + 0.5)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = ps.make_mesh(["cpu", "cpu"])
        if scenario in ("interp", "interp_zero"):
            grid = ps.replicate_grid(interp_grid(), mesh)
            r_local = interp_queries(rank, scenario)
            r_sh, local_b = ps.distribute_queries(r_local, mesh)
            assert local_b == r_local.shape[0]
            vals, ic, found = ps.sharded_interpolate_at(mesh)(grid, r_sh, [0])
            out = {name: ps.collect_results(x, local_b) for name, x in
                   (("vals", vals), ("i_cell", ic), ("found", found))}
            out["r_local"] = r_local
            out["global_rows"] = np.asarray(r_sh.shape[0])
        elif scenario == "trace":
            grid = ps.replicate_grid(trace_grid(), mesh)
            y_local = trace_seeds(rank)
            y_sh, local_b = ps.distribute_queries(y_local, mesh)
            res = ps.sharded_trace(mesh, **TRACE_KW)(grid, y_sh, [0, 1])
            out = {f: ps.collect_results(getattr(res, f), local_b)
                   for f in ("y", "y_field", "n_steps", "boundary_material",
                             "n_iterations")}
            out["n_rounds"] = np.asarray(int(res.n_rounds))
            out["y_local"] = y_local
        else:
            raise SystemExit(f"unknown scenario {scenario!r}")
        np.savez(outfile, **out)
        print(f"rank {rank}: {scenario} collected ok", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
