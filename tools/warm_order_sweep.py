#!/usr/bin/env python3
"""Sweep of the bin order of a walk grid's large batches
(``ops/order_kernel.py``) on one GPU: where it pays, and how coarse its
key grid should be.

    python3 tools/warm_order_sweep.py

Builds the 998,250-tet box (``tet_box_mesh(55, 55, 55)``) as a walk grid
without candidate tables (``use_candidate_bins=False``, the
``tet998k_f64_walk`` configuration of the benchmark) in float32 and
float64, with three point-data columns.  Queries are particle steps as
the benchmark's particles traffic takes them: starts uniform in the
middle 80% of the grid's box (``default_rng(7)``; z = 0 on a 2D mesh),
velocities in [0, 1)^3 of its span, the queries 0.01 * v further on, and
the cells of the starts as guesses.  Then, for B / n_cells in RATIOS,
with the guesses and without (a cold walk from the seed bins), timed
with CUDA events in turns (each design in order, then in reverse):

1. ``get_cell`` then ``interpolate_at_icell`` on the batch as given (the
   unordered route) against the route in bin order
   (``interp._in_bin_order``) at each key coarsening that KEY_RUNS gives
   (``order_kernel.KEY_RUN``), each first checked torch.equal to the
   unordered route -- the measurement behind
   ``order_kernel.MIN_PER_CELL`` and ``KEY_RUN``;
2. the same at the rule's coarsening, warm and cold, in float32 and
   float64, on the smaller tet boxes of SMALL and on the triangle and
   quad rectangles of PLANAR, at SMALL_RATIOS queries a cell -- the
   measurement behind ``order_kernel.MIN_L2_TIMES`` and
   ``MIN_BATCH_L2_TIMES``, and behind leaving planar grids unordered;
3. at B / n_cells = 10 with guesses (the benchmark's particles cell),
   each stage alone at the rule's coarsening: the key pass, the key pass
   with the scan and scatter, B3 and E1 on the ordered and on the
   unordered batch, the unsort, and the plain versions of the order and
   the unsort.

Prints the card (nvidia-smi name and power limit) first; exits non-zero
without a CUDA device or when a check fails.
"""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

RATIOS = (0.25, 0.5, 1, 2, 3, 4, 10)  # queries a cell of the 998k box
# order_kernel.KEY_RUN values: on the 998k box 1000, 125 and 27 key bins
KEY_RUNS = (2, 16, 64)
# sides of the smaller tet boxes: 279,936 to 750,000 tets
SMALL = (36, 41, 46, 50)
# (cell type, nx, ny) of the planar meshes: 600,608 and 999,698
# triangles, 600,625 and 1,000,000 quads
PLANAR = (("triangle", 548, 548), ("triangle", 707, 707),
          ("quad", 775, 775), ("quad", 1000, 1000))
SMALL_RATIOS = (2, 3, 4, 10)  # queries a cell there
REPS = 10
SLOTS = (0, 1, 2)


@contextlib.contextmanager
def _key_run(order_kernel, run):
    """``order_kernel.KEY_RUN`` set to ``run`` inside the block."""
    old = order_kernel.KEY_RUN
    order_kernel.KEY_RUN = run
    try:
        yield
    finally:
        order_kernel.KEY_RUN = old


def _particles(grid, b, dev, dtype):
    """(queries, starts) of b particle steps, as the particles traffic
    takes them, in the middle of the grid's box."""
    rng = np.random.default_rng(7)
    lo = grid.rmin.cpu().double().numpy()
    span = grid.rmax.cpu().double().numpy() - lo
    r0 = lo + (0.1 + 0.8 * rng.random((b, 3))) * span
    r1 = r0 + 0.01 * rng.random((b, 3)) * span
    return (torch.from_numpy(r1).to(dev, dtype),
            torch.from_numpy(r0).to(dev, dtype))


def _build(tiu, meshgen, mesh, dtype, dev):
    """A walk grid without candidate tables of ``mesh``: a side of a tet
    box, or (cell type, nx, ny) of a planar mesh."""
    if isinstance(mesh, int):
        cell_type = "tetra"
        pts, cells, nbrs = meshgen.tet_box_mesh(mesh, mesh, mesh)
    else:
        cell_type, nx, ny = mesh
        make = {"triangle": meshgen.triangle_rect_mesh,
                "quad": meshgen.quad_rect_mesh}[cell_type]
        pts, cells, nbrs = make(nx, ny)
    pd = {"Ex": np.sin(3 * pts[:, 0]) + pts[:, 1],
          "Ey": np.cos(2 * pts[:, 1]) * pts[:, 2],
          "Ez": pts[:, 0] * pts[:, 1] - pts[:, 2]}
    return tiu.build_grid(pts, cells, nbrs, cell_type, point_data=pd,
                          dtype=dtype, device=dev, locate_mode="walk",
                          config=tiu.IUConfig(use_candidate_bins=False))


def main() -> int:
    if not torch.cuda.is_available():
        print("warm_order_sweep: torch.cuda.is_available() is false; this "
              "script needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.ops import (
        _kernels,
        interp,
        locate,
        order_kernel,
    )
    from interpolate_unstructured_tpu_torch.utils import meshgen

    print(f"card: {chip_smoke.card_line()}")
    dev = torch.device("cuda", 0)
    _kernels.lib()
    l2 = order_kernel.l2_bytes(dev)
    print(f"L2 {l2} bytes; rule: tets, walk rows at least "
          f"{order_kernel.MIN_L2_TIMES} times the L2 "
          f"({order_kernel.MIN_L2_TIMES * l2 // 512} cells), at least "
          f"{order_kernel.MIN_PER_CELL} queries a cell and "
          f"{order_kernel.MIN_BATCH_L2_TIMES * l2 // 512} queries",
          flush=True)

    def unordered(grid, r, g):
        ic, found = locate.get_cell(grid, r, g)
        return ic, found, interp.interpolate_at_icell(grid, r, SLOTS, ic)

    def ordered(grid, r, g, run):
        with _key_run(order_kernel, run):
            return interp._in_bin_order(grid, r, SLOTS, g)

    def compare(label, grid, r, g, runs):
        """Check the bin order at each KEY_RUN of ``runs`` against the
        unordered route, then time them all in turns; prints one line,
        returns {design: ms}."""
        want = unordered(grid, r, g)
        fns = {"unordered": lambda: unordered(grid, r, g)}
        for run in runs:
            with _key_run(order_kernel, run):
                name = f"shift {order_kernel.key_shift(grid.bin_shape)}"
            got = ordered(grid, r, g, run)
            for x, y in zip(got, want):
                chip_smoke.check(torch.equal(x, y), f"{label}: {name} "
                                 "differs")
            fns[name] = lambda run=run: ordered(grid, r, g, run)
        t = chip_smoke.turns(fns, REPS)
        rule = order_kernel.key_shift(grid.bin_shape)
        takes = interp._takes_bin_order(grid, r.shape[0])
        print(f"{label} (walk rows {grid.walk_table.nbytes / l2:.2f} L2; "
              f"rule: shift {rule}, engages {takes}): "
              + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                          for k, v in t.items()) + " ms", flush=True)
        return {k: min(v) for k, v in t.items()}

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        t0 = time.perf_counter()
        grid = _build(tiu, meshgen, 55, dtype, dev)
        n = grid.n_cells
        print(f"{name} 998,250-tet walk grid in {time.perf_counter() - t0:.3f}"
              f" s: seed bins {grid.bin_shape}", flush=True)
        r_all, r0_all = _particles(grid, int(max(RATIOS) * n), dev, dtype)
        g_all, _ = locate.get_cell(grid, r0_all)
        del r0_all
        for ratio in RATIOS:
            b = int(ratio * n)
            r, g = r_all[:b], g_all[:b]
            for guess in (g, None):
                compare(f"{name} B/n_cells {ratio} ({b}) "
                        f"{'warm' if guess is not None else 'cold'}",
                        grid, r, guess, KEY_RUNS)
        # the stages alone at the particles cell's size, warm
        r, g = r_all, g_all
        b = r.shape[0]
        ic_u = locate.get_cell(grid, r, g)[0]
        key, rank, pos = (torch.empty(b, dtype=torch.int32, device=dev)
                          for _ in range(3))
        entry = order_kernel._KEY_ENTRY[dtype]
        s = order_kernel.key_shift(grid.bin_shape)
        r_o, g_o, back = order_kernel.order(grid, r, g)
        ic_o, f_o = locate.get_cell(grid, r_o, g_o)
        v_o = interp.interpolate_at_icell(grid, r_o, SLOTS, ic_o)
        n_keys = order_kernel.n_keys(grid.bin_shape, s)

        def key_pass():
            counts = torch.zeros(n_keys, dtype=torch.int32, device=dev)
            getattr(_kernels.lib(), entry)(
                r.data_ptr(), b, grid.bin_rmin.data_ptr(),
                grid.bin_inv_h.data_ptr(), *grid.bin_shape, s,
                counts.data_ptr(), key.data_ptr(), rank.data_ptr(),
                pos.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

        stages = {
            "key pass (with the counts' zeroing)": key_pass,
            "key pass + scan + scatter": (
                lambda: order_kernel.order(grid, r, g)),
            "B3 ordered": lambda: locate.get_cell(grid, r_o, g_o),
            "E1 ordered": lambda: interp.interpolate_at_icell(
                grid, r_o, SLOTS, ic_o),
            "unsort": lambda: order_kernel.unsort(back, ic_o, f_o, v_o),
            "B3 unordered": lambda: locate.get_cell(grid, r, g),
            "E1 unordered": lambda: interp.interpolate_at_icell(
                grid, r, SLOTS, ic_u),
            "order plain": lambda: order_kernel.order_plain(
                r, g, grid.bin_rmin, grid.bin_inv_h, grid.bin_shape, s),
            "unsort plain": lambda: order_kernel.unsort_plain(
                back, ic_o, f_o, v_o),
        }
        print(f"{name} stages at {b} warm queries, shift {s} "
              f"({n_keys} key bins; CUDA events, in order then "
              f"reverse): " + ", ".join(
                  f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in
                  chip_smoke.turns(stages, REPS).items()) + " ms",
              flush=True)
        del r_o, g_o, back, ic_o, f_o, v_o, stages
        del grid, r_all, g_all, r, g, key, rank, pos, ic_u
        torch.cuda.empty_cache()

    for mesh in (*SMALL, *PLANAR):
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).replace("torch.", "")
            grid = _build(tiu, meshgen, mesh, dtype, dev)
            sizes = [int(x * grid.n_cells) for x in SMALL_RATIOS]
            r_all, r0_all = _particles(grid, max(sizes), dev, dtype)
            g_all, _ = locate.get_cell(grid, r0_all)
            del r0_all
            for b in sizes:
                for guess in (g_all[:b], None):
                    compare(f"{name} {grid.n_cells} {grid.cell_type} B "
                            f"{b} ({b / grid.n_cells:.0f} a cell) "
                            f"{'warm' if guess is not None else 'cold'}",
                            grid, r_all[:b], guess,
                            (order_kernel.KEY_RUN,))
            del grid, r_all, g_all
            torch.cuda.empty_cache()
    print("warm_order_sweep: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
