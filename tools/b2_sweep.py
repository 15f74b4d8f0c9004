#!/usr/bin/env python3
"""Sweeps of B2's bin-ordered probe on one GPU: batch sizes and lanes a
query, on the 998,250-tet box of ``chip_smoke.py``'s candidate phase,
and lanes a query of the df-plane probe (B2-df) on the same box
prepared for accurate mode.

    python3 tools/b2_sweep.py

Builds the box with candidate tables (``tet_box_mesh(55, 55, 55)``,
float32) and takes the candidate phase's 10M cold queries
(``default_rng(2)``).  Then, timed with CUDA events in turns (old, new,
new, old; or each lane count in order, then in reverse):

1. batch sizes 1k-1M: the direct composition (torch bin index and local
   frame, then the direct kernel of ``tools/cand_ext_alternatives.cu``,
   built beside the port's library by ``tools/cand_ext_sweep.py``'s
   helpers) against ``cand_rows_binned_query``
   (bin pass, scan, scatter, probe in bin order, unsort) -- the
   measurement behind the absence of a size threshold for the direct
   kernel on the main table;
2. lanes a query of the probe in bin order, 1 to 32, at 1M, 2M, 4M and
   10M queries (0.5 to 5 queries a bin), probe and unsort together, each
   lane count first checked torch.equal to ``probe_rows_plain`` -- the
   measurement behind ``ops/cand_kernel.binned_lanes``;
3. lanes a query of the df-plane probe in bin order (layout 3), 1 to 32,
   at 1M and 10M float64 queries (``default_rng(2)``, the accurate
   phase's), probe and unsort together, each lane count first checked
   torch.equal to ``cand_rows_df_plain`` -- whether the df rows (872
   bytes read a query, two value planes) want another rule.

Prints the card (nvidia-smi name and power limit) first; exits non-zero
without a CUDA device or when a check fails.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SIZES = (1_000, 10_000, 100_000, 1_000_000)  # batches of the size sweep
LANES = (1, 2, 4, 8, 16, 32)  # lanes a query of the probe in bin order
DENSITY = (1_000_000, 2_000_000, 4_000_000, 10_000_000)  # lanes sweep
DF_DENSITY = (1_000_000, 10_000_000)  # lanes sweep of the df-plane rows


def main() -> int:
    if not torch.cuda.is_available():
        print("b2_sweep: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.models import cand_table
    from interpolate_unstructured_tpu_torch.ops import cand_kernel
    from interpolate_unstructured_tpu_torch.utils import meshgen

    import cand_ext_sweep

    print(f"card: {chip_smoke.card_line()}")
    proc, out = cand_ext_sweep.start_build()
    lib = cand_ext_sweep.finish_build(proc, out)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    pts, cells, nbrs = meshgen.tet_box_mesh(55, 55, 55)
    grid = tiu.build_grid(
        pts, cells, nbrs, "tetra", point_data={"Polynomial": pts.sum(1) + 1.0},
        dtype=torch.float32, locate_mode="walk", device=dev)
    k = grid.cand_ids.shape[1]
    n_bins = int(np.prod(grid.cand_shape))
    print(f"998,250-tet box with candidate tables in "
          f"{time.perf_counter() - t0:.3f} s: K={k}, {n_bins} bins")
    r = torch.from_numpy(np.random.default_rng(2).random(
        (max(DENSITY), 3)).astype(np.float32)).to(dev)
    lay = cand_table.layout(grid, k, (0,))
    eps = cand_table.probe_eps(grid)
    chunk = cand_table.probe_chunk(grid)
    bins = (grid.cand_rmin, grid.cand_inv_h, grid.cand_shape)

    for b in SIZES:
        rb = r[:b]
        t = chip_smoke.turns({
            "old": lambda: cand_ext_sweep.direct(
                lib, grid.cand_table, *cand_table.probe_inputs(grid, rb),
                lay, eps, k),
            "new": lambda: cand_kernel.cand_rows_binned_query(
                grid.cand_table, rb, *bins, lay, eps, k, chunk),
        }, 20)
        print(f"B2 size sweep, {b} cold queries: old composition "
              f"{t['old'][0]:.4f} / {t['old'][1]:.4f} ms, bin-ordered "
              f"{t['new'][0]:.4f} / {t['new'][1]:.4f} ms")

    for b in DENSITY:
        rb = r[:b]
        _, _, perm, slot = cand_kernel.bin_order_cuda(rb, *bins)
        want = cand_kernel.probe_rows_plain(
            grid.cand_table, *cand_table.probe_inputs(grid, rb), lay, eps,
            k, chunk)

        def probe(g):
            return cand_kernel.cand_rows_binned_cuda(
                grid.cand_table, rb, perm, slot, *bins, lay, eps, k, lanes=g)

        for g in LANES:
            for name, a, w in zip(("id", "aux", "values"), probe(g), want):
                chip_smoke.check(torch.equal(a, w), f"{b} queries, {g} lanes "
                                 f"a query: {name} differs from "
                                 f"probe_rows_plain")
        del want
        t = chip_smoke.turns({g: (lambda g=g: probe(g)) for g in LANES}, 10)
        print(f"B2 probe and unsort in bin order, {b} cold queries "
              f"({b / n_bins:.2f} a bin; binned_lanes picks "
              f"{cand_kernel.binned_lanes(b, n_bins)}), torch.equal to "
              f"probe_rows_plain at every lane count; lanes a query (in "
              f"turns): " + ", ".join(f"{g}: {t[g][0]:.4f} / {t[g][1]:.4f} ms"
                                      for g in LANES))
        del rb, perm, slot
    del r

    t0 = time.perf_counter()
    grid = tiu.prepare_accurate(grid)
    print(f"prepare_accurate in {time.perf_counter() - t0:.3f} s: "
          f"cand_df_table {tuple(grid.cand_df_table.shape)}")
    lay = cand_table.df_layout(grid, (0,))
    eps = cand_table.probe_eps(grid)
    table = grid.cand_df_table
    chunk = cand_table.probe_chunk(grid, table)
    n = len(lay.var_roles)
    r64 = torch.from_numpy(np.random.default_rng(2).random(
        (max(DF_DENSITY), 3))).to(dev)
    for b in DF_DENSITY:
        rb = r64[:b]
        _, _, perm, slot = cand_kernel.bin_order_cuda(rb, *bins)
        want = cand_kernel.cand_rows_df_plain(table, rb, None, *bins, lay,
                                              eps, k, chunk)

        def probe(g):
            return cand_kernel.cand_rows_binned_cuda(
                table, rb, perm, slot, *bins, lay, eps, k, lanes=g)

        for g in LANES:
            got = probe(g)
            for name, a, w in zip(("id", "aux", "vals_hi", "vals_lo"),
                                  (got[0], got[1], got[2][:, :n],
                                   got[2][:, n:]), want):
                chip_smoke.check(torch.equal(a, w), f"df rows, {b} queries, "
                                 f"{g} lanes a query: {name} differs from "
                                 f"cand_rows_df_plain")
        del want, got
        t = chip_smoke.turns({g: (lambda g=g: probe(g)) for g in LANES}, 10)
        print(f"B2-df probe and unsort in bin order, {b} cold float64 "
              f"queries ({b / n_bins:.2f} a bin; binned_lanes picks "
              f"{cand_kernel.binned_lanes(b, n_bins)}), torch.equal to "
              f"cand_rows_df_plain at every lane count; lanes a query (in "
              f"turns): " + ", ".join(f"{g}: {t[g][0]:.4f} / {t[g][1]:.4f} ms"
                                      for g in LANES))
        del rb, perm, slot
    return 0


if __name__ == "__main__":
    sys.exit(main())
