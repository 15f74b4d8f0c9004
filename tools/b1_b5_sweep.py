#!/usr/bin/env python3
"""Sweeps of kernels B1 and B5 on one GPU: B1's queries a thread and
threads a block on ``chip_smoke.py``'s three brute-force meshes, and B5's
threads a block on 10M float64 queries of the 998,250-tet box.

    python3 tools/b1_b5_sweep.py

1. B1 (``csrc/interp_bruteforce.cu``): the brute-force phase's meshes (8
   triangles, 64 quads, 750 tets) and its 1M queries plus 1% outside
   (``default_rng(1)``, ``chip_smoke.bf_queries``).  For each of 1, 2, 4
   and 8 queries a thread and 128, 256 and 512 threads a block, the
   kernel is first checked ``torch.equal`` to
   ``interpolate_bruteforce_plain`` (ids, found masks, values), then
   timed with CUDA events, the configurations in order, then in reverse:
   the measurement behind ``ops/interp_kernel.QUERIES_PER_THREAD`` and
   ``THREADS``.  On the 750 tets, nvidia-smi's SM clock and power draw
   are read in the middle of 2 s of back-to-back launches at the
   wrapper's configuration (the instruction floor assumes 1.98 GHz).
2. B5 (``csrc/interp_acc.cu``): ``tet_box_mesh(55, 55, 55)`` built
   without candidate tables and prepared for accurate mode (the acc table
   alone), 10M float64 queries at random convex combinations of a random
   cell's vertices (``default_rng(7)``), one variable.  For 64, 128, 256
   and 512 threads a block, the kernel is first checked ``torch.equal``
   to ``interp_acc_plain`` on the first 1M, then timed as above: the
   measurement behind ``ops/acc_kernel.THREADS``; the SM clock under load
   as for B1.

Prints the card (nvidia-smi name and power limit) first; exits non-zero
without a CUDA device or when a check fails.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

B1_Q = (1, 2, 4, 8)  # queries a thread
B1_THREADS = (128, 256, 512)
B5_THREADS = (64, 128, 256, 512)
N_B5 = 10_000_000
N_B5_CMP = 1_000_000


def sm_clock_under(fn, seconds=2.0):
    """nvidia-smi's SM clock, its maximum and the power draw, read in the
    middle of ``seconds`` of back-to-back calls of ``fn``."""
    out = {}

    def sample():
        time.sleep(seconds / 2)
        out["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()

    th = threading.Thread(target=sample)
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    th.join()
    return out.get("smi", "not read")


def b1_sweep(chip_smoke, tiu, meshgen, interp_kernel, dev):
    rng = np.random.default_rng(1)
    mine = (interp_kernel.QUERIES_PER_THREAD, interp_kernel.THREADS)
    configs = [(q, t) for q in B1_Q for t in B1_THREADS]
    for cell_type, label, (pts, cells, nbrs) in chip_smoke.bf_meshes(meshgen):
        grid = tiu.build_grid(
            pts, cells, nbrs, cell_type,
            point_data={"Polynomial": pts.sum(1) + 1.0},
            dtype=torch.float32, device=dev)
        r = chip_smoke.bf_queries(pts, rng, dev)[:chip_smoke.N_BF]

        def call(q, t):
            return interp_kernel.interpolate_bruteforce_cuda(
                grid, r, [0], q=q, threads=t)

        want = interp_kernel.interpolate_bruteforce_plain(grid, r, [0])
        for c in configs:
            for name, a, b in zip(("values", "i_cell", "found"), call(*c),
                                  want):
                chip_smoke.check(torch.equal(a, b), f"B1 {label}, "
                                 f"{'x'.join(map(str, c))}: {name} differs "
                                 "from the plain version")
        del want
        ms = chip_smoke.turns({c: (lambda c=c: call(*c)) for c in configs},
                              10)
        print(f"B1 {label} ({grid.n_cells} cells), {r.shape[0]} queries, "
              "torch.equal to the plain version in every configuration; ms "
              "(in order / in reverse) by queries a thread x threads a "
              "block: "
              + ", ".join(f"{'x'.join(map(str, c))}: {ms[c][0]:.4f} / "
                          f"{ms[c][1]:.4f}" for c in configs))
        best = min(configs, key=lambda c: sum(ms[c]))
        print(f"B1 {label}: fastest {'x'.join(map(str, best))} "
              f"({sum(ms[best]) / 2:.4f} ms); the wrapper's "
              f"{'x'.join(map(str, mine))}: {sum(ms[mine]) / 2:.4f} ms")
        if cell_type == "tetra":
            print(f"B1 {label}, the wrapper's configuration: SM clock, its "
                  "maximum and power draw under load: "
                  + sm_clock_under(lambda: call(*mine)))


def b5_sweep(chip_smoke, tiu, meshgen, acc_kernel, dev):
    from interpolate_unstructured_tpu_torch.ops import df32

    t0 = time.perf_counter()
    pts, cells, nbrs = meshgen.tet_box_mesh(55, 55, 55)
    grid = tiu.prepare_accurate(tiu.build_grid(
        pts, cells, nbrs, "tetra", point_data={"Polynomial": pts.sum(1) + 1.0},
        dtype=torch.float32, locate_mode="walk",
        config=tiu.IUConfig(use_candidate_bins=False), device=dev),
        build_df=False)
    print(f"B5: 998,250-tet box and acc table in "
          f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(7)
    ic = rng.integers(0, len(cells), N_B5)
    w = rng.random((N_B5, 4)) + 0.05
    w /= w.sum(1, keepdims=True)
    r64 = np.einsum("nk,nkd->nd", w, pts[cells[ic]])
    del w
    r_hi, r_lo = df32.split_queries(torch.from_numpy(r64).to(dev))
    del r64
    ic = torch.from_numpy(ic.astype(np.int32)).to(dev)
    meta = ("tetra", 4, grid.n_point_data, (0,))

    def call(t, cut=slice(None)):
        return acc_kernel.interp_acc_cuda(grid.acc_table, ic[cut], r_hi[cut],
                                          r_lo[cut], *meta, threads=t)

    cut = slice(0, N_B5_CMP)
    want = acc_kernel.interp_acc_plain(grid.acc_table, ic[cut], r_hi[cut],
                                       r_lo[cut], *meta)
    for t in B5_THREADS:
        for name, a, b in zip(("hi", "lo"), call(t, cut), want):
            chip_smoke.check(torch.equal(a, b), f"B5, {t} threads: {name} "
                             "differs from the plain version")
    del want
    ms = chip_smoke.turns({t: (lambda t=t: call(t)) for t in B5_THREADS}, 10)
    print(f"B5, {N_B5} float64 queries in random cells, torch.equal to the "
          "plain version at every block size on the first 1M; ms (in order "
          "/ in reverse) by threads a block: "
          + ", ".join(f"{t}: {ms[t][0]:.4f} / {ms[t][1]:.4f}"
                      for t in B5_THREADS)
          + f"; the wrapper's {acc_kernel.THREADS}; SM clock, its maximum "
          "and power draw under load: "
          + sm_clock_under(lambda: call(acc_kernel.THREADS)))


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_b5_sweep: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.ops import acc_kernel, interp_kernel
    from interpolate_unstructured_tpu_torch.utils import meshgen

    print(f"card: {chip_smoke.card_line()}")
    dev = torch.device("cuda", 0)
    b1_sweep(chip_smoke, tiu, meshgen, interp_kernel, dev)
    b5_sweep(chip_smoke, tiu, meshgen, acc_kernel, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
