#!/usr/bin/env python3
"""Float32 linear error of ``interpolate_at_icell`` on the 998,250-tet box,
the JAX package beside the torch port, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/icell_error_witness.py [--n 1000000]

The queries are the first ``--n`` warm queries of ``chip_smoke.py``'s
walk phase (``tet_box_mesh(55, 55, 55)``, points in [0.1, 0.9]^3 moved
by 0.01 * velocity, seed 4), and the data is Polynomial = x + y + z + 1.
The JAX package builds the float32 walk grid (no candidate tables, no
seed refine: the cell a walk ends in does not depend on its seed) and
locates the queries with its ``get_cell``; both packages then
interpolate in those cells with ``interpolate_at_icell``, the port on
the JAX grid's tables carried over with ``grid_from_numpy``.  Prints
each package's largest linear error and the largest difference between
them.  Needs about 3 GB of memory.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import interpolate_unstructured_tpu as jiu  # noqa: E402
import interpolate_unstructured_tpu_torch as tiu  # noqa: E402
from interpolate_unstructured_tpu_torch.models.grid import (  # noqa: E402
    DATA_FIELDS,
    META_FIELDS,
)
from interpolate_unstructured_tpu_torch.utils import meshgen  # noqa: E402

N_TOTAL = 10_000_000  # the walk phase's query count (its random stream)
CHUNK = 250_000  # >= n_cells / 4: the per-call row-table route, as at 10M


def warm_queries(n):
    """The first n warm queries of chip_smoke.py's walk phase, float32."""
    rng = np.random.default_rng(4)
    r = (0.1 + 0.8 * rng.random((N_TOTAL, 3))).astype(np.float32)[:n]
    vel = rng.random((N_TOTAL, 3)).astype(np.float32)[:n]
    return r + np.float32(0.01) * vel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")

    t0 = time.perf_counter()
    pts, cells, nbrs = meshgen.tet_box_mesh(55, 55, 55)
    ug = jiu.build_grid(
        pts, cells, nbrs, "tetra", point_data={"Polynomial": pts.sum(1) + 1.0},
        dtype=jnp.float32, locate_mode="walk",
        config=jiu.IUConfig(use_candidate_bins=False, refine_bin_seeds=False),
    )
    tg = tiu.grid_from_numpy(
        {f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
         for f in DATA_FIELDS},
        {f: getattr(ug, f) for f in META_FIELDS}, "cpu",
    )
    print(f"{ug.n_cells} tets; JAX grid built and carried over in "
          f"{time.perf_counter() - t0:.1f} s")

    r = warm_queries(args.n)
    truth = r.astype(np.float64).sum(1) + 1.0
    locate = jax.jit(lambda g, q: jiu.get_cell(g, q))
    icell = jax.jit(lambda g, q, c: jiu.interpolate_at_icell(g, q, [0], c))
    err_j = err_t = diff = 0.0
    worst = None
    n_found = 0
    for lo in range(0, args.n, CHUNK):
        q = r[lo: lo + CHUNK]
        ic, found = locate(ug, jnp.asarray(q))
        n_found += int(np.asarray(found).sum())
        v_j = np.asarray(icell(ug, jnp.asarray(q), ic))[:, 0]
        v_t = tiu.interpolate_at_icell(
            tg, torch.from_numpy(q), [0], torch.from_numpy(np.array(ic))
        )[:, 0].numpy()
        e_j = np.abs(v_j - truth[lo: lo + CHUNK])
        e_t = np.abs(v_t - truth[lo: lo + CHUNK])
        if e_j.max() > err_j:
            k = int(e_j.argmax())
            worst = (lo + k, q[k].tolist(), int(np.asarray(ic)[k]))
        err_j = max(err_j, float(e_j.max()))
        err_t = max(err_t, float(e_t.max()))
        diff = max(diff, float(np.abs(v_j - v_t).max()))
    print(f"{args.n} warm queries, {n_found} found by the JAX get_cell")
    print(f"interpolate_at_icell linear error, float32: JAX package "
          f"{err_j:.4e} (query {worst[0]} at {worst[1]}, cell {worst[2]}), "
          f"torch port {err_t:.4e}; max |JAX - port| {diff:.4e}")
    return 0 if n_found == args.n else 1


if __name__ == "__main__":
    sys.exit(main())
