#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives the cold interpolation path of ``interpolate_unstructured_tpu_torch``
on the card through its public entry points (``build_grid``, then
``interpolate_scalar_at``):

1. builds the CUDA kernels from ``interpolate_unstructured_tpu_torch/csrc``
   into ``build/kernels/`` (set-up time);
2. brute-force phase: the 8-triangle mesh of the reference's
   benchmark.f90, an 8x8 quad mesh and a 750-tet box, 1M cold queries
   inside the bounding box plus 1% outside it (kernel B1);
3. candidate phase: the 998,250-tet box of ``bench.py``, 10M uniform cold
   queries (kernel B2), and a 10,368-tet box whose bins overflow into
   an extension table;
4. holds each kernel against its plain PyTorch version on the same CUDA
   tensors, checks linear exactness and found masks, and times kernel
   and plain version with CUDA events.

Launch counters are zeroed right before each main-path call and read
right after it; comparison and timing launches are not counted.  The
last three lines are the card (nvidia-smi name, power limit), a JSON
line of per-kernel results, and ``{"ok": true, "device": ...}``.  Any
failed check raises before them, with a non-zero exit; without a CUDA
device the script exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_BF = 1_000_000  # brute-force queries per mesh (benchmark.f90 protocol)
N_CAND = 10_000_000  # cold queries on the 998k-tet mesh (bench.py)
N_CMP = 1_000_000  # queries of the kernel-vs-plain comparison
LIN_TOL = 2e-6  # float32 linear-exactness bound, both phases
VAL_TOL = 2e-6  # kernel vs plain values where the cell ids agree
AGREE = 0.99999  # share of queries whose ic/found/aux must be identical
FILL = -7.0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main_path(fn, counters):
    """Run one main-path call with every launch counter zeroed first;
    return its result and the launches it made, per kernel module."""
    for mod in counters:
        mod.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {mod.__name__: mod.launches for mod in counters}


def compare(name, k_ic, p_ic, k_vals, p_vals, margins_of, tol_band,
            k_aux=None, p_aux=None):
    """Kernel vs plain: identical verdicts on >= AGREE of the queries,
    every disagreement a near-tie, values within VAL_TOL where ids
    agree.  Returns (n_disagree, max_abs_err)."""
    same = k_ic == p_ic
    if k_aux is not None:
        same &= k_aux == p_aux
    bad = torch.nonzero(~same).squeeze(1)
    n_bad = int(bad.numel())
    check(n_bad <= (1 - AGREE) * same.numel(),
          f"{name}: {n_bad} of {same.numel()} verdicts differ")
    if n_bad:
        top2, eps = margins_of(bad)
        near = ((top2[:, 0] + eps).abs() <= tol_band) | (
            (top2[:, 0] - top2[:, 1]).abs() <= tol_band
        )
        check(bool(near.all()), f"{name}: a disagreement is not a near-tie")
    ok = same & ((k_ic >= 0) if k_aux is None else (k_aux == -2))
    err = float((k_vals[ok] - p_vals[ok]).abs().max()) if ok.any() else 0.0
    check(err <= VAL_TOL, f"{name}: values differ by {err}")
    print(f"{name}: kernel vs plain: {n_bad} of {same.numel()} verdicts "
          f"differ; max |value diff| {err:.3e}")
    return n_bad, err


def bruteforce_phase(dev, tiu, meshgen, interp_kernel, locate, cand_kernel):
    rng = np.random.default_rng(1)
    meshes = [
        ("triangle", "triangle_rect_mesh(2,2)", meshgen.triangle_rect_mesh(2, 2)),
        ("quad", "quad_rect_mesh(8,8)", meshgen.quad_rect_mesh(8, 8)),
        ("tetra", "tet_box_mesh(5,5,5)", meshgen.tet_box_mesh(5, 5, 5)),
    ]
    res = {"launches": 0, "max_abs_err": 0.0, "rows": []}
    for cell_type, label, (pts, cells, nbrs) in meshes:
        grid = tiu.build_grid(
            pts, cells, nbrs, cell_type, point_data={"Polynomial": pts.sum(1) + 1.0},
            dtype=torch.float32, device=dev,
        )
        check(grid.locate_mode == "bruteforce", f"{label} is not brute force")
        lo, hi = pts.min(0), pts.max(0)
        span = hi - lo
        r_in = lo + rng.random((N_BF, 3)) * span
        n_out = N_BF // 100
        r_out = lo + rng.random((n_out, 3)) * span
        side = np.where(rng.random(n_out) < 0.5, -1.0, 1.0)
        r_out[:, 0] = np.where(side < 0, lo[0], hi[0]) + side * (
            0.01 + rng.random(n_out)) * span[0]
        r = torch.from_numpy(np.concatenate([r_in, r_out]).astype(np.float32)).to(dev)

        (vals, ic, found), counts = main_path(
            lambda: tiu.interpolate_scalar_at(grid, r, 0, fill_value=FILL),
            (interp_kernel, cand_kernel),
        )
        n_b1 = counts[interp_kernel.__name__]
        check(n_b1 >= 1, f"{label}: B1 was not launched on the main path")
        res["launches"] += n_b1
        truth = r.double().sum(1) + 1.0
        check(bool(found[:N_BF].all()), f"{label}: an inside query was not found")
        dev_err = torch.where(found, (vals.double() - truth).abs(), 0.0)
        lin = float(dev_err.max())
        worst = int(dev_err.argmax())
        check(lin <= LIN_TOL, f"{label}: linear-exactness error {lin} at "
              f"r={r[worst].tolist()} ic={int(ic[worst])} v={float(vals[worst])}")
        out = slice(N_BF, None)
        check(not bool(found[out].any()), f"{label}: an outside query was found")
        check(bool((vals[out] == FILL).all() and (ic[out] == -1).all()),
              f"{label}: outside queries do not carry the fill value")

        pv, pic, _ = interp_kernel.interpolate_bruteforce_plain(grid, r, [0])
        eps = grid.config.eps_inside

        def margins_of(bad):
            m = locate._containment_margins(grid, r[bad])
            return torch.topk(m, min(2, m.shape[1]), dim=1).values, eps

        _, err = compare(f"B1 {label}", ic, pic, vals, pv[:, 0], margins_of,
                         4 * eps)
        res["max_abs_err"] = max(res["max_abs_err"], err)

        ms_k = cuda_ms(lambda: interp_kernel.interpolate_bruteforce_cuda(
            grid, r[:N_BF], [0]), 10)
        ms_p = cuda_ms(lambda: interp_kernel.interpolate_bruteforce_plain(
            grid, r[:N_BF], [0]), 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            tiu.interpolate_scalar_at(grid, r[:N_BF], 0)
        torch.cuda.synchronize()
        e2e = (time.perf_counter() - t0) / 5
        print(f"B1 {label} ({grid.n_cells} cells), 1M queries: kernel "
              f"{ms_k:.4f} ms, plain {ms_p:.4f} ms; interpolate_scalar_at "
              f"{e2e * 1e3:.4f} ms = {N_BF / e2e:.4e} queries/s; "
              f"linear error {lin:.3e}")
        res["rows"].append((label, grid.n_cells, ms_k, ms_p, e2e, lin))
    res["ms"], res["plain_ms"] = res["rows"][-1][2], res["rows"][-1][3]
    return res


def probe_compare(name, grid, table, idx, rq, k, ovf_base, cand_kernel, locate):
    lay = locate._row_layout(grid, k, (0,))
    eps = locate._cand_eps(grid)
    kid, kaux, kv = cand_kernel.cand_rows_cuda(table, idx, rq, lay, eps, ovf_base)
    pid, paux, pv = cand_kernel.probe_rows_plain(
        table, idx, rq, lay, eps, ovf_base, locate._cand_chunk(grid, table))

    def margins_of(bad):
        g = cand_kernel._gather_rows(table, idx[bad])
        _, m = cand_kernel._margins_plain(g, rq[bad], lay)
        return torch.topk(m, 2, dim=1).values, eps

    n_bad, err = compare(name, kid, pid, kv[:, 0], pv[:, 0], margins_of,
                         4 * eps, kaux, paux)
    return n_bad, err, lay, eps, kaux


def candidate_phase(dev, tiu, meshgen, interp_kernel, locate, cand_kernel):
    res = {}
    n = 55
    t0 = time.perf_counter()
    pts, cells, nbrs = meshgen.tet_box_mesh(n, n, n)
    mesh_s = time.perf_counter() - t0
    timings = {}
    t0 = time.perf_counter()
    grid = tiu.build_grid(
        pts, cells, nbrs, "tetra", point_data={"Polynomial": pts.sum(1) + 1.0},
        dtype=torch.float32, locate_mode="walk", device=dev, timings=timings,
    )
    build_s = time.perf_counter() - t0
    k = grid.cand_ids.shape[1]
    print(f"B2 mesh tet_box_mesh({n},{n},{n}): {grid.n_cells} tets, "
          f"meshgen {mesh_s:.3f} s; build_grid {build_s:.3f} s split "
          + json.dumps({kk: round(v, 4) for kk, v in timings.items()})
          + f"; table {tuple(grid.cand_table.shape)} K={k} "
          f"ext={grid.cand_ext_table is not None} qeps={grid.cand_qeps:.3e}")
    check(grid.cand_table is not None and grid.cand_ext_covers,
          "998k-tet grid has no covering candidate table")

    r = torch.from_numpy(
        np.random.default_rng(2).random((N_CAND, 3)).astype(np.float32)
    ).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (vals, ic, found), counts = main_path(
        lambda: tiu.interpolate_scalar_at(grid, r, 0, fill_value=0.0),
        (interp_kernel, cand_kernel),
    )
    first_s = time.perf_counter() - t0
    res["launches"] = counts[cand_kernel.__name__]
    check(res["launches"] >= 1, "B2 was not launched on the main path")
    check(bool(found.all()), f"{int((~found).sum())} of 10M queries not found")
    lin = float((vals.double() - (r.double().sum(1) + 1.0)).abs().max())
    check(lin <= LIN_TOL, f"998k-tet linear-exactness error {lin}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        tiu.interpolate_scalar_at(grid, r, 0, fill_value=0.0)
    torch.cuda.synchronize()
    e2e = (time.perf_counter() - t0) / reps
    print(f"B2 10M cold interpolate_scalar_at: first call {first_s:.4f} s, "
          f"steady {e2e * 1e3:.4f} ms = {N_CAND / e2e:.4e} queries/s; "
          f"all found; linear error {lin:.3e}")

    idx, rq = locate._cand_probe_inputs(grid, r)
    _, err, lay, eps, _ = probe_compare(
        "B2 998k-tet main table, first 1M", grid, grid.cand_table,
        idx[:N_CMP], rq[:N_CMP], k, k, cand_kernel, locate)
    res["max_abs_err"] = err
    chunk = locate._cand_chunk(grid)
    ms_k = cuda_ms(lambda: cand_kernel.cand_rows_cuda(
        grid.cand_table, idx, rq, lay, eps, k), 10)
    ms_p = cuda_ms(lambda: cand_kernel.probe_rows_plain(
        grid.cand_table, idx, rq, lay, eps, k, chunk), 2)
    ms_prep = cuda_ms(lambda: locate._cand_probe_inputs(grid, r), 10)
    print(f"B2 998k-tet, 10M queries: kernel {ms_k:.4f} ms "
          f"({ms_k / 10:.4f} ms per 1M), plain {ms_p:.4f} ms; bin index + "
          f"local frame {ms_prep:.4f} ms; row {grid.cand_table.shape[1] * 4} B")
    res["ms"], res["plain_ms"], res["e2e_s"] = ms_k, ms_p, e2e
    del idx, rq, vals, ic, found, r, grid
    torch.cuda.empty_cache()

    # Extension table: bins overflow K and spill into extension rows
    pts, cells, nbrs = meshgen.tet_box_mesh(12, 12, 12)
    grid = tiu.build_grid(
        pts, cells, nbrs, "tetra", point_data={"Polynomial": pts.sum(1) + 1.0},
        dtype=torch.float32, device=dev,
        config=tiu.IUConfig(cand_bins_per_cell=0.3, cand_ext_max_k=256,
                            cand_cover_row_bytes=0),
    )
    check(grid.cand_ext_table is not None and grid.cand_ext_covers,
          "forced-extension grid has no covering extension table")
    r = torch.from_numpy(
        (np.random.default_rng(3).random((N_CMP, 3)) * 1.1 - 0.05)
        .astype(np.float32)).to(dev)
    k = grid.cand_ids.shape[1]
    k_ext = grid.cand_ext_ids.shape[1]
    idx, rq = locate._cand_probe_inputs(grid, r)
    _, err1, _, _, kaux = probe_compare(
        "B2 extension grid, main table", grid, grid.cand_table, idx, rq, k,
        k, cand_kernel, locate)
    sel = torch.nonzero(kaux >= 0).squeeze(1)
    check(sel.numel() > 0, "no query reached the extension table")
    _, err2, _, _, _ = probe_compare(
        "B2 extension grid, extension table", grid, grid.cand_ext_table,
        kaux[sel].contiguous(), rq[sel].contiguous(), k_ext, k + k_ext,
        cand_kernel, locate)
    res["max_abs_err"] = max(res["max_abs_err"], err1, err2)
    vals, ic, found = tiu.interpolate_scalar_at(grid, r, 0)
    # clear of the boundary by far more than the inside tolerance
    strict = ((r > 1e-4) & (r < 1 - 1e-4)).all(1)
    outside = ((r < -1e-4) | (r > 1 + 1e-4)).any(1)
    check(bool(found[strict].all()), "extension grid: an interior query was lost")
    check(not bool(found[outside].any()), "extension grid: outside query found")
    lin = float((vals[found].double() - (r[found].double().sum(1) + 1)).abs().max())
    check(lin <= LIN_TOL, f"extension grid linear-exactness error {lin}")
    print(f"B2 extension grid ({grid.n_cells} tets, K={k}, k_ext={k_ext}): "
          f"{sel.numel()} of {N_CMP} queries probed extension rows; "
          f"linear error {lin:.3e}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.ops import (
        _kernels,
        cand_kernel,
        interp_kernel,
        locate,
    )
    from interpolate_unstructured_tpu_torch.utils import meshgen

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = _kernels.build()
    _kernels.lib()
    print(f"set-up: kernels built and loaded in {time.perf_counter() - t0:.3f} s "
          f"({lib.name})")
    log = lib.with_name(lib.name + ".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(line.strip())

    args = (dev, tiu, meshgen, interp_kernel, locate, cand_kernel)
    b1 = bruteforce_phase(*args)
    b2 = candidate_phase(*args)

    pkg = "interpolate_unstructured_tpu_torch"
    kernels = [
        {"name": "B1 interp_bruteforce", "route": "cuda",
         "source": f"{pkg}/csrc/interp_bruteforce.cu",
         "replaces": "interpolate_unstructured_tpu/ops/pallas_interp.py:93",
         "launches": b1["launches"], "max_abs_err": b1["max_abs_err"],
         "ms": b1["ms"], "plain_ms": b1["plain_ms"]},
        {"name": "B2 cand_rows", "route": "cuda",
         "source": f"{pkg}/csrc/cand_rows.cu",
         "replaces": "interpolate_unstructured_tpu/ops/pallas_cand.py:64",
         "launches": b2["launches"], "max_abs_err": b2["max_abs_err"],
         "ms": b2["ms"], "plain_ms": b2["plain_ms"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
