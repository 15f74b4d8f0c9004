#!/usr/bin/env python3
"""Designs of kernel B2's extension-row probe timed against each other on
one GPU.

    python3 tools/cand_ext_sweep.py

Builds the port's kernel library and, beside it,
``tools/cand_ext_alternatives.cu`` (the direct kernel: one warp a query)
into ``build/kernels/libcand_ext_sweep.so`` (one nvcc process each,
started together).  Grids with extension rows: the 10,368-tet box of
``chip_smoke.py``'s candidate phase (``tet_box_mesh(12, 12, 12)``,
``cand_bins_per_cell=0.3``, ``cand_ext_max_k=256``,
``cand_cover_row_bytes=0``; 1M queries in [-0.05, 1.05]^3,
``default_rng(3)``), the io phase's rebuilt 998,250-tet box (float32,
``cand_cover_row_bytes=0``; the candidate phase's 10M cold queries,
``default_rng(2)``) and the float64 phase's 998,250-tet box (float64, K
= 7; 10M float64 cold queries, ``default_rng(2)``).

Designs of the whole probe (main rows, extension rows, merge), each
first held torch.equal to ``cand_kernel.probe_rows_ext_plain``, then
timed by CUDA events in turns (old, new, new, old), each from the bin
order (bin pass, scan and scatter, shared and outside the timing):

- old: the parent's composition: the probe in bin order of the main
  rows and the unsort, a host read of the overflow misses
  (``torch.nonzero(aux >= 0)``), their bin frame in torch, the direct
  kernel over them in query order, two merges;
- slot order (the alternative): the same with the misses taken in bin
  order (``perm`` filtered by their verdict), so that the queries of a
  bin probe its extension row one after the other;
- new: the probe in bin order with the extension probe in the same
  launch (the port's), then the unsort.

Then the probe kernels alone, without the unsort: the main rows' probe
against the fused one (the extension probe's added time), and the direct
kernel alone on the misses in query order and in slot order.  Prints the
card (nvidia-smi name and power limit) first, how many queries reached
the extension rows and how many a walk would take; exits non-zero
without a CUDA device or when a check fails.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 10_000_000  # cold queries on the 998k boxes
N_SMALL = 1_000_000  # on the 10,368-tet box
REPS = 10
_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double


def start_build():
    """Start nvcc on tools/cand_ext_alternatives.cu; returns (process,
    library path)."""
    from interpolate_unstructured_tpu_torch.ops import _kernels

    src = Path(__file__).with_name("cand_ext_alternatives.cu")
    out = _kernels.build_dir() / "libcand_ext_sweep.so"
    _kernels.build_dir().mkdir(parents=True, exist_ok=True)
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def finish_build(proc, out):
    """Wait for nvcc and load the library."""
    text = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on cand_ext_alternatives.cu:\n{text}")
    lib = ctypes.CDLL(str(out))
    for fn, s in ((lib.ext_direct, _F), (lib.ext_direct_f64, _D)):
        fn.restype = _I
        fn.argtypes = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, s, _I, _F,
                       _I, _P, _P, _P, _P, _P]
    return lib


def direct(lib, table, idx, rq, lay, eps, ovf_base, order=None):
    """One launch of the direct kernel: one warp a query, the row
    ``idx[q]`` of ``table`` for the query frame ``rq[q]``; warp i takes
    query ``order[i]`` (None: query i).  Returns (id, aux, values) at the
    queries' positions."""
    from interpolate_unstructured_tpu_torch.ops import _kernels, cand_kernel

    b = idx.shape[0]
    dev = table.device
    n_vars = len(lay.var_roles)
    vroles = cand_kernel._var_roles(lay.var_roles, dev)
    out = (torch.empty(b, dtype=torch.int32, device=dev),
           torch.empty(b, dtype=torch.int32, device=dev),
           torch.empty((b, n_vars), dtype=table.dtype, device=dev))
    fn = lib.ext_direct_f64 if table.dtype == torch.float64 else \
        lib.ext_direct
    code = fn(table.data_ptr(), table.shape[1], idx.data_ptr(),
              rq.data_ptr(), None if order is None else order.data_ptr(), b,
              lay.k, lay.nf, cand_kernel._KIND_CODE[lay.kind], lay.id_role,
              lay.count_col, float(eps), int(ovf_base), cand_kernel.QINV,
              n_vars, vroles.data_ptr(), *(o.data_ptr() for o in out),
              torch.cuda.current_stream().cuda_stream)
    _kernels.check(code, "ext_direct")
    return out


def merged(main, sel, ext_out):
    """The main probe's (id, aux, values) with the extension probe's
    results of the misses ``sel`` merged in: probe_rows_ext_plain's
    rule."""
    id_best, aux, vals = (t.clone() for t in main)
    id2, aux2, vals2 = ext_out
    found2 = aux2 == -2
    id_best[sel] = torch.where(found2, id2, id_best[sel])
    aux[sel] = aux2
    vals[sel] = torch.where(found2[:, None], vals2, vals[sel])
    return id_best, aux, vals


def sweep(label, grid, r, lib):
    """Check and time the designs on one grid's queries."""
    import chip_smoke
    from interpolate_unstructured_tpu_torch.ops import cand_kernel, locate

    slots = (0,) if grid.cand_nv else ()
    k = grid.cand_ids.shape[1]
    lay = locate._row_layout(grid, k, slots)
    lay_e = locate._row_layout(grid, grid.cand_ext_ids.shape[1], slots)
    ext_t = grid.cand_ext_table
    eps = locate._cand_eps(grid)
    bins = (grid.cand_rmin, grid.cand_inv_h, grid.cand_shape)
    chunk = locate._cand_chunk(grid)
    ovf_e = k + lay_e.k
    idx, rq = locate._cand_probe_inputs(grid, r)
    want = cand_kernel.probe_rows_ext_plain(grid.cand_table, ext_t, idx, rq,
                                            lay, lay_e, eps, k, chunk)
    _, _, perm, slot = cand_kernel.bin_order_cuda(r, *bins)

    def main_probe():
        return cand_kernel.cand_rows_binned_cuda(grid.cand_table, r, perm,
                                                 slot, *bins, lay, eps, k)

    def old():
        main = main_probe()
        sel = torch.nonzero(main[1] >= 0).squeeze(1)
        _, q = locate._cand_probe_inputs(grid, r[sel])
        return merged(main, sel, direct(lib, ext_t, main[1][sel].contiguous(),
                                        q, lay_e, eps, ovf_e))

    def in_slots():
        main = main_probe()
        p = perm.long()
        sel = p[main[1][p] >= 0]
        _, q = locate._cand_probe_inputs(grid, r[sel])
        return merged(main, sel, direct(lib, ext_t, main[1][sel].contiguous(),
                                        q, lay_e, eps, ovf_e))

    def new():
        return cand_kernel.cand_rows_binned_cuda(
            grid.cand_table, r, perm, slot, *bins, lay, eps, k,
            ext=(ext_t, lay_e))

    for name, fn in (("old", old), ("slot order", in_slots), ("new", new)):
        for part, a, b in zip(("id", "aux", "values"), fn(), want):
            chip_smoke.check(torch.equal(a, b), f"{label}, {name}: {part} "
                             "differs from probe_rows_ext_plain")
    main = main_probe()
    sel = torch.nonzero(main[1] >= 0).squeeze(1)
    n_ext = int(sel.numel())
    n_walk = int((want[1] >= 0).sum())
    print(f"{label}: {r.shape[0]} queries, K={k}, k_ext={lay_e.k}, "
          f"{ext_t.shape[0]} extension rows; {n_ext} queries reached them, "
          f"{n_walk} would walk; every design torch.equal to "
          f"probe_rows_ext_plain")
    t = chip_smoke.turns({"old": old, "new": new}, REPS)
    t2 = chip_smoke.turns({"slot order": in_slots, "new": new}, REPS)
    print(f"  whole probe, CUDA-event ms in turns (old, new, new, old): old "
          f"{t['old'][0]:.4f} / {t['old'][1]:.4f}, new {t['new'][0]:.4f} / "
          f"{t['new'][1]:.4f}; slot order {t2['slot order'][0]:.4f} / "
          f"{t2['slot order'][1]:.4f} against new {t2['new'][0]:.4f} / "
          f"{t2['new'][1]:.4f}")
    _, q = locate._cand_probe_inputs(grid, r[sel])
    a_idx = main[1][sel].contiguous()
    p = perm.long()
    in_bins = p[main[1][p] >= 0]
    pos = torch.empty(r.shape[0], dtype=torch.int64, device=r.device)
    pos[sel] = torch.arange(n_ext, device=r.device)
    order = pos[in_bins].to(torch.int32)
    k_t = chip_smoke.turns({
        "main": lambda: cand_kernel.cand_rows_binned_cuda(
            grid.cand_table, r, perm, slot, *bins, lay, eps, k),
        "fused": new}, REPS)
    d_t = chip_smoke.turns({
        "query order": lambda: direct(lib, ext_t, a_idx, q, lay_e, eps,
                                      ovf_e),
        "slot order": lambda: direct(lib, ext_t, a_idx, q, lay_e, eps,
                                     ovf_e, order)}, REPS)
    print(f"  probe and unsort in turns: main rows only {k_t['main'][0]:.4f} "
          f"/ {k_t['main'][1]:.4f}, with the extension probe "
          f"{k_t['fused'][0]:.4f} / {k_t['fused'][1]:.4f} ms; the direct "
          f"kernel alone on the {n_ext} misses: query order "
          f"{d_t['query order'][0]:.4f} / {d_t['query order'][1]:.4f}, slot "
          f"order {d_t['slot order'][0]:.4f} / {d_t['slot order'][1]:.4f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("cand_ext_sweep: torch.cuda.is_available() is false; this "
              "script needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.ops import _kernels
    from interpolate_unstructured_tpu_torch.utils import meshgen

    print(f"card: {chip_smoke.card_line()}")
    proc, out = start_build()
    _kernels.build()
    lib = finish_build(proc, out)
    dev = torch.device("cuda", 0)

    pts, cells, nbrs = meshgen.tet_box_mesh(12, 12, 12)
    grid = tiu.build_grid(
        pts, cells, nbrs, "tetra", point_data={"Polynomial": pts.sum(1) + 1.0},
        dtype=torch.float32, device=dev,
        config=tiu.IUConfig(cand_bins_per_cell=0.3, cand_ext_max_k=256,
                            cand_cover_row_bytes=0))
    r = torch.from_numpy((np.random.default_rng(3).random((N_SMALL, 3)) * 1.1
                          - 0.05).astype(np.float32)).to(dev)
    sweep("10,368-tet forced-extension box, float32", grid, r, lib)

    pts, cells, nbrs = meshgen.tet_box_mesh(55, 55, 55)
    pd = {"Polynomial": pts.sum(1) + 1.0}
    r64 = np.random.default_rng(2).random((N, 3))
    for dtype, cfg in ((torch.float32, tiu.IUConfig(cand_cover_row_bytes=0)),
                       (torch.float64, tiu.IUConfig())):
        t0 = time.perf_counter()
        grid = tiu.build_grid(pts, cells, nbrs, "tetra", point_data=pd,
                              dtype=dtype, locate_mode="walk", config=cfg,
                              device=dev)
        chip_smoke.check(grid.cand_ext_table is not None,
                         f"the {dtype} box has no extension rows")
        print(f"998,250-tet box, {dtype}, built in "
              f"{time.perf_counter() - t0:.3f} s")
        r = torch.from_numpy(r64).to(dev).to(dtype)
        sweep(f"998,250-tet box, {dtype}, 10M cold", grid, r, lib)
        del grid, r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
