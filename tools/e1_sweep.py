#!/usr/bin/env python3
"""Designs of kernel E1 (``interpolate_at_icell`` on the card) timed
against each other on one GPU.

    python3 tools/e1_sweep.py

Builds the port's kernel library and, beside it, ``tools/e1_alternatives.cu``
(one nvcc process each, started together), whose entry points launch, on
tetrahedra with one variable:

- the port's kernel (``csrc/interp_icell.cu``, included there) at 1, 2
  and 4 queries a thread and 128 and 256 threads a block;
- (a) the port's first design, the geometry from the cell's 512-byte
  walk row;
- (c) the vertices from the ``cell_points`` rows in place of ``points``;
- (d) the port's reading order with plain loads in place of
  ``ld.global.nc``;
- (e) the port's reading order with each vertex's coordinates in a pair
  load and a single load;
- (f) the port's reading order with the queries, cell ids and values
  read and written with evict-first hints (``ld.global.cs`` /
  ``st.global.cs``).

Inputs: the 998,250-tet box of ``chip_smoke.py`` (``tet_box_mesh(55, 55,
55)``, no candidate tables), float32 from its coordinates rounded to
float32 as the smoke's walk grid reads them from a .vtu, with the walk
phase's 10M warm queries (``default_rng(4)``: 0.1 + 0.8 * uniform, moved
by 0.01 * uniform) in the cells the warm ``get_cell`` finds; float64
with the float64 phase's 10M uniform cold queries (``default_rng(2)``)
in the cells the cold ``get_cell`` finds.  Then the 6,000,000-tet box
(``tet_box_mesh(100, 100, 100)``, 1,030,301 points, no candidate
tables), whose connectivity alone (96 MB) leaves the 50 MB L2, in both
dtypes, with the warm protocol's 10M queries, every design again.

Every design is first held torch.equal to ``interpolate_at_icell_plain``
on the same inputs, then all are timed by CUDA events in order and then
in reverse (10 launches a turn), and the port's kernel and (a) again in
turns old, new, new, old.  Prints the card (nvidia-smi name and power
limit) first and ptxas's registers and spills of each E1 design; exits
non-zero without a CUDA device or when a check fails.
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

N = 10_000_000  # queries a call, as on the smoke's main path
REPS = 10  # launches a turn
SETTINGS = [(q, t) for q in (1, 2, 4) for t in (128, 256)]
ALTERNATIVES = {1: "(a) walk rows", 2: "(c) cell_points rows",
                3: "(d) plain loads", 4: "(e) pair + single loads",
                5: "(f) evict-first streams"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _I, _P, _P]


def start_build():
    """Start nvcc on tools/e1_alternatives.cu; returns (process, library
    path)."""
    from interpolate_unstructured_tpu_torch.ops import _kernels

    src = Path(__file__).with_name("e1_alternatives.cu")
    out = _kernels.build_dir() / "libe1_sweep.so"
    _kernels.build_dir().mkdir(parents=True, exist_ok=True)
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def finish_build(proc, out):
    """Wait for nvcc, print the registers of each E1 design, load."""
    text = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on e1_alternatives.cu:\n{text}")
    name = None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill" in line) and any(
                k in name for k in ("icell_kernel", "walk_row", "alt_kernel")):
            print(f"ptxas {name}: {line.split(': ', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(out))
    for fn in (lib.e1_sweep, lib.e1_sweep_f64):
        fn.restype, fn.argtypes = _I, _ARGS
    return lib


def alternative(lib, grid, r, ic, variant, q=1, threads=256):
    """One launch of a design of tools/e1_alternatives.cu on (B, 3)
    queries and int32 cells: (B, 1) values of point-data column 0."""
    from interpolate_unstructured_tpu_torch.ops import _kernels

    f64 = grid.dtype == torch.float64
    geo, width = None, 0
    if variant == 1:
        wt = grid.walk_table
        geo = wt.data_ptr() + grid.n_faces_per_cell * 5 * wt.element_size()
        width = wt.shape[1]
    elif variant == 2:
        geo, width = grid.cell_points.data_ptr(), 12
    vals = torch.empty((r.shape[0], 1), dtype=grid.dtype, device=r.device)
    pd = grid.point_data
    code = (lib.e1_sweep_f64 if f64 else lib.e1_sweep)(
        variant, q, threads, grid.points.data_ptr(), grid.cells.data_ptr(),
        grid.cell_volume.data_ptr(), geo, width, grid.n_cells, pd.data_ptr(),
        pd.stride(0), 0, r.data_ptr(), ic.data_ptr(), r.shape[0],
        vals.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _kernels.check(code, f"e1_sweep variant {variant}")
    return vals


def designs(lib, grid, r, ic):
    """name -> callable of every design timed on these inputs."""
    from interpolate_unstructured_tpu_torch.ops import icell_kernel

    out = {"port's kernel (b)": lambda: icell_kernel.interpolate_at_icell_cuda(
        grid, r, (0,), ic)}
    for q, t in SETTINGS:
        out[f"(b) {q} a thread, {t} a block"] = (
            lambda q=q, t=t: alternative(lib, grid, r, ic, 0, q, t))
    for v in ALTERNATIVES:
        out[ALTERNATIVES[v]] = lambda v=v: alternative(lib, grid, r, ic, v)
    return out


def table_mb(grid):
    """MB of the tables the port's kernel reads (one point-data column)."""
    e = grid.points.element_size()
    return (grid.cells.numel() * 4 + grid.n_cells * e
            + grid.points.numel() * e + grid.points.shape[0] * e) / 1e6


def run(label, lib, grid, r, ic, chip_smoke):
    from interpolate_unstructured_tpu_torch.ops.interp import (
        interpolate_at_icell_plain,
    )

    ic = ic.to(torch.int32).contiguous()
    want = interpolate_at_icell_plain(grid, r, (0,), ic)
    fns = designs(lib, grid, r, ic)
    for name, fn in fns.items():
        chip_smoke.check(torch.equal(fn(), want), f"{label}: {name} differs "
                         "from interpolate_at_icell_plain")
    del want
    cells = torch.unique(ic)
    n_points = int(torch.unique(grid.cells[cells.long()]).numel())
    wt = grid.walk_table
    print(f"{label}: {r.shape[0]} queries in {int(cells.numel())} distinct "
          f"cells, {n_points} distinct vertices; tables the port's kernel "
          f"reads {table_mb(grid):.1f} MB, walk rows "
          f"{wt.numel() * wt.element_size() / 1e6:.1f} MB; every design "
          "torch.equal to interpolate_at_icell_plain")
    t = chip_smoke.turns(fns, REPS)
    print(f"{label}, CUDA events, in order then in reverse: "
          + "; ".join(f"{n} {v[0]:.4f} / {v[1]:.4f} ms" for n, v in t.items()))
    old, new = ALTERNATIVES[1], "port's kernel (b)"
    t = chip_smoke.turns({"old": fns[old], "new": fns[new]}, REPS)
    print(f"{label}, in turns old, new, new, old: {old} {t['old'][0]:.4f} / "
          f"{t['old'][1]:.4f} ms, {new} {t['new'][0]:.4f} / "
          f"{t['new'][1]:.4f} ms")


def warm_inputs(tiu, grid, dev):
    """The walk phase's 10M warm queries and the cells get_cell finds."""
    rng = np.random.default_rng(4)
    dt = grid.dtype
    r = torch.from_numpy(0.1 + 0.8 * rng.random((N, 3))).to(dev, dt)
    r_warm = r + 0.01 * torch.from_numpy(rng.random((N, 3))).to(dev, dt)
    ic, found = tiu.get_cell(grid, r)
    ic, found_w = tiu.get_cell(grid, r_warm, ic)
    assert bool(found.all()) and bool(found_w.all())
    return r_warm, ic


def main() -> int:
    if not torch.cuda.is_available():
        print("e1_sweep: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.ops import _kernels
    from interpolate_unstructured_tpu_torch.utils import meshgen

    print(f"card: {chip_smoke.card_line()}")
    proc, out = start_build()
    _kernels.lib()
    lib = finish_build(proc, out)
    props = torch.cuda.get_device_properties(0)
    print(f"L2: {getattr(props, 'L2_cache_size', 0) / 1e6:.1f} MB")
    dev = torch.device("cuda", 0)
    walk = tiu.IUConfig(use_candidate_bins=False)

    pts, cells, nbrs = meshgen.tet_box_mesh(55, 55, 55)
    for dt in (torch.float32, torch.float64):
        p = chip_smoke.vtu_rounded(pts) if dt == torch.float32 else pts
        t0 = time.perf_counter()
        grid = tiu.build_grid(p, cells, nbrs, "tetra", dtype=dt,
                              point_data={"Polynomial": p.sum(1) + 1.0},
                              locate_mode="walk", config=walk, device=dev)
        build_s = time.perf_counter() - t0
        if dt == torch.float32:
            r, ic = warm_inputs(tiu, grid, dev)
            what = "10M warm"
        else:
            r = torch.from_numpy(np.random.default_rng(2).random(
                (N, 3))).to(dev)
            ic, found = tiu.get_cell(grid, r)
            assert bool(found.all())
            what = "10M cold"
        run(f"998,250-tet box, {str(dt)[6:]}, {what} (built in "
            f"{build_s:.1f} s)", lib, grid, r, ic, chip_smoke)
        del grid, r, ic
        torch.cuda.empty_cache()

    pts, cells, nbrs = meshgen.tet_box_mesh(100, 100, 100)
    for dt in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        grid = tiu.build_grid(pts, cells, nbrs, "tetra", dtype=dt,
                              point_data={"Polynomial": pts.sum(1) + 1.0},
                              locate_mode="walk", config=walk, device=dev)
        build_s = time.perf_counter() - t0
        r, ic = warm_inputs(tiu, grid, dev)
        run(f"6,000,000-tet box, {str(dt)[6:]}, 10M warm (built in "
            f"{build_s:.1f} s)", lib, grid, r, ic, chip_smoke)
        del grid, r, ic
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
