#!/usr/bin/env python3
"""Designs of B3's explicit walk (``walk_rows``) timed against each other
on one GPU.

    python3 tools/walk_rows_sweep.py

Builds the port's kernel library and, beside it,
``tools/walk_rows_alternatives.cu`` (the earlier design: the direction
from torch, ``walk_kernel.walk_direction``, then one thread a walk, 128
threads a block, the row read as separate 4-byte loads; and four lanes a
walk, each lane one face's distance, the round's best two faces merged
by shuffles) into ``build/kernels/libwalk_rows_sweep.so`` (one nvcc
process each, started together). Inputs: the 998,250-tet box of
``chip_smoke.py`` (``tet_box_mesh(55, 55, 55)``, coordinates rounded to
float32 as the smoke's walk grid reads them from a .vtu, no candidate
tables), float32 and float64, with the walk phase's warm walks
(``default_rng(4)``: r = 0.1 + 0.8 * uniform, the warm targets r + 0.01
* uniform, each walk from the center of the cell the cold ``get_cell``
found for r); and, in float32, the generic trace's first walk of 1024
helix lines (the trace phase's field and seeds, ``default_rng(3)``, over
the trace table). Batches: 1024, 65,536 and 10M warm walks (the first
n), and the trace's 1024.

Designs, each first held torch.equal to ``walk_rows_plain`` on the
batch: the parent's kernel alone (direction tensors made once) and with
its torch direction ops, as ``walk()`` ran it; the port's kernel (one
thread a walk) at 32, 64, 128 and 256 threads a block; four lanes a walk
at 64, 128 and 256 threads a block.  Up to 65,536 walks each launch is
timed by the profiler's device time (``chip_smoke.kernel_ms``: a launch
of a few microseconds is shorter than what CUDA events around it see),
above by CUDA events; all designs in order, then in reverse, and the
parent with its direction ops against the port's kernel at
``walk_threads``' block size in turns (old, new, new, old).  Prints the
card (nvidia-smi name and power limit) first and ptxas's registers of
each walk kernel; exits non-zero without a CUDA
device or when a check fails.
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

N = 10_000_000  # warm walks, as on the smoke's walk phase
SIZES = (1024, 65_536, N)
SHAPES = [(1, 32), (1, 64), (1, 128), (1, 256), (4, 64), (4, 128), (4, 256)]
# (lanes a walk, threads a block): 1 the port's kernel, 4 the alternative
SMALL = 65_536  # up to this many walks, profiler device time
_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double


def start_build():
    """Start nvcc on tools/walk_rows_alternatives.cu; returns (process,
    library path)."""
    from interpolate_unstructured_tpu_torch.ops import _kernels

    src = Path(__file__).with_name("walk_rows_alternatives.cu")
    out = _kernels.BUILD_DIR / "libwalk_rows_sweep.so"
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def finish_build(proc, out):
    """Wait for nvcc, print the parent kernel's registers, load."""
    text = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on walk_rows_alternatives.cu:\n{text}")
    registers(text, "parent")
    lib = ctypes.CDLL(str(out))
    for fn, s in ((lib.walk_parent, _F), (lib.walk_parent_f64, _D)):
        fn.restype = _I
        fn.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, s, s, s,
                       _I, _P, _P, _P, _P, _P]
    for fn, s in ((lib.walk_lanes, _F), (lib.walk_lanes_f64, _D)):
        fn.restype = _I
        fn.argtypes = [_P, _I, _I, _I, _P, _P, _P, _I, s, s, s, s, _I, _I,
                       _P, _P, _P, _P, _P]
    return lib


def registers(text, label):
    """Print ptxas's registers and spills of the walk kernels in an nvcc
    -Xptxas -v report."""
    name = None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill" in line) and (
                "walk_kernel" in name or "walk_lanes_kernel" in name) and (
                "get_cell" not in name):
            print(f"ptxas {label} {name}: {line.split(': ', 1)[-1].strip()}")


def parent(lib, args, dirs):
    """One launch of the parent's kernel on walk_rows' arguments, with
    the direction tensors ``dirs`` = (u, total, active)."""
    from interpolate_unstructured_tpu_torch.ops import _kernels

    table, r0, _, ic0, nudge, eps_a, big, _, max_steps, nf = args
    u, total, active = dirs
    b = r0.shape[0]
    dev = r0.device
    out = (torch.empty(b, dtype=torch.int32, device=dev),
           torch.empty((b, 3), dtype=table.dtype, device=dev),
           torch.empty(b, dtype=torch.int32, device=dev),
           torch.empty(b, dtype=torch.int32, device=dev))
    fn = lib.walk_parent_f64 if table.dtype == torch.float64 else \
        lib.walk_parent
    code = fn(table.data_ptr(), table.shape[0], table.shape[1], nf,
              r0.data_ptr(), u.data_ptr(), total.data_ptr(),
              active.data_ptr(), ic0.data_ptr(), None, b, nudge, eps_a, big,
              max_steps, *(o.data_ptr() for o in out),
              torch.cuda.current_stream().cuda_stream)
    _kernels.check(code, "walk_parent")
    return out


def lanes4(lib, args, threads):
    """One launch of the four-lane alternative on walk_rows' arguments."""
    from interpolate_unstructured_tpu_torch.ops import _kernels

    table, r0, r1, ic0, nudge, eps_a, big, tiny, max_steps, nf = args
    b = r0.shape[0]
    dev = r0.device
    out = (torch.empty(b, dtype=torch.int32, device=dev),
           torch.empty((b, 3), dtype=table.dtype, device=dev),
           torch.empty(b, dtype=torch.int32, device=dev),
           torch.empty(b, dtype=torch.int32, device=dev))
    fn = lib.walk_lanes_f64 if table.dtype == torch.float64 else \
        lib.walk_lanes
    code = fn(table.data_ptr(), table.shape[0], table.shape[1], nf,
              r0.data_ptr(), r1.data_ptr(), ic0.data_ptr(), b, nudge, eps_a,
              big, tiny, max_steps, threads, *(o.data_ptr() for o in out),
              torch.cuda.current_stream().cuda_stream)
    _kernels.check(code, "walk_lanes")
    return out


def timer(n):
    """ms of one call of a design: the profiler's device time of its
    kernels at small batches (None where it records nothing), CUDA
    events above."""
    import chip_smoke

    def ms(fn):
        if n > SMALL:
            return chip_smoke.cuda_ms(fn, 10)
        return chip_smoke.kernel_ms(fn, "walk", 20)[0]

    return ms


def fmt(v):
    return "not measured" if v is None else f"{v:.4f}"


def sweep(label, args, lib):
    """Check and time every design on one batch of walk_rows arguments."""
    import chip_smoke
    from interpolate_unstructured_tpu_torch.ops import walk_kernel

    n = args[1].shape[0]
    want = walk_kernel.walk_rows_plain(*args)
    dirs = walk_kernel.walk_direction(args[1], args[2], args[7])
    for name, a, b in zip(("ic", "r_p", "steps", "status"),
                          parent(lib, args, dirs), want):
        chip_smoke.check(torch.equal(a, b), f"{label}: the parent's {name} "
                         "differs from walk_rows_plain")
    designs = {"parent": lambda: parent(lib, args, dirs),
               "parent+dir": lambda: parent(
                   lib, args, walk_kernel.walk_direction(args[1], args[2],
                                                         args[7]))}
    for lanes, threads in SHAPES:
        if lanes == 1:
            def fn(threads=threads):
                return walk_kernel.walk_cuda(*args, threads=threads)
        else:
            def fn(threads=threads):
                return lanes4(lib, args, threads)
        for name, a, b in zip(("ic", "r_p", "steps", "status"), fn(), want):
            chip_smoke.check(torch.equal(a, b), f"{label}: {lanes} lanes, "
                             f"{threads} threads: {name} differs from "
                             "walk_rows_plain")
        designs[f"{lanes}x{threads}"] = fn
    steps = want[2]
    print(f"{label}: {n} walks, {float(steps.float().mean()):.4f} steps a "
          f"walk, max {int(steps.max())}; every design torch.equal to "
          f"walk_rows_plain")
    ms = timer(n)
    names = list(designs)
    t = {k: [] for k in names}
    for k in names + names[::-1]:
        t[k].append(ms(designs[k]))
    how = "profiler device ms" if n <= SMALL else "CUDA-event ms"
    print(f"  {how} a call, in order / in reverse: " + "; ".join(
        f"{k} {fmt(t[k][0])} / {fmt(t[k][1])}" for k in names))
    key = f"1x{walk_kernel.walk_threads(n)}"
    tt = {"old": [], "new": []}
    for k in ("old", "new", "new", "old"):
        tt[k].append(ms(designs["parent+dir" if k == "old" else key]))
    print(f"  in turns (old, new, new, old): parent with its direction ops "
          f"{fmt(tt['old'][0])} / {fmt(tt['old'][1])}, walk_threads' "
          f"{key} {fmt(tt['new'][0])} / {fmt(tt['new'][1])}")
    return t, tt


def main() -> int:
    if not torch.cuda.is_available():
        print("walk_rows_sweep: torch.cuda.is_available() is false; this "
              "script needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.ops import (
        _kernels,
        locate,
        trace_kernel,
        walk_kernel,
    )
    from interpolate_unstructured_tpu_torch.utils import meshgen

    print(f"card: {chip_smoke.card_line()}")
    proc, out = start_build()
    _kernels.build()
    registers(_kernels.library_path().with_name(
        _kernels.library_path().name + ".log").read_text(), "port")
    lib = finish_build(proc, out)
    dev = torch.device("cuda", 0)

    pts, cells, nbrs = meshgen.tet_box_mesh(55, 55, 55)
    pts32 = pts.astype(np.float32).astype(np.float64)
    rng = np.random.default_rng(4)
    r = 0.1 + 0.8 * rng.random((N, 3))
    r_warm = r + 0.01 * rng.random((N, 3))
    cfg = tiu.IUConfig(use_candidate_bins=False)
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        grid = tiu.build_grid(pts32, cells, nbrs, "tetra",
                              point_data={"Polynomial": pts32.sum(1) + 1.0},
                              dtype=dtype, locate_mode="walk", config=cfg,
                              device=dev)
        rq = torch.from_numpy(r.astype(np.float32)).to(dev).to(dtype)
        rw = torch.from_numpy(r_warm.astype(np.float32)).to(dev).to(dtype)
        ic, found = tiu.get_cell(grid, rq)
        chip_smoke.check(bool(found.all()), "a cold query was not found")
        r0 = walk_kernel.walk_origin(grid.walk_table, ic, 4, 4)
        print(f"{dtype}: box built and located in "
              f"{time.perf_counter() - t0:.3f} s")
        for n in SIZES:
            sweep(f"{dtype} warm walks", locate._walk_args(
                grid, r0[:n], rw[:n], ic[:n]), lib)
        if dtype == torch.float32:
            c = grid.points[:, :2] - 0.5
            fld = (-c[:, 1], c[:, 0], torch.full_like(c[:, 0], 0.25))
            i_field = []
            for name, v in zip(("vx", "vy", "vz"), fld):
                grid, i = tiu.add_point_data(grid, name, v, fuse=False)
                i_field.append(i)
            y0 = torch.from_numpy(0.3 + 0.4 * np.random.default_rng(3).random(
                (1024, 3))).to(dev).float()
            walks = {}
            with chip_smoke.generic_trace(trace_kernel), \
                    chip_smoke.recorded_calls(walk_kernel, "walk_rows", walks):
                tiu.integrate_along_field(grid, y0, i_field,
                                          **chip_smoke.TRACE_KW)
            args, _ = walks["inputs"][0]
            chip_smoke.check(len(args) == 10 or args[10] is None,
                             "the generic trace walked with a mask")
            sweep("float32 generic trace, first walk (trace table)",
                  tuple(args[:10]), lib)
        del grid, rq, rw, ic, found, r0
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
