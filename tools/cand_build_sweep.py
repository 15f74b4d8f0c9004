#!/usr/bin/env python3
"""Designs of kernels D1 and D2 (the device candidate builder) timed
against each other on one GPU.

    python3 tools/cand_build_sweep.py

Builds the port's kernel library and, beside it,
``tools/cand_build_alternatives.cu`` (one nvcc process each, started
together), whose entry points launch, on float32 tets:

- D1's count pass and write pass with 3 offset groups along y (the
  first design: every cell's first group, then every cell's second,
  ...), 8 along y, 3 and 64 along x (a cell's groups in neighbouring
  blocks: the cells swept once, in order; the port takes 3 for the
  count pass and 64, one offset a thread, for the write pass), and 3
  along y with warp-aggregated atomics (``__match_any_sync``: one
  atomicAdd a bin a warp);
- the write pass's halves alone at one offset a thread: its atomics
  (no record stored), and its stores (each record at a position inside
  its bucket picked from its slot, no atomic);
- D2's warp route one warp a bin, (a) by a bitonic sort of the bucket
  across the lanes (the first design) and (b) by counting each record's
  rank over its bucket, against the port's (counting, one warp for 32
  consecutive bins, the next bin's records loading while a bin is
  ranked).

Inputs: the 998,250-tet box of ``chip_smoke.py`` (``tet_box_mesh(55, 55,
55)``) with the port's default config, its prelude on the card.  Every
design is first held to the port's kernels on the same inputs (the
counts torch.equal, the records torch.equal after canonical ordering
inside each bucket, the tables torch.equal), then all are timed by CUDA
events in order and then in reverse (10 launches a turn; a write pass
includes the copy of the bins' first positions it consumes).  Prints the
card (nvidia-smi name and power limit) first; exits non-zero without a
CUDA device or when a check fails.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPS = 10  # launches a turn
# D1 designs: (offset groups, groups along x, aggregated atomics)
D1_DESIGNS = ((3, False, False), (8, False, False), (3, True, False),
              (64, True, False), (3, False, True))
_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_DP = ctypes.POINTER(ctypes.c_double)


def start_build():
    """Start nvcc on tools/cand_build_alternatives.cu; returns (process,
    library path)."""
    from interpolate_unstructured_tpu_torch.ops import _kernels

    src = Path(__file__).with_name("cand_build_alternatives.cu")
    out = _kernels.build_dir() / "libcand_build_sweep.so"
    _kernels.build_dir().mkdir(parents=True, exist_ok=True)
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def finish_build(proc, out):
    """Wait for nvcc, print the registers of each design, load."""
    text = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on cand_build_alternatives.cu:\n"
                           f"{text}")
    for line in text.splitlines():
        if "Compiling entry" in line and "alt_" in line or "registers" in line:
            print(line.strip())
    lib = ctypes.CDLL(str(out))
    lib.alt_cand_bin.restype = _I
    lib.alt_cand_bin.argtypes = [_P, _P, _P, _P, _I, _IP, _I, _I, _DP, _I,
                                 _I, _I, _I, _I, _P, _P, _P]
    lib.alt_half_write.restype = _I
    lib.alt_half_write.argtypes = [_P, _P, _P, _P, _I, _IP, _I, _I, _DP, _I,
                                   _P, _P, _P, _P]
    lib.alt_cand_order.restype = _I
    lib.alt_cand_order.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                   _P, _I, _P]
    return lib


def ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"cand_build_sweep check failed: {msg}")


def main() -> int:
    if not torch.cuda.is_available():
        print("cand_build_sweep: no CUDA device", file=sys.stderr)
        return 1
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.ops import _kernels, cand_build
    from interpolate_unstructured_tpu_torch.ops import cand_build_kernel as bk
    from interpolate_unstructured_tpu_torch.ops import geometry
    from interpolate_unstructured_tpu_torch.utils import meshgen

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    proc, out = start_build()
    _kernels.lib()
    alt = finish_build(proc, out)
    dev = torch.device("cuda", 0)

    pts, cells, nbrs = meshgen.tet_box_mesh(55, 55, 55)
    cp = geometry.gather_cell_points(pts, cells)
    normals, _ = geometry.face_normals_and_boundary(cp, cells, nbrs, "tetra",
                                                    len(pts))
    offs = np.einsum("cki,cki->ck", cp, normals)
    cfg = tiu.IUConfig()
    p, *_ = cand_build.prepare_pairs(
        cp, normals, offs, pts.min(0), pts.max(0), 3, torch.float32,
        cfg.cand_bins_per_cell, cfg.cand_max_bins, 2.0 * cfg.eps_inside, dev)
    c = p.offs.shape[0]
    counts = bk.count_pairs_cuda(p)
    start = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    n_kept, max_count = int(counts.sum()), int(counts.max())
    rec = bk.write_pairs_cuda(p, start, n_kept)
    keys = torch.repeat_interleave(torch.arange(p.n_bins, device=dev),
                                   counts.long())
    canon = rec[cand_build.bucket_order(keys, rec)]
    k = 24
    slot = cand_build.ext_slots(counts, k)
    tables = bk.order_tables_cuda(rec, start, counts, slot, c, k, 0, 0,
                                  max_count)
    print(f"998,250-tet box: bins {p.bin_shape}, {p.n_offsets} offsets, "
          f"{n_kept} kept pairs, worst bin {max_count}, K={k}")

    smax = (ctypes.c_int * 3)(*p.smax)
    frame = (ctypes.c_double * 11)(*p.half, *p.rmin, *p.h, p.eps, p.zc)
    _, nby, nbz = p.bin_shape
    stream = torch.cuda.current_stream(dev).cuda_stream

    def d1(write, aggregate, swap, groups):
        if write:
            counter = start.clone()
            out = torch.empty(n_kept, dtype=torch.int64, device=dev)
        else:
            counter = torch.zeros(p.n_bins, dtype=torch.int32, device=dev)
            out = None
        code = alt.alt_cand_bin(
            p.normals.data_ptr(), p.offs.data_ptr(), p.b0.data_ptr(),
            p.span.data_ptr(), c, smax, nby, nbz, frame, 0, int(write),
            int(aggregate), int(swap), groups, counter.data_ptr(),
            0 if out is None else out.data_ptr(), stream)
        check(code == 0, f"alt_cand_bin returned {code}")
        return out if write else counter

    def d2(bitonic):
        ids = torch.empty((p.n_bins, k), dtype=torch.int32, device=dev)
        ext = torch.empty((0, 0), dtype=torch.int32, device=dev)
        code = alt.alt_cand_order(
            rec.data_ptr(), start.data_ptr(), counts.data_ptr(),
            slot.data_ptr(), p.n_bins, c, k, 0, max_count, ids.data_ptr(),
            ext.data_ptr(), int(bitonic), stream)
        check(code == 0, f"alt_cand_order returned {code}")
        return ids

    designs = {
        "count pass, port's kernel": lambda: bk.count_pairs_cuda(p),
        "write pass, port's kernel":
            lambda: bk.write_pairs_cuda(p, start, n_kept),
    }
    for write in (False, True):
        for g, swap, aggregate in D1_DESIGNS:
            name = (f"{'write' if write else 'count'} pass, {g} groups "
                    f"along {'x' if swap else 'y'}"
                    f"{', aggregated' if aggregate else ''}")
            designs[name] = (
                lambda w=write, a=aggregate, s=swap, g=g: d1(w, a, s, g))
            got = designs[name]()
            if write:
                check(torch.equal(got[cand_build.bucket_order(keys, got)],
                                  canon), f"{name}: records differ")
            else:
                check(torch.equal(got, counts), f"{name}: counts differ")
    def half(mode):
        counter = start.clone()
        out = torch.empty(n_kept, dtype=torch.int64, device=dev)
        code = alt.alt_half_write(
            p.normals.data_ptr(), p.offs.data_ptr(), p.b0.data_ptr(),
            p.span.data_ptr(), c, smax, nby, nbz, frame, mode,
            counts.data_ptr(), counter.data_ptr(), out.data_ptr(), stream)
        check(code == 0, f"alt_half_write returned {code}")
        return counter

    check(torch.equal(half(1), start + counts), "the atomics alone differ")
    designs["write pass's atomics alone, 64 groups along x"] = lambda: half(1)
    designs["write pass's stores alone, 64 groups along x"] = lambda: half(2)
    designs["D2, port's kernel"] = lambda: bk.order_tables_cuda(
        rec, start, counts, slot, c, k, 0, 0, max_count)
    designs["D2, (a) bitonic, a warp a bin"] = lambda: d2(True)
    designs["D2, (b) counting, a warp a bin"] = lambda: d2(False)
    for bitonic in (True, False):
        check(torch.equal(d2(bitonic), tables[0]),
              f"D2 {'(a)' if bitonic else '(b)'}: the tables differ")
    print("every design equal to the port's kernels on the same inputs")

    names = list(designs)
    fwd = {x: ms(designs[x]) for x in names}
    rev = {x: ms(designs[x]) for x in reversed(names)}
    print(f"CUDA events, in order then in reverse [{card}]:")
    for x in names:
        print(f"  {x}: {fwd[x]:.4f} / {rev[x]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
