#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives the cold and warm paths, accurate mode, the tracer, mesh files
and grid checkpoints of ``interpolate_unstructured_tpu_torch`` on the
card through its public entry points (``build_grid``, ``read_grid``,
``save_grid``, ``load_grid``, ``interpolate_scalar_at`` with and without
a guess, ``prepare_accurate``, ``interpolate_at_acc``,
``interpolate_at_icell_acc``, ``add_point_data``,
``integrate_along_field``, ``write_trace_vtk``, and
``parallel/sharding.py``'s ``make_mesh``, ``shard_batch``,
``distribute_queries``, the ``sharded_*`` functions and
``collect_results``), on float32 grids and then on float64 ones:

1. builds the CUDA kernels from ``interpolate_unstructured_tpu_torch/csrc``
   into ``build/kernels/`` (set-up time; one nvcc process per source,
   started together);
2. brute-force phase: the 8-triangle mesh of the reference's
   benchmark.f90, an 8x8 quad mesh and a 750-tet box, 1M cold queries
   inside the bounding box plus 1% outside it (kernel B1; its ids, found
   masks and values, and the main path's, torch.equal to the plain
   version on each mesh; ``tools/b1_b5_sweep.py`` sweeps B1's queries a
   thread and threads a block, and B5's threads a block);
3. candidate phase: the 998,250-tet box of ``bench.py``, built with its
   candidate lists on the card (the prelude's float64 AABBs on the card,
   kernel D1's count pass, a scan, D1's write pass into each bin's
   bucket, kernel D2 ordering each bucket into the tables; each stage
   torch.equal to its plain version on the build's own inputs, the write
   pass after canonical ordering inside each bucket, and to the grid's
   lists; the prelude's steps, each stage and the chain timed beside
   their bounds, the builder's peak memory, and a profiled build that
   launches no sort), 10M uniform cold
   queries (kernel B2 in bin order: bin pass, scatter, probe, unsort),
   then 10M warm queries guessed by the cold cells plus 1% outside the
   box (B2, then B3's get_cell walk on the misses), and a 10,368-tet box
   whose bins overflow into an extension table (B2's probe in bin order
   with the extension probe in the same launch, torch.equal to
   ``probe_rows_ext_plain``, timed in turns against the main rows' probe
   alone); each B2 kernel timed, the probe at the lanes a query that
   ``binned_lanes`` picks and at its neighbour (``tools/b2_sweep.py``
   sweeps lanes and batch sizes, ``tools/cand_ext_sweep.py`` the
   extension probe's designs);
   then the builder phase: a 105,456-tet box just above
   ``cand_build_device_min_cells``, built by ``"auto"`` on the card, whose
   every host-builder pair lies in its bin's device list (D1 and D2 held
   to their plain versions there, as on the io phase's rebuild and the
   float64 box); a heavy-bin soup (34,992 small tets inside one bin of a
   6,000-tet box: D2's route past shared memory) built on the card,
   every stage torch.equal to its plain version; a strongly
   graded mesh that "auto" hands to the host builder and
   ``cand_build="device"`` refuses;
4. io phase: the brute-force meshes written with the port's
   ``write_vtu`` and read back by ``read_grid`` (every leaf against
   ``build_grid`` of the arrays, B1's results torch.equal); the
   candidate phase's grid through ``save_grid`` and ``load_grid`` onto
   the card (no candidate-list rebuild, every leaf bit for bit, the 10M
   cold queries torch.equal, ``prepare_accurate`` of the loaded grid and
   the accurate phase's 10M float64 queries cold and warm torch.equal);
   a ``load_grid`` of the same file whose rebuild (no cover rows, so
   another K) runs through D1 and D2, its lists equal to ``build_grid``'s
   with the same config;
   the 55^3 box written as a .vtu, converted by ``convert_to_binda`` and
   read by ``read_grid`` without candidate tables (every leaf against
   ``build_grid`` of the arrays), the walk and trace phases' grid.  The
   .vtu stores coordinates as Float32, as the reference's writer does,
   so the arrays are meshgen's points rounded to float32;
5. sharded phase, ``parallel/sharding.py`` in the io phase's temporary
   directory: ``sharded_interpolate_at`` in this process on two shards
   of the card for the 750-tet brute-force mesh (B1), and on
   ``make_mesh()`` and two shards for the 998k box's 10M cold and 10.1M
   warm queries (the warm guesses the collected cold cells), each
   torch.equal to the single-device call; then spawned ranks, two over
   gloo on the card (6M and 4M of each batch) and one a card over NCCL,
   each loading the io phase's ``box.binda`` and a checkpoint of the
   walk grid with the helix field, running ``distribute_queries``, the
   sharded cold, warm, ``get_cell``, both cell lookups, accurate mode
   without and with df-plane rows (B5, B2-df) and a trace of 65,536
   helix lines (B4), and ``collect_results`` of every output, each
   collected array's sha256 equal to the single-device result's (the
   trace's taken block by block as the ranks hold them: get_cell's
   two-phase rule from 65,536 queries moves a start cell on a shared
   face, which the phase counts); then ``examples/torch_port/0*.py`` in
   subprocesses on the card;
6. accurate phase, ``bench.py``'s accurate protocol on the candidate
   phase's grid: ``prepare_accurate`` (acc table, float64 plane solve,
   df-plane rows), 10M float64 queries from default_rng(2) cold (one
   df-plane row each: kernel B2-df in bin order, the bin pass, scatter,
   df probe and unsort from the float64 queries as given, then again
   from their float32 hi/lo pair) and the candidate phase's moved points
   in float64 warm, guessed by the cold cells (B2, B3's get_cell walk on
   the misses, then B5), gated at 1e-10; the cold call and the get_cell
   + B5 route timed in turns; then B5 through
   ``interpolate_at_icell_acc`` on the brute-force meshes;
7. walk phase, ``bench.py``'s warm protocol on the same box without
   candidate tables, as the io phase read it (``read_grid``'s refine
   walks every seed bin center), 10M cold queries (bin-seeded walks), the
   same points
   advected by 0.01 * velocity with the cold cells as guesses, and 100k
   warm queries pushed out of the box, every walk in B3's get_cell walk
   stage, every value from kernel E1 (``interpolate_at_icell``); that
   stage and the earlier composition it replaces (``walk_origin``,
   ``_walk_args``, two ``walk_cuda`` launches) timed in turns, B3's
   explicit walk (``walk_rows``, the direction computed in the kernel)
   torch.equal to ``walk_rows_plain`` and timed on its own and through
   the public ``walk()`` (``tools/walk_rows_sweep.py`` times its launch
   shapes against the first design), and E1 torch.equal to
   ``interpolate_at_icell_plain`` on the 10M warm queries, the two timed
   in turns;
8. trace phase, ``bench.py``'s ``trace_at_scale`` protocol on the walk
   phase's grid: the helical field (-(y-0.5), x-0.5, 0.25) added with
   ``add_point_data(..., fuse=False)``, ``build_trace_table`` once, then
   ``integrate_along_field`` (min_dx 1e-4, max_dx 0.05, 256 steps, rtol =
   atol = 1e-3) from 0.3 + 0.4 * default_rng(3).random((n, 3)) for n =
   1024 and 65,536 lines (B3's get_cell walk for the start cells, then
   one E1 launch for the start field, then one launch of B4 running
   every line's RK loop), each held field by
   field against the plain loop on the card, and the 1024 lines again
   through the generic path (B3's explicit walks plus torch); the 1024
   lines' result written by ``write_trace_vtk`` and its points read
   back;
9. float64 phase, once the float32 grids are freed: the brute-force
   meshes in float64 with the same 1M + 1% queries (B1 in double, torch.equal
   to the plain version, linear error at most 1e-14); the 998,250-tet box
   built in float64 (lists from D1 and D2; K = 7, no fused variable,
   extension rows in most bins), 10M cold float64 queries (B2 in double in
   bin order with the extension probe, then
   ``interpolate_at_icell``, E1 in double; each stage torch.equal to its
   plain version, E1 timed against it in turns, linear error at most
   1e-12); the box's float64 walk grid (no candidate
   tables) with 10M cold and 10.1M warm queries (1% outside; B3's double
   get_cell walk, torch.equal to ``get_cell_walk_plain``) and B3's double
   ``walk_rows``; a generic float64 trace of the helix, 1024 lines (B3's
   double walks, no B4), every field torch.equal to the same loop with
   the plain walks, and its first walk launch timed alone; the phase's
   peak device memory;
10. oracle phase: the card's answers that the earlier phases kept, held
   against the independent serial C++ oracle (``native/serial_oracle.cc``,
   built by ``utils/serial_oracle.py`` with g++ and run on one CPU core
   of this machine): the float64 box's first 4,096 cold queries (the
   oracle seeds each by brute-force 1-NN) and the float64 walk grid's
   last 1M warm ones (the card's guesses; 100,000 outside), found masks
   identical, values within 1e-12; the float32 candidate box's first 1M
   cold queries (the oracle's seeds from a kd-tree 1-NN) and the float32
   walk grid's 900,000 warm plus 100,000 off-domain ones (the card's
   guesses), given the float64 arrays each grid was built from, values
   within 2e-6 and 5e-5; everywhere cell ids identical but where both
   cells hold the query within the grid's tie band (``oracle_band``);
   the float64 generic trace and the fused float32 trace of the 1024
   helix lines by ``tests/test_torch_trace.py``'s trace rules (curves
   within 1e-9 and 5e-5), final states within 2 min_dx; then the
   oracle's queries/s and trace steps/s on one core beside the card's;
11. holds each kernel against its plain PyTorch version on the same CUDA
   tensors, checks linear exactness and found masks, and times kernel
   and plain version with CUDA events (B4 and B3's walks at the generic
   trace's size, whose launches are short beside the wrapper's host
   work, by the profiler's device time where it records one).

Launch counters are zeroed right before each main-path call and read
right after it; comparison and timing launches are not counted.  The
last three lines are the card (nvidia-smi name, power limit), a JSON
line of per-kernel results, and ``{"ok": true, "device": ...}``.  Each
kernel's ``bound_ms`` is the least time for its bytes at 3.35 TB/s or
its float32 operations at 67 TFLOP/s (float64 ones at 34 TFLOP/s; H100
SXM data sheet), whichever is larger, counted from this run's inputs (df32 operations as the float32
operations they are made of): each input byte once and each output byte
once, so a table row counts once however many queries or walk steps
read it (the distinct rows from the run's bin indices and cells, and for
walks from a run of the plain version on a recording table).  B1 and B5
also print an instruction floor: the float32 instructions that parity
keeps unfused at one per lane per clock (33.5e12/s).  Any
failed check raises
before them, with a non-zero exit; without a CUDA device the script
exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_BF = 1_000_000  # brute-force queries per mesh (benchmark.f90 protocol)
N_CAND = 10_000_000  # cold queries on the 998k-tet mesh (bench.py)
N_CMP = 1_000_000  # queries of the kernel-vs-plain comparison
LIN_TOL = 2e-6  # float32 linear-exactness bound of B1 and the fused rows
# interpolate_at_icell (every warm query, every walk-grid query) takes the
# reference's tetra weights: f32 triple products over 6 * the f64 volume
# cast to f32.  The triple products see the f32-rounded vertices, so the
# weights sum to 1 only within ~(vertex rounding) / h, and the linear
# error grows with the cell count (the walk phase prints it beside the
# error of the same products over their own sum).  The bound stays far
# below a wrong cell's error (h * |grad f| ~ 3e-2), and it is the JAX
# package's own float32 gate on this mesh (bench.py:346);
# tools/icell_error_witness.py measures the JAX package's error on the
# walk phase's warm queries on the CPU.
LIN_TOL_ICELL = 5e-5
VAL_TOL = 2e-6  # kernel vs plain values where the cell ids agree
AGREE = 0.99999  # share of queries whose ic/found/aux must be identical
FILL = -7.0
N_OFF = 100_000  # warm queries pushed out of the box, walk phase
RP_TOL = 4e-6  # B3 vs plain final positions where the walks agree
HBM_BYTES_S = 3.35e12  # H100 SXM memory rate
F32_FLOPS_S = 67e12  # H100 SXM float32 rate outside the tensor cores
# one float32 instruction per lane per clock (an FMA counts 2 operations
# in F32_FLOPS_S): the floor of the work that parity keeps unfused
F32_INSTR_S = F32_FLOPS_S / 2


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


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of the bytes' time at the memory
    rate and the float32 operations' time at the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / F32_FLOPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def steady_s(fn, reps):
    """Host seconds per call of ``fn`` (ending in a synchronize), after
    the first call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def plain_walks(walk_kernel):
    """Inside the block every walk of the port runs the plain version
    (explicit walks and get_cell's walk stage)."""
    real = walk_kernel.walk_rows, walk_kernel.get_cell_walk
    walk_kernel.walk_rows = walk_kernel.walk_rows_plain
    walk_kernel.get_cell_walk = walk_kernel.get_cell_walk_plain
    try:
        yield
    finally:
        walk_kernel.walk_rows, walk_kernel.get_cell_walk = real


def _counter_names(mod):
    return [a for a, v in vars(mod).items()
            if a.endswith("launches") and type(v) is int]


def main_path(fn, counters):
    """Run one main-path call with every launch counter zeroed first;
    return its result and the launches it made: ``counts[<module>]`` for
    a module's ``launches``, ``counts["<module>:<x>"]`` for its
    ``<x>_launches`` (the candidate module's df-plane launches under
    ``:df``, the bin-ordered kernels under ``:bin_pass``,
    ``:bin_scatter``, ``:binned`` and ``:bin_unsort``, get_cell's walk
    stage under
    ``walk_kernel:get_cell``)."""
    for mod in counters:
        for name in _counter_names(mod):
            setattr(mod, name, 0)
    out = fn()
    torch.cuda.synchronize()
    counts = {}
    for mod in counters:
        for name in _counter_names(mod):
            key = mod.__name__ if name == "launches" else (
                f"{mod.__name__}:{name[:-len('_launches')]}")
            counts[key] = getattr(mod, name)
    return out, counts


class RowRecorder:
    """A stand-in for a row table that records the rows a plain version
    gathers (``table[idx]`` or ``table[idx, cols]``) and hands back the
    real rows; ``distinct(col0)`` counts the distinct rows gathered with
    their columns starting at ``col0``, ``distinct()`` all of them."""

    def __init__(self, table):
        self.table = table
        self.shape = table.shape
        self.dtype = table.dtype
        self.device = table.device
        self.seen = []

    def __getitem__(self, key):
        idx, cols = key if isinstance(key, tuple) else (key, slice(None))
        self.seen.append((cols.start or 0, idx.reshape(-1)))
        return self.table[key]

    def distinct(self, col0=None):
        rows = [i for c, i in self.seen if col0 is None or c == col0]
        if not rows:
            return 0
        return int(torch.unique(torch.cat(rows).long()).numel())


def turns(fns, reps):
    """CUDA-event ms per call of each of ``fns`` (name -> callable), timed
    in turns old, new, new, old for two of them, else in order then in
    reverse: {name: [ms, ms]}."""
    names = list(fns)
    order = names + names[::-1]
    out = {n: [] for n in names}
    for n in order:
        out[n].append(cuda_ms(fns[n], reps))
    return out


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


def bf_meshes(meshgen):
    """The brute-force phase's meshes: (cell type, label, mesh)."""
    return [
        ("triangle", "triangle_rect_mesh(2,2)", meshgen.triangle_rect_mesh(2, 2)),
        ("quad", "quad_rect_mesh(8,8)", meshgen.quad_rect_mesh(8, 8)),
        ("tetra", "tet_box_mesh(5,5,5)", meshgen.tet_box_mesh(5, 5, 5)),
    ]


def bf_queries(pts, rng, dev, dtype=np.float32):
    """N_BF queries (float32, or ``dtype``) inside the bounding box of
    ``pts``, then 1% pushed out of it along x."""
    lo, hi = pts.min(0), pts.max(0)
    span = hi - lo
    r_in = lo + rng.random((N_BF, 3)) * span
    n_out = N_BF // 100
    r_out = lo + rng.random((n_out, 3)) * span
    side = np.where(rng.random(n_out) < 0.5, -1.0, 1.0)
    r_out[:, 0] = np.where(side < 0, lo[0], hi[0]) + side * (
        0.01 + rng.random(n_out)) * span[0]
    return torch.from_numpy(
        np.concatenate([r_in, r_out]).astype(dtype)).to(dev)


def b1_work(grid):
    """(bytes, operations, instructions) of B1 at N_BF queries: per query
    and cell nf plane evaluations of 7 operations (3 mul, 2 add, 1 sub, 1
    min), plus the argmax's select and maximum as instructions; bytes:
    queries in, values, ids and flags out, planes and winner geometry
    once."""
    nc, nf = grid.n_cells, grid.n_faces_per_cell
    n_bytes = (N_BF * (12 + 4 + 4 + 1) + nc * nf * 16
               + nc * (grid.n_points_per_cell * 4 + 1) * 4)
    return n_bytes, N_BF * nc * nf * 7, N_BF * nc * (nf * 7 + 2)


def bruteforce_phase(dev, tiu, meshgen, interp_kernel, locate, cand_kernel,
                     walk_kernel):
    rng = np.random.default_rng(1)
    res = {"rows": []}
    for cell_type, label, (pts, cells, nbrs) in bf_meshes(meshgen):
        grid = tiu.build_grid(
            pts, cells, nbrs, cell_type, point_data={"Polynomial": pts.sum(1) + 1.0},
            dtype=torch.float32, device=dev,
        )
        check(grid.locate_mode == "bruteforce", f"{label} is not brute force")
        r = bf_queries(pts, rng, dev)

        (vals, ic, found), counts = main_path(
            lambda: tiu.interpolate_scalar_at(grid, r, 0, fill_value=FILL),
            (interp_kernel, cand_kernel, walk_kernel),
        )
        n_b1 = counts[interp_kernel.__name__]
        check(n_b1 >= 1, f"{label}: B1 was not launched on the main path")
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

        # the kernel and the main path against the plain version, bit for
        # bit: ids, found masks and values
        pv, pic, pf = interp_kernel.interpolate_bruteforce_plain(grid, r, [0])
        kv, kic, kf = interp_kernel.interpolate_bruteforce_cuda(grid, r, [0])
        for name, a, b in (("i_cell", kic, pic), ("found", kf, pf),
                           ("values", kv, pv), ("main-path i_cell", ic, pic),
                           ("main-path found", found, pf),
                           ("main-path values", vals,
                            torch.where(pf, pv[:, 0], FILL))):
            check(torch.equal(a, b), f"B1 {label}: {name} differs from the "
                  f"plain version on {int((a != b).sum())} queries")
        err = float((kv - pv).abs().max())
        del pv, pic, pf, kv, kic, kf
        print(f"B1 {label}: kernel and main path torch.equal to the plain "
              f"version (ids, found, values) on {r.shape[0]} queries")

        # the kernel's device time by the profiler (on the small meshes
        # the launches are short beside the wrapper's host work, which
        # CUDA events around back-to-back calls also time)
        dev_ms, ev_ms = kernel_ms(
            lambda: interp_kernel.interpolate_bruteforce_cuda(
                grid, r[:N_BF], [0]), "table_kernel", 10)
        ms_k = ev_ms if dev_ms is None else dev_ms
        ms_p = cuda_ms(lambda: interp_kernel.interpolate_bruteforce_plain(
            grid, r[:N_BF], [0]), 3)
        e2e = steady_s(lambda: tiu.interpolate_scalar_at(grid, r[:N_BF], 0), 5)
        n_bytes, n_ops, n_instr = b1_work(grid)
        bnd = bound(n_bytes, n_ops)
        floor = n_instr / F32_INSTR_S * 1e3
        dev_txt = "not recorded" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"B1 {label} ({grid.n_cells} cells), 1M queries: kernel "
              f"{dev_txt} device time ({ev_ms:.4f} ms a call by CUDA "
              f"events), plain {ms_p:.4f} ms; interpolate_scalar_at "
              f"{e2e * 1e3:.4f} ms = {N_BF / e2e:.4e} queries/s; bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}), instruction floor {floor:.4f} ms; "
              f"linear error {lin:.3e}")
        res["rows"].append(dict(label=label, n_cells=grid.n_cells,
                                launches=n_b1, ms=ms_k, plain_ms=ms_p,
                                e2e_ms=e2e * 1e3, lin=lin, bound=bnd,
                                floor_ms=floor, max_abs_err=err))
        # the accurate phase runs B5 on these grids, queries and cells
        res.setdefault("acc_inputs", []).append(
            (label, grid, r[:N_BF], ic[:N_BF]))
    return res


def binned_probe_call(grid, r, perm, lay, eps, k, lanes, rec, b=None,
                      ext=None):
    """One launch of B2's probe kernel in bin order alone (records by
    slot in ``rec``, no unsort) on a float32 or float64 grid's rows, with
    the extension rows ``ext`` = (table, RowLayout) or without."""
    from interpolate_unstructured_tpu_torch.ops import _kernels, cand_kernel

    b = r.shape[0] if b is None else b
    vroles = cand_kernel._var_roles(lay.var_roles, r.device)
    ext_args = (None, 0, 0, 0) if ext is None else (
        ext[0].data_ptr(), ext[0].shape[1], ext[1].k, ext[1].count_col)
    head = (grid.cand_table.data_ptr(), grid.cand_table.shape[1],
            r.data_ptr())
    bins = (grid.cand_rmin.data_ptr(), grid.cand_inv_h.data_ptr(),
            *grid.cand_shape, k, lay.nf, cand_kernel._KIND_CODE[lay.kind],
            lay.id_role, lay.count_col, float(eps), k)
    tail = (len(lay.var_roles), vroles.data_ptr(), *ext_args, rec.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    lib = _kernels.lib()
    if grid.cand_table.dtype == torch.float64:
        code = lib.iu_cand_rows_binned_f64(*head, perm.data_ptr(), b, lanes,
                                           *bins, *tail)
    else:
        code = lib.iu_cand_rows_binned(*head, None, 0, perm.data_ptr(), b,
                                       lanes, *bins, cand_kernel.QINV, *tail)
    _kernels.check(code, "iu_cand_rows_binned")


def ext_check(label, grid, r, cand_kernel, locate, bound_fn=bound, reps=10):
    """B2's probe in bin order with the extension probe on a grid with
    extension rows, on the main path's queries ``r``: the probe and the
    unsort torch.equal to the plain composition (probe_rows_ext_plain:
    the main probe, the extension probe of the overflow misses, the
    merge); how many queries reached the extension rows and how many a
    walk takes; the probe kernel alone (records by slot) with the
    extension rows and without them timed in turns; the plain
    composition with its inputs from r; the bound, each byte once: per
    candidate its probe roles of every distinct main and extension row
    read, the value roles of every distinct (row, winner), per query
    its perm entry, coordinates and record."""
    slots = (0,) if grid.cand_nv else ()
    k = grid.cand_ids.shape[1]
    lay = locate._row_layout(grid, k, slots)
    lay_e = locate._row_layout(grid, grid.cand_ext_ids.shape[1], slots)
    ext = (grid.cand_ext_table, lay_e)
    eps = locate._cand_eps(grid)
    bins = (grid.cand_rmin, grid.cand_inv_h, grid.cand_shape)
    chunk = locate._cand_chunk(grid)
    n = r.shape[0]
    n_bins = int(np.prod(grid.cand_shape))
    idx, rq = locate._cand_probe_inputs(grid, r)
    want = cand_kernel.probe_rows_ext_plain(grid.cand_table, ext[0], idx, rq,
                                            lay, lay_e, eps, k, chunk)
    _, _, perm, slot = cand_kernel.bin_order_cuda(r, *bins)
    got = cand_kernel.cand_rows_binned_cuda(grid.cand_table, r, perm, slot,
                                            *bins, lay, eps, k, ext=ext)
    for name, a, b in zip(("id", "aux", "values"), got, want):
        n_bad = int((a != b).reshape(n, -1).any(1).sum())
        check(torch.equal(a, b), f"{label}: the probe with the extension "
              f"rows, {name} differs from probe_rows_ext_plain on {n_bad} "
              "queries")
    main = cand_kernel.cand_rows_binned_cuda(grid.cand_table, r, perm, slot,
                                             *bins, lay, eps, k)
    reach = main[1] >= 0
    n_ext, n_walk = int(reach.sum()), int((want[1] >= 0).sum())
    check(n_ext > 0, f"{label}: no query reached the extension rows")
    lanes = cand_kernel.binned_lanes(n, n_bins)
    n_vars = len(lay.var_roles)
    e = grid.cand_table.element_size()
    rec = torch.empty((n, 2 + n_vars * e // 4), dtype=torch.int32,
                      device=r.device)
    t = turns({"main": lambda: binned_probe_call(grid, r, perm, lay, eps, k,
                                                 lanes, rec),
               "fused": lambda: binned_probe_call(grid, r, perm, lay, eps, k,
                                                  lanes, rec, ext=ext)}, reps)
    plain_ms = cuda_ms(lambda: cand_kernel.probe_rows_ext_plain(
        grid.cand_table, ext[0], *cand_kernel.probe_inputs_plain(
            r, *bins, lay.kind == "quantized"), lay, lay_e, eps, k, chunk), 2)
    quant = lay.kind == "quantized"
    nf = lay.nf
    # probe roles a candidate (int16 pair words and the id, or planes and
    # the id), the row's count (and dscale), value roles of a winner
    roles = (-(-3 * nf // 2) + -(-nf // 2) + 1) if quant else 4 * nf + 1
    tail = 2 if quant else 1
    vals = n_vars * (4 if quant else nf) + (12 if lay.kind == "quad" else 0)
    n_rows = int(torch.unique(idx).numel())
    erows = main[1][reach]
    n_erows = int(torch.unique(erows).numel())
    plane = torch.unique(idx.long() * (grid.n_cells + 1) + main[0].long() + 1)
    eplane = torch.unique(erows.long() * (grid.n_cells + 1)
                          + want[0][reach].long() + 1)
    n_bytes = ((n_rows * (roles * k + tail) + n_erows * (roles * lay_e.k
                                                          + tail)) * e
               + (int(plane.numel()) + int(eplane.numel())) * vals * e
               + n * (4 + 3 * e + 4 * rec.shape[1]))
    ops = (n * k + n_ext * lay_e.k) * nf * 9
    res = dict(n_ext=n_ext, n_walk=n_walk, max_abs_err=0.0,
               ms=sum(t["fused"]) / 2, turns=t, plain_ms=plain_ms,
               bound=bound_fn(n_bytes, ops), lanes=lanes)
    print(f"{label}: the probe in bin order with the extension rows "
          f"({lanes} lanes a query) and the unsort torch.equal to "
          f"probe_rows_ext_plain on {n} queries; {n_ext} ({n_ext / n:.4%}) "
          f"reached the extension rows ({n_erows} distinct of "
          f"{ext[0].shape[0]}, K={k}, k_ext={lay_e.k}), {n_walk} "
          f"({n_walk / n:.4%}) walk; probe kernel alone, CUDA events in "
          f"turns: main rows only {t['main'][0]:.4f} / {t['main'][1]:.4f} "
          f"ms, with the extension probe {t['fused'][0]:.4f} / "
          f"{t['fused'][1]:.4f} ms; plain composition {plain_ms:.4f} ms; "
          f"bound {res['bound'][0]:.4f} ms ({res['bound'][1]})")
    return res


def b2_front_end(dev, grid, r, k, cand_kernel, locate):
    """B2 on the 10M cold queries of the 998k-tet box: the bin-ordered
    front end against its plain versions, each kernel timed, with bounds
    that count each row once.  The probe in bin order is checked and
    timed at the lanes a query that ``binned_lanes`` picks and at its
    neighbour (2 and 4); tools/b2_sweep.py sweeps lanes and batch sizes,
    and the direct kernel of the first design (one warp a query in query
    order) against the bin-ordered query."""
    from interpolate_unstructured_tpu_torch.ops import _kernels, geometry

    res = {}
    n = r.shape[0]
    idx, rq = locate._cand_probe_inputs(grid, r)
    lay = locate._row_layout(grid, k, (0,))
    eps = locate._cand_eps(grid)
    chunk = locate._cand_chunk(grid)
    bins = (grid.cand_rmin, grid.cand_inv_h, grid.cand_shape)
    n_bins = int(np.prod(grid.cand_shape))
    lanes = cand_kernel.binned_lanes(n, n_bins)
    lanes_guard = 4 if lanes == 2 else 2

    # the bin-ordered front end against its plain versions, bit for bit;
    # max_abs_err of an integer output is its count of differing entries
    b_idx, ends, perm, slot = cand_kernel.bin_order_cuda(r, *bins)
    arange = torch.arange(n, device=dev, dtype=torch.int32)
    res["pass_err"] = float(int((b_idx != idx).sum()) + int(
        (ends.long() != torch.cumsum(torch.bincount(
            idx.long(), minlength=n_bins), 0)).sum()))
    check(res["pass_err"] == 0, f"B2 bin pass: {res['pass_err']:.0f} bins "
          "or scanned counts differ from the plain bin index and bincount")
    res["scatter_err"] = float(
        int((torch.sort(perm).values != arange).sum())
        + int((idx[perm.long()] != idx[cand_kernel.bin_order_plain(idx)])
              .sum())
        + int((perm[slot.long()] != arange).sum()))
    check(res["scatter_err"] == 0, f"B2 scatter: {res['scatter_err']:.0f} "
          "entries of perm or slot are not the plain grouping and its inverse")
    pout = cand_kernel.probe_rows_plain(grid.cand_table, idx, rq, lay, eps, k,
                                        chunk)
    for g in (lanes, lanes_guard):
        kout = cand_kernel.cand_rows_binned_cuda(
            grid.cand_table, r, perm, slot, *bins, lay, eps, k, lanes=g)
        for name, a, b in zip(("id", "aux", "values"), kout, pout):
            n_bad = int((a != b).reshape(n, -1).any(1).sum())
            check(torch.equal(a, b), f"B2 in bin order, {g} lanes a query: "
                  f"{name} differs from probe_rows_plain on {n_bad} queries")
    res["binned_err"] = float((kout[2] - pout[2]).abs().max())
    print(f"B2 in bin order, all {n} cold queries: bins equal the plain bin "
          f"index, ends the scan of its bincount, perm groups the queries as "
          f"the stable argsort does and slot is its inverse; id, aux and "
          f"values torch.equal to probe_rows_plain with {lanes} and "
          f"{lanes_guard} lanes a query")
    n_rows = int(torch.unique(idx).numel())
    n_planes = int(torch.unique(
        idx.long() * (grid.n_cells + 1) + pout[0].long() + 1).numel())
    del kout, pout

    # timing: the bin-ordered query, then each kernel alone
    ms_q = cuda_ms(lambda: cand_kernel.cand_rows_binned_query(
        grid.cand_table, r, *bins, lay, eps, k, chunk), 10)
    ms_pu = cuda_ms(lambda: cand_kernel.cand_rows_binned_cuda(
        grid.cand_table, r, perm, slot, *bins, lay, eps, k), 10)
    lib = _kernels.lib()
    stream = torch.cuda.current_stream().cuda_stream
    rmin, inv_h = (t.contiguous() for t in bins[:2])
    counts = torch.zeros(n_bins, dtype=torch.int32, device=dev)
    bin_buf, rank_buf, perm_buf, slot_buf = (
        torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4))

    def bin_pass():  # with the 8 MB memset of the counts
        counts.zero_()
        _kernels.check(lib.iu_cand_bin_pass(
            r.data_ptr(), 0, n, rmin.data_ptr(), inv_h.data_ptr(),
            *grid.cand_shape, counts.data_ptr(), bin_buf.data_ptr(),
            rank_buf.data_ptr(), stream), "iu_cand_bin_pass")

    bin_pass()
    scan = torch.cumsum(counts, 0, dtype=torch.int32)

    def scatter():
        _kernels.check(lib.iu_cand_bin_scatter(
            bin_buf.data_ptr(), rank_buf.data_ptr(), scan.data_ptr(), n,
            perm_buf.data_ptr(), slot_buf.data_ptr(), stream),
            "iu_cand_bin_scatter")

    n_vars = len(lay.var_roles)
    rec = torch.empty((n, 2 + n_vars), dtype=torch.int32, device=dev)
    vroles = torch.tensor(lay.var_roles, dtype=torch.int32, device=dev)
    outs = (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty((n, n_vars), dtype=torch.float32, device=dev))

    def probe(lanes, b=n):  # the probe kernel alone, records by slot
        binned_probe_call(grid, r, perm, lay, eps, k, lanes, rec, b=b)

    def unsort():
        _kernels.check(lib.iu_cand_bin_unsort(
            rec.data_ptr(), slot.data_ptr(), n, n_vars, outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), stream),
            "iu_cand_bin_unsort")

    def unsort_plain():  # the records put back in query order, split
        back = rec[slot.long()]
        return back[:, 0], back[:, 1], back[:, 2:].view(torch.float32)

    ms_pass = cuda_ms(bin_pass, 10)
    ms_scan = cuda_ms(lambda: torch.cumsum(counts, 0, dtype=torch.int32), 10)
    ms_scatter = cuda_ms(scatter, 10)
    check(lay.kind == "quantized", "the 998k box's rows are not quantized")
    t_lanes = turns({g: (lambda g=g: probe(g)) for g in (lanes, lanes_guard)},
                    10)
    probe(lanes)
    unsort()
    u_plain = unsort_plain()
    res["unsort_err"] = max(
        float(int((outs[0] != u_plain[0]).sum())
              + int((outs[1] != u_plain[1]).sum())),
        float((outs[2] - u_plain[2]).abs().max()))
    check(res["unsort_err"] == 0 and torch.equal(outs[2], u_plain[2]),
          f"B2 unsort differs from the records indexed by slot "
          f"({res['unsort_err']})")
    del u_plain
    ms_unsort = cuda_ms(unsort, 10)
    ms_p_unsort = cuda_ms(unsort_plain, 3)
    ms_lib_unsort = cuda_ms(lambda: rec[slot.long()], 3)
    ms_memset = cuda_ms(counts.zero_, 10)
    ms_p_binned = cuda_ms(lambda: cand_kernel.probe_rows_plain(
        grid.cand_table, *cand_kernel.probe_inputs_plain(r, *bins, True), lay,
        eps, k, chunk), 2)
    ms_p_pass = cuda_ms(lambda: torch.bincount(geometry.bin_flat(
        geometry.bin_ijk(r, *bins, torch.int32), grid.cand_shape).long(),
        minlength=n_bins), 3)
    ms_p_order = cuda_ms(lambda: cand_kernel.bin_order_plain(idx), 3)
    ms_lib_order = cuda_ms(lambda: torch.argsort(idx, stable=True), 3)
    print(f"B2 998k-tet, {n} cold queries, CUDA events: bin-ordered query "
          f"{ms_q:.4f} ms; kernels alone: probe and unsort in bin order "
          f"{ms_pu:.4f} ms; "
          f"bin pass {ms_pass:.4f} ms (with the count memset, {ms_memset:.4f} "
          f"ms alone), scan {ms_scan:.4f} ms, scatter {ms_scatter:.4f} ms, "
          f"unsort {ms_unsort:.4f} ms; row "
          f"{grid.cand_table.shape[1] * 4} B, {n_rows} distinct rows, "
          f"{n_bins} bins")
    print(f"B2 probe kernel alone, records by slot, lanes a query "
          f"(in turns): " + ", ".join(
              f"{g}: {t_lanes[g][0]:.4f} / {t_lanes[g][1]:.4f} ms"
              for g in (lanes, lanes_guard))
          + f"; binned_lanes picks {lanes}")
    print(f"B2 plain versions at {n}: probe_rows_plain with its inputs "
          f"from r {ms_p_binned:.4f} ms, bin index + bincount "
          f"{ms_p_pass:.4f} ms, stable argsort {ms_p_order:.4f} ms, unsort "
          f"(index by slot, split) {ms_p_unsort:.4f} ms; library calls: "
          f"torch.argsort(idx, stable=True) {ms_lib_order:.4f} ms, "
          f"rec[slot.long()] {ms_lib_unsort:.4f} ms")

    # Bounds, each byte once: the probe roles (int16 normal and offset
    # words, ids), count and dscale of every distinct row; the value
    # plane (4 floats) of every distinct (row, winner); per query its
    # inputs and outputs (a record of 2 + n_vars words between the probe
    # and the unsort)
    n_roles = -(-3 * lay.nf // 2) + -(-lay.nf // 2) + 1
    rows_b = n_rows * (n_roles * k * 4 + 8) + n_planes * 16
    ops = n * k * lay.nf * 9
    rec_b = 4 * (2 + n_vars)
    res["probe"] = dict(
        ms=sum(t_lanes[lanes]) / 2, ms_turns=t_lanes[lanes],
        plain_ms=ms_p_binned,
        bound=bound(rows_b + n * (4 + 12 + rec_b), ops))
    res["bin_pass"] = dict(ms=ms_pass, plain_ms=ms_p_pass, library_ms=None,
                           bound=bound(n * (12 + 8) + n_bins * 4, n * 9))
    res["bin_scatter"] = dict(ms=ms_scatter, plain_ms=ms_p_order,
                              library_ms=ms_lib_order,
                              bound=bound(n * 16 + n_rows * 4, 0))
    res["bin_unsort"] = dict(ms=ms_unsort, plain_ms=ms_p_unsort,
                             library_ms=ms_lib_unsort,
                             bound=bound(n * (4 + 2 * rec_b), 0))
    res["query"] = dict(ms=ms_q, bound=bound(rows_b + n * (12 + rec_b), ops))
    for name in ("probe", "bin_pass", "bin_scatter", "bin_unsort"):
        b = res[name]["bound"]
        print(f"B2 {name} bound at {n} queries: {b[0]:.4f} ms ({b[1]})")
    b = res["query"]["bound"]
    print(f"B2 bin-ordered query bound (r in, outputs out, each distinct "
          f"row and winner plane once): {b[0]:.4f} ms ({b[1]}); {n_rows} "
          f"rows, {n_planes} (row, winner) planes")
    return res


BUILDER_KERNELS = ("count", "write", "order")  # D1's two passes, D2
SOUP_N = 18  # the heavy-bin soup's small box: 34,992 tets in one bin
SOUP_KW = dict(bins_per_cell=0.25, max_bins=1 << 22, eps=2e-10,
               ext_max_k=32)
SOUP_K = 10


def builder_launches(counts):
    """D1's and D2's launches in a main-path run's counts."""
    return {x: counts.get(f"interpolate_unstructured_tpu_torch.ops."
                          f"cand_build_kernel:{x}", 0)
            for x in BUILDER_KERNELS}


def host_geometry(pts, cells, nbrs, cell_type):
    """The candidate builder's host inputs for a mesh, as build_grid
    hands them over: (cell points, normals, offsets, rmin, rmax,
    ndim)."""
    from interpolate_unstructured_tpu_torch.ops import geometry

    cp = geometry.gather_cell_points(pts, cells)
    normals, _ = geometry.face_normals_and_boundary(
        cp, cells, nbrs, cell_type, len(pts))
    offs = np.einsum("cki,cki->ck", cp, normals)
    return (cp, normals, offs, pts.min(0), pts.max(0),
            geometry.NDIM_OF_CELL_TYPE[cell_type])


def builder_inputs(grid, pts, cells, nbrs, dev, timings=None):
    """The device candidate builder's inputs for ``grid``'s mesh and
    config, as build_grid hands them over: (PairInputs, host geometry
    tuple, builder keywords, seconds of the prelude).  ``timings`` gets
    the prelude's steps."""
    from interpolate_unstructured_tpu_torch.ops import cand_build

    cfg = grid.config
    args = host_geometry(pts, cells, nbrs, grid.cell_type)
    kw = dict(bins_per_cell=cfg.cand_bins_per_cell,
              max_bins=cfg.cand_max_bins, eps=2.0 * cfg.eps_inside)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, shape, _, _ = cand_build.prepare_pairs(
        *args, grid.dtype, kw["bins_per_cell"], kw["max_bins"], kw["eps"],
        dev, timings=timings)
    torch.cuda.synchronize()
    prelude_s = time.perf_counter() - t0
    check(shape == grid.cand_shape, f"builder bins {shape} against the "
          f"grid's {grid.cand_shape}")
    return p, args, kw, prelude_s


def bucket_canonical(rec, counts):
    """Records bucket by bucket, each bucket in ascending order (the
    order of bin_pairs_plain)."""
    from interpolate_unstructured_tpu_torch.ops import cand_build

    keys = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts.long())
    return keys, rec[cand_build.bucket_order(keys, rec)]


def builder_match(label, p, k, ext_max_k, grid_tables=None):
    """D1's count pass, its write pass (canonically ordered inside each
    bucket) and D2 (on the write pass's records and on the records with
    each bucket shuffled) torch.equal to their plain versions on the
    card, for K = ``k``; D2's tables torch.equal to ``grid_tables``
    (cand_ids, cand_count, ext_slot, ext_ids or None) where given.
    Returns the stages' tensors and sizes."""
    from interpolate_unstructured_tpu_torch.ops import cand_build
    from interpolate_unstructured_tpu_torch.ops import cand_build_kernel as bk

    counts = bk.count_pairs_cuda(p)
    want_counts, want_rec = cand_build.bin_pairs_plain(p)
    check(torch.equal(counts, want_counts), f"{label}: D1's count pass "
          "differs from bin_pairs_plain's counts")
    start = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    n_kept, max_count = int(counts.sum()), int(counts.max())
    rec = bk.write_pairs_cuda(p, start, n_kept)
    keys, canon = bucket_canonical(rec, counts)
    check(torch.equal(canon, want_rec), f"{label}: D1's write pass, "
          "ordered inside each bucket, differs from bin_pairs_plain's "
          "records")
    n_over = int((counts > k).sum())
    k_ext = min(max_count - k, ext_max_k) if n_over and ext_max_k else 0
    slot = cand_build.ext_slots(counts, k)
    n_cells = p.normals.shape[0]
    want = cand_build.fill_tables_plain(want_rec, counts, n_cells, k, k_ext,
                                        n_over)
    g = torch.Generator().manual_seed(7)
    noise = torch.randperm(n_kept, generator=g).to(rec.device)
    shuffled = rec[cand_build.bucket_order(keys, noise)]
    for name, r in (("its records", rec), ("shuffled records", shuffled)):
        got = bk.order_tables_cuda(r, start, counts, slot, n_cells, k, k_ext,
                                   n_over, max_count)
        for part, a, b in zip(("cand_ids", "ext_slot", "ext_ids"), got,
                              want):
            check(torch.equal(a, b), f"{label}: D2's {part} from {name} "
                  "differ from fill_tables_plain's")
    if grid_tables is not None:
        ids, count, g_slot, g_ext = grid_tables
        g_ext = (torch.zeros((0, 0), dtype=torch.int32, device=ids.device)
                 if g_ext is None else g_ext)
        check(torch.equal(counts, count) and torch.equal(want[0], ids)
              and torch.equal(want[1], g_slot) and torch.equal(want[2], g_ext),
              f"{label}: the plain tables differ from the built grid's")
    del want_rec, shuffled, canon, keys, noise
    return dict(counts=counts, start=start, rec=rec, slot=slot,
                n_kept=n_kept, max_count=max_count, n_over=n_over,
                k=k, k_ext=k_ext)


def builder_grid_match(label, grid, pts, cells, nbrs, dev):
    """builder_match on a grid built (or rebuilt) with the device builder:
    the stages on the grid's own inputs, and the tables equal to the
    grid's lists."""
    p, *_ = builder_inputs(grid, pts, cells, nbrs, dev)
    ext = grid.cand_ext_ids
    m = builder_match(label, p, grid.cand_ids.shape[1],
                      0 if ext is None else ext.shape[1],
                      (grid.cand_ids, grid.cand_count, grid.cand_ext_slot,
                       ext))
    print(f"{label}: D1's count and write passes and D2 torch.equal to "
          f"bin_pairs_plain and fill_tables_plain ({m['n_kept']} kept "
          f"pairs, worst bin {m['max_count']}, K={m['k']}, k_ext="
          f"{m['k_ext']} for {m['n_over']} bins), the plain tables "
          f"torch.equal to the grid's lists")
    del m


def builder_bounds(p, m):
    """The bounds of D1's passes, D2 and the chain on ``p`` and the
    stages ``m``: each input and output byte once; operations of the
    slots inside the cells' spans (9 for the bin center, 7 a face for the
    separation test, 2 more a face for the score)."""
    c, nf = p.offs.shape
    its = p.offs.element_size()
    n_bins = p.n_bins
    cells_b = c * nf * 4 * its + c * 24  # normals, offsets, b0, span
    valid = int(p.span.to(torch.int64).prod(dim=1).sum())
    tables_b = n_bins * m["k"] * 4 + m["n_over"] * m["k_ext"] * 4
    return {
        "count": bound(cells_b + n_bins * 4,
                       valid * (9 + 7 * nf) + c * 6 * nf),
        "write": bound(cells_b + n_bins * 4 + m["n_kept"] * 8,
                       valid * (9 + 9 * nf) + c * 6 * nf),
        "order": bound(m["n_kept"] * 8 + n_bins * 12 + tables_b, 0),
        "chain": bound(cells_b + n_bins * 4 + tables_b,
                       valid * (9 + 9 * nf) + c * 6 * nf),
    }


def peak_gb(fn):
    """GB of device memory that ``fn`` allocated at its peak beyond what
    was allocated before it (what it returns included)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    del out
    torch.cuda.empty_cache()
    return peak


def builder_check(dev, grid, pts, cells, nbrs):
    """The device candidate builder on the 998k box's own inputs: the
    prelude's steps by the host clock; D1's passes and D2 against their
    plain versions and the grid's lists; each stage and the chain after
    the prelude timed by CUDA events beside its bound; the builder's peak
    device memory; no aten::sort under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from interpolate_unstructured_tpu_torch.ops import cand_build
    from interpolate_unstructured_tpu_torch.ops import cand_build_kernel as bk

    prelude = {}
    p, args, kw, prelude_s = builder_inputs(grid, pts, cells, nbrs, dev,
                                            prelude)
    ext = grid.cand_ext_ids
    k, k_ext = grid.cand_ids.shape[1], 0 if ext is None else ext.shape[1]
    m = builder_match("998k box", p, k, k_ext,
                      (grid.cand_ids, grid.cand_count, grid.cand_ext_slot,
                       ext))
    counts, start, rec, slot = m["counts"], m["start"], m["rec"], m["slot"]
    n_kept, max_count, n_over = m["n_kept"], m["max_count"], m["n_over"]
    c = p.offs.shape[0]
    chain = cand_build.candidate_tables(p, k, ext_max_k=k_ext)
    for part, a, b in zip(("cand_ids", "cand_count", "ext_ids", "ext_slot"),
                          chain, (grid.cand_ids, grid.cand_count, ext,
                                  grid.cand_ext_slot)):
        same = a.numel() == 0 if b is None else torch.equal(a, b)
        check(same, f"candidate_tables' {part} differ from the grid's")
    del chain

    def order():
        return bk.order_tables_cuda(rec, start, counts, slot, c, k,
                                    m["k_ext"], n_over, max_count)

    def host_read():
        return torch.stack((
            counts.max().to(torch.int64), counts.sum(dtype=torch.int64),
            (counts > k).sum())).tolist()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        host_read()
    read_ms = (time.perf_counter() - t0) * 100
    bounds = builder_bounds(p, m)
    res = {
        "count": {"ms": cuda_ms(lambda: bk.count_pairs_cuda(p), 10)},
        "write": {"ms": cuda_ms(
            lambda: bk.write_pairs_cuda(p, start, n_kept), 10)},
        "order": {"ms": cuda_ms(order, 10)},
        "scan_ms": cuda_ms(
            lambda: torch.cumsum(counts, 0, dtype=torch.int32) - counts, 10),
        "read_ms": read_ms,
        "chain_ms": cuda_ms(
            lambda: cand_build.candidate_tables(p, k, ext_max_k=k_ext), 10),
        "prelude_s": prelude_s, "prelude": prelude,
    }
    plain_pairs = cuda_ms(lambda: cand_build.bin_pairs_plain(p), 2)
    _, want_rec = cand_build.bin_pairs_plain(p)
    res["order"]["plain_ms"] = cuda_ms(lambda: cand_build.fill_tables_plain(
        want_rec, counts, c, k, m["k_ext"], n_over), 2)
    del want_rec
    for part in ("count", "write", "order"):
        res[part]["bound"] = bounds[part]
        res[part]["library_ms"] = None
    res["count"]["plain_ms"] = res["write"]["plain_ms"] = plain_pairs
    res["chain_bound"] = bounds["chain"]

    # Peak device memory of the chain and of one whole
    # build_candidate_bins_device call beyond what was allocated before
    # it (its outputs included)
    del m, rec, start, slot
    res["chain_peak_gb"] = peak_gb(
        lambda: cand_build.candidate_tables(p, k, ext_max_k=k_ext))
    shape, n_offsets, n_slots = p.bin_shape, p.n_offsets, p.n_slots
    del p
    t0 = time.perf_counter()
    res["peak_gb"] = peak_gb(lambda: cand_build.build_candidate_bins_device(
        *args, k, grid.dtype, **kw, ext_max_k=k_ext, device=dev))
    res["builder_s"] = time.perf_counter() - t0
    n0 = tuple(getattr(bk, f"{x}_launches") for x in BUILDER_KERNELS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cand_build.build_candidate_bins_device(
            *args, k, grid.dtype, **kw, ext_max_k=k_ext, device=dev)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    sorts = [x for x in names if "sort" in x.lower()]
    check(not sorts, f"build_candidate_bins_device launched a sort: {sorts}")
    dn = [getattr(bk, f"{x}_launches") - a
          for x, a in zip(BUILDER_KERNELS, n0)]
    check(dn == [1, 1, 1], f"the profiled build launched D1/D2 {dn} times")
    res["profiled_kernels"] = [x for x in names if "cand_" in x]
    torch.cuda.empty_cache()

    print(f"device candidate builder, {c} tets: bins {shape}, "
          f"{n_offsets} offsets, {n_slots} slots, {n_kept} kept, worst "
          f"bin {max_count}, K={k}; prelude (bin grid, float64 AABBs in "
          f"bins on the card, inputs to the card) {prelude_s:.4f} s split "
          + json.dumps({x: round(v, 4) for x, v in prelude.items()})
          + f"; D1 count pass {res['count']['ms']:.4f} ms (bound "
          f"{bounds['count'][0]:.4f}, {bounds['count'][1]}), scan "
          f"{res['scan_ms']:.4f} ms, host read of 3 scalars "
          f"{read_ms:.4f} ms, D1 write pass {res['write']['ms']:.4f} ms "
          f"(bound {bounds['write'][0]:.4f}, {bounds['write'][1]}), D2 "
          f"{res['order']['ms']:.4f} ms (bound {bounds['order'][0]:.4f}, "
          f"{bounds['order'][1]}); plain versions: bin_pairs_plain "
          f"{plain_pairs:.4f} ms, fill_tables_plain "
          f"{res['order']['plain_ms']:.4f} ms; the chain after the prelude "
          f"(candidate_tables) {res['chain_ms']:.4f} ms (bound "
          f"{bounds['chain'][0]:.4f}, {bounds['chain'][1]}); "
          f"build_candidate_bins_device {res['builder_s']:.4f} s; peak "
          f"device memory beyond what was allocated before: the chain "
          f"{res['chain_peak_gb']:.4f} GB, the whole builder "
          f"{res['peak_gb']:.4f} GB (outputs included); profiled call: no "
          f"sort, kernels {res['profiled_kernels']}")
    return res


def heavy_soup(meshgen, n):
    """The cells of tet_box_mesh(10, 10, 10) on the unit box and of
    tet_box_mesh(n, n, n) scaled to side 0.01 and centred on one bin's
    center (SOUP_KW's bin grid): the builder's host inputs."""
    from interpolate_unstructured_tpu_torch.ops import geometry

    big = meshgen.tet_box_mesh(10, 10, 10)
    n_target = min(int(SOUP_KW["bins_per_cell"] * (len(big[1]) + 6 * n ** 3)),
                   SOUP_KW["max_bins"])
    _, h, _, _ = geometry._bin_grid_shape(np.zeros(3), np.ones(3), 3,
                                          n_target)
    center = (np.floor(np.array([0.53, 0.47, 0.51]) / h) + 0.5) * h
    pts, cells, nbrs = meshgen.tet_box_mesh(n, n, n)
    small = (center - 0.005 + 0.01 * pts, cells, nbrs)
    parts = [host_geometry(*mesh, "tetra")[:3] for mesh in (big, small)]
    cp, normals, offs = (np.concatenate(a) for a in zip(*parts))
    return cp, normals, offs, np.zeros(3), np.ones(3), 3


def soup_check(dev, meshgen, counters, card):
    """The heavy-bin soup on the card: build_candidate_bins_device (the
    main path) with one bin past D2's shared-memory route, its tables
    torch.equal to the plain versions' and each stage to its plain
    version.  Returns the main path's launches."""
    from interpolate_unstructured_tpu_torch.ops import cand_build
    from interpolate_unstructured_tpu_torch.ops import cand_build_kernel as bk

    args = heavy_soup(meshgen, SOUP_N)
    out, counts = main_path(lambda: cand_build.build_candidate_bins_device(
        *args, SOUP_K, torch.float32, **SOUP_KW, device=dev), counters)
    launches = builder_launches(counts)
    check(launches == {x: 1 for x in BUILDER_KERNELS},
          f"the soup's build launched D1/D2 {launches}")
    p, *_ = cand_build.prepare_pairs(
        *args, torch.float32, SOUP_KW["bins_per_cell"],
        SOUP_KW["max_bins"], SOUP_KW["eps"], dev)
    m = builder_match("heavy-bin soup", p, SOUP_K, SOUP_KW["ext_max_k"],
                      (out[0], out[1], out[6], out[5]))
    check(m["max_count"] > 16384, "the soup's worst bin fits D2's shared "
          "memory route")
    k_ext = m["k_ext"]

    def order():
        return bk.order_tables_cuda(m["rec"], m["start"], m["counts"],
                                    m["slot"], len(args[0]), SOUP_K, k_ext,
                                    m["n_over"], m["max_count"])

    ms = cuda_ms(order, 5)
    print(f"heavy-bin soup: tet_box_mesh(10,10,10) + tet_box_mesh({SOUP_N},"
          f"{SOUP_N},{SOUP_N}) at side 0.01 in one bin, {len(args[0])} tets, "
          f"bins {p.bin_shape}, {m['n_kept']} kept pairs, worst bin "
          f"{m['max_count']} (D2's rank route), "
          f"{int((m['counts'] > 32).sum())} bins above 32; build launches "
          f"{json.dumps(launches)}; D2 {ms:.4f} ms; every stage and the "
          f"built tables torch.equal to the plain versions [{card}]")
    del out, m
    return launches


def builder_phase(dev, tiu, meshgen, counters, card):
    """The device candidate builder beside the host builder: on a box just
    above cand_build_device_min_cells every host pair lies in its bin's
    device list, and "auto" builds that box on the card, its stages held
    to their plain versions; the heavy-bin soup on the card; a strongly
    graded mesh goes to the host builder under "auto" (the threshold
    lowered to its size), and "device" raises on it."""
    from interpolate_unstructured_tpu_torch.ops import cand_build, geometry

    res = {"launches": {x: 0 for x in BUILDER_KERNELS}}
    n = 26
    pts, cells, nbrs = meshgen.tet_box_mesh(n, n, n)
    cfg = tiu.IUConfig()
    check(len(cells) >= cfg.cand_build_device_min_cells,
          "the containment box is below the device builder's threshold")
    grid, counts = main_path(lambda: tiu.build_grid(
        pts, cells, nbrs, "tetra", point_data={"Polynomial": pts.sum(1) + 1.0},
        dtype=torch.float32, locate_mode="walk", device=dev), counters)
    launches = builder_launches(counts)
    check(min(launches.values()) >= 1, f"auto did not build the "
          f"{len(cells)}-tet box on the card: {launches}")
    add_counts(res["launches"], launches)
    builder_grid_match(f"builder box, {len(cells)} tets", grid, pts, cells,
                       nbrs, dev)
    args = host_geometry(pts, cells, nbrs, "tetra")
    k = 64  # above every bin's count: complete lists on both sides
    cfg = grid.config
    kw = dict(bins_per_cell=cfg.cand_bins_per_cell,
              max_bins=cfg.cand_max_bins, eps=2.0 * cfg.eps_inside)
    t0 = time.perf_counter()
    host = geometry.build_candidate_bins(*args, k, **kw)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    devb = cand_build.build_candidate_bins_device(*args, k, torch.float32,
                                                  **kw, device=dev)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    check(devb[2] == host[2], "the builders' bin grids differ")
    h_count, d_count = host[1], devb[1].cpu().numpy()
    check(max(h_count.max(), d_count.max()) <= k,
          "a bin overflows the containment check's K")
    check(bool((d_count >= h_count).all()), "a bin has fewer device "
          "candidates than host candidates")
    n_cells = len(cells)

    def pair_codes(ids):
        b, j = np.nonzero(ids >= 0)
        return b.astype(np.int64) * n_cells + ids[b, j]

    h_pairs, d_pairs = pair_codes(host[0]), pair_codes(devb[0].cpu().numpy())
    check(bool(np.isin(h_pairs, d_pairs).all()),
          "a host pair is missing from its bin's device list")
    res.update(host_s=host_s, device_s=dev_s, host_pairs=len(h_pairs),
               device_pairs=len(d_pairs))
    print(f"builder containment, tet_box_mesh({n},{n},{n}) = {n_cells} tets "
          f"(auto: D1/D2 launches {json.dumps(launches)}): all "
          f"{len(h_pairs)} host pairs in their bins' device lists "
          f"({len(d_pairs)} device pairs); host "
          f"builder {host_s:.3f} s, device builder {dev_s:.3f} s [{card}]")
    del grid, devb
    res["soup_launches"] = soup_check(dev, meshgen, counters, card)
    add_counts(res["launches"], res["soup_launches"])

    # A strongly graded mesh: one cell spans the whole domain
    pts, cells, nbrs = meshgen.tet_box_mesh(4, 4, 4)
    pts = pts.copy()
    pts[0] = [50.0, 50.0, 50.0]
    host_calls = []
    real_host = geometry.build_candidate_bins

    def counting_host(*a, **kw):
        host_calls.append(1)
        return real_host(*a, **kw)

    auto = tiu.IUConfig(cand_build_device_min_cells=1)
    geometry.build_candidate_bins = counting_host
    try:
        _, counts = main_path(lambda: tiu.build_grid(
            pts, cells, nbrs, "tetra", dtype=torch.float32,
            locate_mode="walk", config=auto, device=dev), counters)
    finally:
        geometry.build_candidate_bins = real_host
    check(host_calls == [1] and not any(builder_launches(counts).values()),
          "the graded mesh was not built by the host builder under auto")
    try:
        tiu.build_grid(pts, cells, nbrs, "tetra", dtype=torch.float32,
                       locate_mode="walk", device=dev,
                       config=tiu.IUConfig(cand_build="device"))
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None and "offset budget" in raised,
          "cand_build='device' did not raise on the graded mesh")
    print(f"builder decline: the graded {len(cells)}-tet mesh built by the "
          f"host builder under auto (threshold 1), cand_build='device' "
          f"raised: {raised}")
    return res


def candidate_phase(dev, tiu, meshgen, interp_kernel, locate, cand_kernel,
                    walk_kernel):
    from interpolate_unstructured_tpu_torch.ops import (
        cand_build_kernel,
        icell_kernel,
    )

    counters = (interp_kernel, cand_kernel, walk_kernel, icell_kernel)
    res = {}
    n = 55
    t0 = time.perf_counter()
    pts, cells, nbrs = meshgen.tet_box_mesh(n, n, n)
    mesh_s = time.perf_counter() - t0
    timings = {}
    t0 = time.perf_counter()
    grid, counts = main_path(lambda: tiu.build_grid(
        pts, cells, nbrs, "tetra", point_data={"Polynomial": pts.sum(1) + 1.0},
        dtype=torch.float32, locate_mode="walk", device=dev, timings=timings,
    ), counters + (cand_build_kernel,))
    build_s = time.perf_counter() - t0
    res["build_s"], res["timings"] = build_s, timings
    res["builder_launches"] = builder_launches(counts)
    check(min(res["builder_launches"].values()) >= 1,
          f"build_grid of the 998k-tet box did not launch D1 and D2: "
          f"{res['builder_launches']}")
    k = grid.cand_ids.shape[1]
    print(f"B2 mesh tet_box_mesh({n},{n},{n}): {grid.n_cells} tets, "
          f"meshgen {mesh_s:.3f} s; build_grid {build_s:.3f} s split "
          + json.dumps({kk: round(v, 4) for kk, v in timings.items()})
          + f"; table {tuple(grid.cand_table.shape)} K={k} "
          f"ext={grid.cand_ext_table is not None} qeps={grid.cand_qeps:.3e}; "
          f"device candidate builder launches "
          + json.dumps(res["builder_launches"]))
    check(grid.cand_table is not None and grid.cand_ext_covers,
          "998k-tet grid has no covering candidate table")
    res["builder"] = builder_check(dev, grid, pts, cells, nbrs)

    r = torch.from_numpy(
        np.random.default_rng(2).random((N_CAND, 3)).astype(np.float32)
    ).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (vals, ic, found), counts = main_path(
        lambda: tiu.interpolate_scalar_at(grid, r, 0, fill_value=0.0),
        counters,
    )
    first_s = time.perf_counter() - t0
    ck = cand_kernel.__name__
    res["ext_launches"] = counts[f"{ck}:ext"]  # grids with extension rows
    res["binned"] = {x: counts[f"{ck}:{x}"]
                     for x in ("bin_pass", "bin_scatter", "binned",
                               "bin_unsort")}
    check(min(res["binned"].values()) >= 1,
          f"the bin-ordered B2 kernels were not all launched on the cold "
          f"call: {res['binned']}")
    check(bool(found.all()), f"{int((~found).sum())} of 10M queries not found")
    lin = float((vals.double() - (r.double().sum(1) + 1.0)).abs().max())
    check(lin <= LIN_TOL, f"998k-tet linear-exactness error {lin}")
    # for the oracle phase: the first 1M and the float64 arrays the grid
    # was built from
    res["oracle"] = dict(
        cold=dict(oracle_sample(r, (vals, ic, found), slice(0, ORACLE_N)),
                  band=oracle_band(grid, pts)),
        mesh=oracle_mesh(grid, pts, pts.sum(1) + 1.0))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        tiu.interpolate_scalar_at(grid, r, 0, fill_value=0.0)
    torch.cuda.synchronize()
    e2e = (time.perf_counter() - t0) / reps
    res["oracle"]["rate"] = N_CAND / e2e
    print(f"B2 10M cold interpolate_scalar_at: first call {first_s:.4f} s, "
          f"steady {e2e * 1e3:.4f} ms = {N_CAND / e2e:.4e} queries/s; "
          f"all found; linear error {lin:.3e}")

    res.update(b2_front_end(dev, grid, r, k, cand_kernel, locate))
    del vals, found

    # Warm on the candidate grid: the points moved, guessed by the cold
    # cells, plus 1% pushed out of the box with in-mesh guesses.  Every
    # query takes the candidate probe (B2); the misses walk from their
    # guess (B3) and report the walk's boundary code.
    rng = np.random.default_rng(5)
    vel = torch.from_numpy(rng.random((N_CAND, 3)).astype(np.float32)).to(dev)
    r_in = 0.005 + 0.98 * r + 0.01 * vel
    n_out = N_CAND // 100
    r_out = r_in[:n_out].clone()
    r_out[:, 1] = 1.01 + 0.5 * torch.from_numpy(
        rng.random(n_out).astype(np.float32)).to(dev)
    rq_all = torch.cat([r_in, r_out])
    guess = torch.cat([ic, ic[:n_out]])
    del vel, r_out
    (vals, ic_w, found), counts = main_path(
        lambda: tiu.interpolate_scalar_at(grid, rq_all, 0, guess=guess,
                                          fill_value=FILL),
        counters,
    )
    n_b2 = counts[f"{ck}:binned"]
    n_b3 = counts[f"{walk_kernel.__name__}:get_cell"]
    res["e1_launches"] = counts[icell_kernel.__name__]
    check(n_b2 >= 1 and n_b3 >= 1 and res["e1_launches"] >= 1,
          f"candidate warm path launched B2 in bin order {n_b2}, get_cell's "
          f"walk {n_b3}, E1 {res['e1_launches']} times")
    for x in res["binned"]:
        res["binned"][x] += counts[f"{ck}:{x}"]
    res["ext_launches"] += counts[f"{ck}:ext"]
    res["gc_launches"] = n_b3
    check(bool(found[:N_CAND].all()), "candidate warm: an inside query was lost")
    check(not bool(found[N_CAND:].any()), "candidate warm: outside query found")
    check(bool((ic_w[N_CAND:] < 0).all() and (vals[N_CAND:] == FILL).all()),
          "candidate warm: outside queries lack a boundary code or the fill")
    lin = float((vals[:N_CAND].double() - (r_in.double().sum(1) + 1.0))
                .abs().max())
    check(lin <= LIN_TOL_ICELL,
          f"candidate warm linear-exactness error {lin}")
    e2e_w = steady_s(lambda: tiu.interpolate_scalar_at(
        grid, rq_all, 0, guess=guess, fill_value=FILL), 3)
    print(f"B2+B3 candidate grid, {rq_all.shape[0]} warm queries (1% "
          f"outside): steady {e2e_w * 1e3:.4f} ms = "
          f"{rq_all.shape[0] / e2e_w:.4e} queries/s; B2 bin-ordered probe "
          f"launches {n_b2}, get_cell walk launches {n_b3}, E1 launches "
          f"{res['e1_launches']}; linear error {lin:.3e}")
    res["grid"] = grid  # the accurate phase prepares it
    del vals, ic, ic_w, found, r, r_in, rq_all, guess, grid
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
    (vals, ic, found), counts = main_path(
        lambda: tiu.interpolate_scalar_at(grid, r, 0),
        (interp_kernel, cand_kernel, walk_kernel))
    n_ext = counts[f"{ck}:ext"]
    check(n_ext >= 1, "the extension rows were not probed by the probe in "
          "bin order")
    check(counts[f"{ck}:binned"] == 0, "the extension grid launched the "
          "main rows' probe without its extension rows")
    res["ext_launches"] += n_ext
    for x in res["binned"]:
        res["binned"][x] += counts[f"{ck}:{x}"]
    # clear of the boundary by far more than the inside tolerance
    strict = ((r > 1e-4) & (r < 1 - 1e-4)).all(1)
    outside = ((r < -1e-4) | (r > 1 + 1e-4)).any(1)
    check(bool(found[strict].all()), "extension grid: an interior query was lost")
    check(not bool(found[outside].any()), "extension grid: outside query found")
    lin = float((vals[found].double() - (r[found].double().sum(1) + 1)).abs().max())
    check(lin <= LIN_TOL, f"extension grid linear-exactness error {lin}")
    e2e = steady_s(lambda: tiu.interpolate_scalar_at(grid, r, 0), 5)
    res["ext"] = ext_check(f"B2 extension grid ({grid.n_cells} tets)", grid,
                           r, cand_kernel, locate)
    print(f"B2 extension grid ({grid.n_cells} tets): {N_CMP} cold "
          f"interpolate_scalar_at steady {e2e * 1e3:.4f} ms; probe launches "
          f"with the extension rows {n_ext}; linear error {lin:.3e}")
    return res


def near_face(grid, r, ic, band):
    """Whether each position lies within ``band`` of a face plane of its
    cell (negative cells never qualify)."""
    c = ic.clamp_min(0).long()
    n = grid.face_normals[c]
    m = grid.face_offsets[c] - (
        (n[..., 0] * r[:, 0, None] + n[..., 1] * r[:, 1, None])
        + n[..., 2] * r[:, 2, None]
    )
    return (ic >= 0) & (m.abs().amin(dim=1) <= band)


def walk_compare(name, grid, kout, pout):
    """B3 vs plain: ic, status and steps identical on >= AGREE of the
    lanes, every disagreement a near-tie (the final position within
    4 eps_inside of a face of either final cell), positions within
    RP_TOL where the walks agree.  Returns max |r_p diff| there."""
    kic, krp, ksteps, kst = kout
    pic, prp, psteps, pst = pout
    same = (kic == pic) & (kst == pst) & (ksteps == psteps)
    bad = torch.nonzero(~same).squeeze(1)
    n_bad = int(bad.numel())
    check(n_bad <= (1 - AGREE) * same.numel(),
          f"{name}: {n_bad} of {same.numel()} walks differ")
    if n_bad:
        band = 4 * grid.config.eps_inside
        near = near_face(grid, krp[bad], kic[bad], band) | near_face(
            grid, prp[bad], pic[bad], band)
        check(bool(near.all()), f"{name}: a disagreement is not a near-tie")
    err = float((krp[same] - prp[same]).abs().max()) if same.any() else 0.0
    check(err <= RP_TOL, f"{name}: final positions differ by {err}")
    print(f"{name}: kernel vs plain: {n_bad} of {same.numel()} walks differ; "
          f"max |r_p diff| {err:.3e}")
    return err


def walk_origin(grid, starts, walk_kernel):
    """Centers of the cells ``starts``, the origins of walks from them."""
    return walk_kernel.walk_origin(grid.walk_table, starts,
                                   grid.n_faces_per_cell,
                                   grid.n_points_per_cell)


def old_get_cell_walk(grid, r, start, max_steps, p1, locate, walk_kernel):
    """get_cell's walk stage as the port ran it before the fused kernel,
    built from its pieces: the seed row or the start cell's center,
    ``_walk_args``, a phase-1 ``walk_cuda`` launch, then the stragglers
    gathered, walked again by a second launch and scattered back."""
    if start is None:
        g = grid.bin_pack[walk_kernel.seed_bins(grid, r)]
        start, r0 = g[:, 0].to(torch.int32), g[:, 1:4]
    else:
        r0 = walk_origin(grid, start.clamp_min(0), walk_kernel)
    ic, rp, _, st = walk_kernel.walk_cuda(
        *locate._walk_args(grid, r0, r, start, p1 or max_steps))
    found = (st == walk_kernel.STATUS_ARRIVED) & (ic >= 0)
    sel = torch.nonzero(st == walk_kernel.STATUS_STEP_CAP).squeeze(1)
    if p1 and sel.numel():
        ic_o, _, _, st_o = walk_kernel.walk_cuda(*locate._walk_args(
            grid, rp[sel], r[sel], ic[sel], max_steps - p1))
        ic[sel] = ic_o
        found[sel] = (st_o == walk_kernel.STATUS_ARRIVED) & (ic_o >= 0)
    return torch.where(found, ic, torch.clamp_max(ic, -1)), found


def gc_bound(grid, r, start, max_steps, p1, walk_kernel, bound_fn=bound):
    """(bound, rounds, distinct walk rows) of get_cell's walk stage on
    these inputs, each byte once: per query r and its start cell in, ic
    and found out; the nf*5 walk floats of every distinct cell visited;
    the vertex block of every distinct start cell (or the 16-byte
    bin_pack row of every distinct seed bin); ~12 flops per face and
    round.  The rows come from a run of the plain version on a recording
    table.  Sizes scale with the grid's element size (float64: 8 bytes);
    ``bound_fn`` takes the operations at the dtype's rate."""
    rec = RowRecorder(grid.walk_table)
    walk_kernel.get_cell_walk_plain(
        dataclasses.replace(grid, walk_table=rec), r, start, max_steps, p1)
    nf, npc = grid.n_faces_per_cell, grid.n_points_per_cell
    rounds = sum(int(i.numel()) for c, i in rec.seen if c == 0)
    walk_rows = rec.distinct(0)
    n = r.shape[0]
    e = grid.walk_table.element_size()
    if start is None:
        seeds = walk_kernel.seed_bins(grid, r)
        n_bytes = n * (3 * e + 5) + int(torch.unique(seeds).numel()) * 4 * e
    else:
        n_bytes = n * (3 * e + 4 + 5) + rec.distinct(nf * 5) * npc * 3 * e
    n_bytes += walk_rows * nf * 5 * e
    return bound_fn(n_bytes, rounds * nf * 12), rounds, walk_rows


# Operations of E1 a query before its sums, and a variable's sum (npc
# products, npc - 1 additions), by cell type: the tet's 21 differences,
# four triple products of 14, the reciprocal of 6 * volume and 4
# products; the triangle's three areas of 21 (with the square root),
# the reciprocal times 0.5 and 3 products; the quad weights of wkern.cuh
E1_OPS = {"tetra": (83, 7), "triangle": (68, 5), "quad": (57, 7)}


def e1_phase(label, grid, r, slots, ic, bound_fn):
    """Kernel E1 against interpolate_at_icell_plain on these inputs,
    torch.equal, then both timed by CUDA events in turns (plain, kernel,
    kernel, plain), and E1's bound, each byte once: per query its
    position and cell in and its values out; the connectivity of every
    distinct cell and its volume (none for a quad, whose weights do not
    read it); the coordinates and the requested data of every distinct
    vertex.  Prints the bytes of the tables E1 reads (connectivity,
    volumes, points, the requested point-data columns) beside the
    card's L2.  Returns {"max_abs_err", "ms", "plain_ms", "turns",
    "bound", "cells", "points", "table_bytes"}."""
    from interpolate_unstructured_tpu_torch.ops import icell_kernel
    from interpolate_unstructured_tpu_torch.ops.interp import (
        interpolate_at_icell_plain,
    )

    got = icell_kernel.interpolate_at_icell_cuda(grid, r, slots, ic)
    want = interpolate_at_icell_plain(grid, r, slots, ic)
    n_bad = equal_or_fail(f"E1 {label}", (got,), (want,))
    del got, want
    t = turns({
        "plain": lambda: interpolate_at_icell_plain(grid, r, slots, ic),
        "kernel": lambda: icell_kernel.interpolate_at_icell_cuda(
            grid, r, slots, ic),
    }, 5)
    cells = torch.unique(ic.clamp_min(0))
    n_cells = int(cells.numel())
    n_points = int(torch.unique(grid.cells[cells.long()]).numel())
    npc = grid.n_points_per_cell
    e = grid.point_data.element_size()
    b, v = r.shape[0], len(slots)
    vol = 0 if grid.cell_type == "quad" else e
    n_bytes = (b * (3 * e + 4 + v * e) + n_cells * (vol + npc * 4)
               + n_points * (3 + v) * e)
    per, per_var = E1_OPS[grid.cell_type]
    bnd = bound_fn(n_bytes, b * (per + per_var * v))
    # the tables E1 reads at random, whole, beside the card's L2
    tables = {"cells": grid.cells.numel() * 4,
              "cell_volume": 0 if vol == 0 else grid.n_cells * e,
              "points": grid.points.numel() * e,
              "point_data": grid.n_points * v * e}
    l2 = getattr(torch.cuda.get_device_properties(r.device),
                 "L2_cache_size", 0)
    res = dict(max_abs_err=float(n_bad), ms=sum(t["kernel"]) / 2,
               plain_ms=sum(t["plain"]) / 2, turns=t, bound=bnd,
               cells=n_cells, points=n_points, table_bytes=tables)
    print(f"E1 interp_icell, {label}: {b} queries, {v} variable(s), "
          f"{n_cells} distinct cells, {n_points} distinct vertices; "
          f"torch.equal to interpolate_at_icell_plain; CUDA events in turns: "
          f"plain {t['plain'][0]:.4f} / {t['plain'][1]:.4f} ms, kernel "
          f"{t['kernel'][0]:.4f} / {t['kernel'][1]:.4f} ms; bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}); tables read "
          + ", ".join(f"{k} {x / 1e6:.3f}" for k, x in tables.items())
          + f" = {sum(tables.values()) / 1e6:.3f} MB against the L2's "
          f"{l2 / 1e6:.3f} MB (walk rows, not read: "
          f"{grid.walk_table.numel() * e / 1e6:.3f} MB)")
    return res


def walk_phase(dev, tiu, meshgen, interp_kernel, locate, cand_kernel,
               walk_kernel, io_res):
    """bench.py's warm protocol on the 998,250-tet box without candidate
    tables, the grid that the io phase read from its file: every query
    walks (get_cell's walk stage, kernel B3), then interpolates in the
    cell it reached (kernel E1)."""
    from interpolate_unstructured_tpu_torch.ops import icell_kernel, wkern

    counters = (interp_kernel, cand_kernel, walk_kernel, icell_kernel)
    gc_key = f"{walk_kernel.__name__}:get_cell"
    ik = icell_kernel.__name__
    res = {"gc_launches": {}, "e1_launches": {}}
    grid = io_res.pop("walk_grid")
    check(grid.cand_table is None, "walk grid has candidate tables")
    res["gc_launches"]["refine"] = io_res["refine_launches"]
    n_bins = int(np.prod(grid.bin_shape))
    print(f"B3 walk grid, the 55^3 box that read_grid read from its .binda "
          f"(io phase), no candidate tables: {n_bins} seed bins "
          f"{grid.bin_shape} self-located by the refine "
          f"({res['gc_launches']['refine']} get_cell walk launches)")

    rng = np.random.default_rng(4)
    r = torch.from_numpy(
        (0.1 + 0.8 * rng.random((N_CAND, 3))).astype(np.float32)).to(dev)
    vel = torch.from_numpy(rng.random((N_CAND, 3)).astype(np.float32)).to(dev)
    r_warm = r + 0.01 * vel
    del vel

    def truth(q):
        return q.double().sum(1) + 1.0

    (vals, ic, found), counts = main_path(
        lambda: tiu.interpolate_scalar_at(grid, r, 0, fill_value=FILL),
        counters)
    res["gc_launches"]["cold"] = counts[gc_key]
    res["e1_launches"]["cold"] = counts[ik]
    check(res["gc_launches"]["cold"] >= 1 and counts[ik] >= 1,
          "get_cell's walk stage or E1 was not launched on the cold call")
    check(bool(found.all()), f"{int((~found).sum())} cold queries not found")
    lin_c = float((vals.double() - truth(r)).abs().max())
    check(lin_c <= LIN_TOL_ICELL, f"cold walk linear-exactness error {lin_c}")
    cold_s = steady_s(lambda: tiu.interpolate_scalar_at(grid, r, 0), 3)

    (vals, ic_w, found), counts = main_path(
        lambda: tiu.interpolate_scalar_at(grid, r_warm, 0, guess=ic,
                                          fill_value=FILL),
        counters)
    res["gc_launches"]["warm"] = counts[gc_key]
    res["e1_launches"]["warm"] = counts[ik]
    check(res["gc_launches"]["warm"] >= 1 and counts[ik] >= 1,
          "get_cell's walk stage or E1 was not launched on the warm call")
    check(bool(found.all()), f"{int((~found).sum())} warm queries not found")
    lin_w = float((vals.double() - truth(r_warm)).abs().max())
    check(lin_w <= LIN_TOL_ICELL, f"warm walk linear-exactness error {lin_w}")
    warm_sample = oracle_sample(r_warm, (vals, ic_w, found),
                                slice(0, ORACLE_N - N_OFF), guess=ic)
    warm_s = steady_s(
        lambda: tiu.interpolate_scalar_at(grid, r_warm, 0, guess=ic), 3)
    res["cold_s"], res["warm_s"] = cold_s, warm_s
    # The reference's tetra weights (triple products over 6 * volume)
    # against the same triple products over their own sum: the share of
    # the linear error that the volume normalization causes
    cp = grid.cell_points[ic_w.long()]
    v = [[cp[:, k, d] for d in range(3)] for k in range(4)]
    t = wkern.tetra_triples(v, [r_warm[:, d] for d in range(3)],
                            wkern.Plain(torch.float32))
    vv = grid.point_data[:, 0][grid.cells[ic_w.long()].long()]
    t_sum = (t[0] + t[1]) + (t[2] + t[3])
    acc = t[0] / t_sum * vv[:, 0]
    for k in range(1, 4):
        acc = acc + t[k] / t_sum * vv[:, k]
    lin_sum = float((acc.double() - truth(r_warm)).abs().max())
    del cp, v, t, vv, t_sum, acc
    print(f"B3 warm linear error {lin_w:.3e} with the reference's tetra "
          f"weights, {lin_sum:.3e} with the triple products over their sum")
    # split: locate (seed + walk stage) and interpolate_at_icell (E1)
    loc_c = steady_s(lambda: tiu.get_cell(grid, r), 3)
    loc_w = steady_s(lambda: tiu.get_cell(grid, r_warm, ic), 3)
    icell = steady_s(lambda: tiu.interpolate_at_icell(grid, r_warm, [0], ic_w),
                     3)
    # the walk stage's share of get_cell: event pairs around it
    for label, call, loc_s in (
        ("cold", lambda: tiu.get_cell(grid, r), loc_c),
        ("warm", lambda: tiu.get_cell(grid, r_warm, ic), loc_w),
    ):
        walks = {}
        with recorded_calls(walk_kernel, "get_cell_walk", walks):
            call()
        print(f"B3 get_cell walk stage of one 10M {label} get_cell (CUDA "
              "events): "
              + ", ".join(f"{a[1].shape[0]} queries {ms:.4f} ms"
                          for (a, _), ms in zip(walks["inputs"], walks["ms"]))
              + f"; {sum(walks['ms']):.4f} ms of {loc_s * 1e3:.4f} ms")
    print(f"B3 10M cold interpolate_scalar_at (bin-seeded walks): steady "
          f"{cold_s * 1e3:.4f} ms = {N_CAND / cold_s:.4e} queries/s "
          f"(get_cell {loc_c * 1e3:.4f} ms); linear error {lin_c:.3e}")
    print(f"B3 10M warm interpolate_scalar_at (guess = cold cells, moved "
          f"by 0.01 * velocity): steady {warm_s * 1e3:.4f} ms = "
          f"{N_CAND / warm_s:.4e} queries/s (get_cell {loc_w * 1e3:.4f} ms, "
          f"interpolate_at_icell {icell * 1e3:.4f} ms); linear error "
          f"{lin_w:.3e}")

    # Off-domain: warm queries pushed out of the box, in-mesh guesses
    r_off = r_warm[:N_OFF].clone()
    r_off[:, 0] = 1.01 + 0.5 * torch.from_numpy(
        rng.random(N_OFF).astype(np.float32)).to(dev)
    g_off = ic_w[:N_OFF]
    (v_off, ic_off, f_off), counts = main_path(
        lambda: tiu.interpolate_scalar_at(grid, r_off, 0, guess=g_off,
                                          fill_value=FILL),
        counters)
    res["gc_launches"]["off_domain"] = counts[gc_key]
    res["e1_launches"]["off_domain"] = counts[ik]
    check(not bool(f_off.any()), "an off-domain query was found")
    check(bool((ic_off < 0).all() and (v_off == FILL).all()),
          "off-domain queries lack a boundary code or the fill")
    with plain_walks(walk_kernel):
        ic_off_p, f_off_p = tiu.get_cell(grid, r_off, g_off)
    check(torch.equal(ic_off, ic_off_p) and not bool(f_off_p.any()),
          "off-domain boundary codes differ from the plain walk's")
    print(f"B3 {N_OFF} off-domain warm queries: none found, boundary codes "
          f"{torch.unique(ic_off).tolist()} equal the plain walk's")
    # for the oracle phase: 900,000 warm and the 100,000 off-domain
    # queries with their guesses, on the grid's own float32 points
    off = oracle_sample(r_off, (v_off, ic_off, f_off), slice(None),
                        guess=g_off)
    mesh = oracle_mesh(grid)
    res["oracle"] = dict(
        mesh=mesh, rate=N_CAND / warm_s,
        warm=dict({k: np.concatenate([warm_sample[k], off[k]])
                   for k in off}, band=oracle_band(grid, mesh[0])))

    # get_cell's walk stage against its plain version, bit for bit, on
    # all 10M warm and 10M cold queries, with get_cell's two phases
    max_steps = grid.config.max_walk_steps
    p1 = grid.config.walk_phase1_steps
    gc_err = 0  # entries of (ic, found) that differ from the plain version
    for label, q, st in (("warm", r_warm, ic), ("cold", r, None)):
        k_out = walk_kernel.get_cell_walk_cuda(grid, q, st, max_steps, p1)
        p_out = walk_kernel.get_cell_walk_plain(grid, q, st, max_steps, p1)
        o_out = old_get_cell_walk(grid, q, st, max_steps, p1, locate,
                                  walk_kernel)
        for name, a, b, c in zip(("ic", "found"), k_out, p_out, o_out):
            n_bad = int((a != b).sum())
            gc_err += n_bad
            check(torch.equal(a, b), f"B3 get_cell walk, {label}: {name} "
                  f"differs from the plain version on {n_bad} queries")
            check(torch.equal(a, c), f"B3 get_cell walk, {label}: {name} "
                  "differs from the composition it replaces")
        print(f"B3 get_cell walk, {N_CAND} {label} queries (p1 = {p1}): "
              f"(ic, found) torch.equal to get_cell_walk_plain and to the "
              f"earlier composition")
    del k_out, p_out, o_out

    # timing in turns: the earlier composition against the fused stage
    t_gc = {}
    for label, q, st in (("warm", r_warm, ic), ("cold", r, None)):
        t_gc[label] = turns({
            "old": lambda: old_get_cell_walk(grid, q, st, max_steps, p1,
                                             locate, walk_kernel),
            "new": lambda: walk_kernel.get_cell_walk_cuda(grid, q, st,
                                                          max_steps, p1),
        }, 10)
    ms_gc_p = cuda_ms(lambda: walk_kernel.get_cell_walk_plain(
        grid, r_warm, ic, max_steps, p1), 2)
    bnd_w, rounds_w, rows_w = gc_bound(grid, r_warm, ic, max_steps, p1,
                                       walk_kernel)
    bnd_c, rounds_c, rows_c = gc_bound(grid, r, None, max_steps, p1,
                                       walk_kernel)
    for label, bnd_, rounds, rows in (("warm", bnd_w, rounds_w, rows_w),
                                      ("cold", bnd_c, rounds_c, rows_c)):
        t = t_gc[label]
        print(f"B3 get_cell walk, {N_CAND} {label} queries, CUDA events in "
              f"turns: earlier composition {t['old'][0]:.4f} / "
              f"{t['old'][1]:.4f} ms, fused stage {t['new'][0]:.4f} / "
              f"{t['new'][1]:.4f} ms; bound {bnd_[0]:.4f} ms ({bnd_[1]}; "
              f"{rounds} rounds, {rows} distinct walk rows)")
    print(f"B3 get_cell walk plain version, 10M warm: {ms_gc_p:.4f} ms")
    res["gc"] = dict(ms=sum(t_gc["warm"]["new"]) / 2, turns=t_gc,
                     plain_ms=ms_gc_p, bound=bnd_w, bound_cold=bnd_c,
                     max_abs_err=float(gc_err))
    # E1 against its plain version on the 10M warm queries in the cells
    # the warm call found
    res["e1"] = e1_phase("walk grid, 10M warm, float32", grid, r_warm, (0,),
                         ic_w, bound)

    # the explicit walk (walk_rows) against its plain version on the
    # first 1M warm lanes, then both timed on all 10M warm lanes (one
    # walk each, to the end), and the public walk() on them
    start = ic[:N_CMP]
    args = locate._walk_args(grid, walk_origin(grid, start, walk_kernel),
                             r_warm[:N_CMP], start)
    res["max_abs_err"] = walk_compare(
        "B3 walk_rows, 998k-tet warm walks, first 1M", grid,
        walk_kernel.walk_cuda(*args), walk_kernel.walk_rows_plain(*args))
    r0 = walk_origin(grid, ic, walk_kernel)
    args = locate._walk_args(grid, r0, r_warm, ic)
    steps = walk_kernel.walk_cuda(*args)[2]
    sum_steps = int(steps.sum())
    ms_k = cuda_ms(lambda: walk_kernel.walk_cuda(*args), 10)
    ms_p = cuda_ms(lambda: walk_kernel.walk_rows_plain(*args), 2)
    ms_walk = cuda_ms(lambda: tiu.walk(grid, r0, r_warm, ic), 10)
    res["bound"], res["bound_old"] = walk_bound(grid.walk_table, args[1:],
                                                walk_kernel,
                                                grid.n_faces_per_cell)
    res["ms"], res["plain_ms"], res["walk_ms"] = ms_k, ms_p, ms_walk
    print(f"B3 walk_rows, 998k-tet, 10M warm walks ({sum_steps / N_CAND:.4f} "
          f"steps per walk, max {int(steps.max())}; "
          f"{walk_kernel.walk_threads(N_CAND)} threads a block): kernel "
          f"{ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms, public walk() {ms_walk:.4f} ms (CUDA events); "
          f"bound {res['bound'][0]:.4f} ms ({res['bound'][1]}; with the "
          f"first design's inputs, u, total and active for r1, "
          f"{res['bound_old'][0]:.4f} ms)")
    res["grid"] = grid  # the trace phase traces on it
    return res


TRACE_N = (1024, 65_536)  # bench.py's bundle, and one that fills the card
TRACE_KW = dict(min_dx=1e-4, max_dx=0.05, max_steps=256, rtol=1e-3, atol=1e-3)
TRACE_TOL = 5e-5  # fused vs generic curves (tests/test_pallas_trace.py:74)
TRACE_DIFFER = 0.01  # share of lines whose step count or code may differ
TRACE_REPS = 5  # timed calls per bundle after the main-path call
B4_REPS = 5  # B4 launches timed on a bundle's loop inputs
WALK_REPS = 20  # B3 walk_rows launches timed at the generic trace's size


@contextlib.contextmanager
def recorded_calls(mod, name, out):
    """Inside the block every call of ``mod.<name>`` keeps clones of its
    tensor arguments in ``out["inputs"]`` and is timed with CUDA events;
    ``out["ms"]`` gets the times after the block."""
    real = getattr(mod, name)
    events = []

    def timed(*args, **kw):
        out.setdefault("inputs", []).append(
            ([a.clone() if torch.is_tensor(a) else a for a in args], kw))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = real(*args, **kw)
        end.record()
        events.append((start, end))
        return res

    setattr(mod, name, timed)
    try:
        yield
    finally:
        setattr(mod, name, real)
    torch.cuda.synchronize()
    out["ms"] = [s.elapsed_time(e) for s, e in events]


@contextlib.contextmanager
def generic_trace(trace_kernel):
    """Inside the block every trace takes the generic path (B3 + torch)."""
    real = trace_kernel.supported
    trace_kernel.supported = lambda *a: False
    try:
        yield
    finally:
        trace_kernel.supported = real


def device_busy(fn, tags):
    """One call of ``fn`` under ``torch.profiler``: (wall ms, ms of all
    device activity, {tag: ms of the kernels whose name holds tag}, number
    of device events), or None where the profiler records no device
    activity or fails (the share is then not measured).  Everything runs
    on one stream, so the device events do not overlap and their sum is
    the time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except Exception as err:  # a profiler fault is no fault of the port
        print(f"profiler: {err!r}")
        return None
    if not ev:
        return None
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    by_tag = {t: sum(e.time_range.elapsed_us() for e in ev if t in e.name)
              / 1e3 for t in tags}
    return wall * 1e3, busy, by_tag, len(ev)


def host_ops(fn, top):
    """The ``top`` torch ops by self host time in one call of ``fn``
    under the profiler (CPU activity only), as 'name ms xcalls'."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms "
                     f"x{e.count}" for e in rows[:top])


def kernel_ms(fn, tag, reps):
    """Device ms of one launch of the kernels named by ``tag`` among
    ``reps`` calls of ``fn``, by the profiler, and the CUDA-event ms per
    call around them (which also times the wrapper's host work): the
    first is None where the profiler records nothing."""
    ev_ms = cuda_ms(fn, reps)
    prof = device_busy(lambda: [fn() for _ in range(reps)], (tag,))
    return (None if prof is None else prof[2][tag] / reps), ev_ms


def trace_bound(grid, out, inputs, trace_kernel):
    """(bound_ms, bound_by) of one B4 call, each byte once: per line 33 B
    of start state in (y0, field0, ic0, done, code) and 12 B out (step
    count, code, iterations); the y and y_field rows the lines store;
    the nf*5 walk floats of every distinct row the rounds visit (from a
    run of the plain loop on a recording table); the vertex, volume and
    field floats of every distinct cell where an iteration's stages end
    (a subset of the cells where stages arrive, so the bound stays a
    lower bound); ~12 flops per face and round, ~100 per arrival (three
    for an iteration whose stages all arrive) and ~60 per line and
    iteration for k1, the error estimate and the step control."""
    nf, npc, ndim = grid.n_faces_per_cell, grid.n_points_per_cell, grid.ndim
    args, kw = inputs
    table, args = args[0], args[1:]
    rec = RowRecorder(table)
    real = trace_kernel.trace_plain
    stat = {"rounds": 0, "arrivals": 0, "iters": 0, "cells": []}

    def counted(tab, anchor, k1, dx, ic_start, act, **k):
        st = real(tab, anchor, k1, dx, ic_start, act, **k)
        ok = act & ~st.fail
        stat["rounds"] += int(st.rounds.sum())
        stat["arrivals"] += 3 * int(ok.sum())
        stat["iters"] += int(act.sum())
        stat["cells"].append(st.ic[ok])
        return st

    trace_kernel.trace_plain = counted
    try:
        trace_kernel.trace_loop_plain(rec, *args, **kw)
    finally:
        trace_kernel.trace_plain = real
    end_cells = int(torch.unique(torch.cat(stat["cells"])).numel())
    stored = int((out.n_steps.clamp(max=kw["max_steps"]) - 1).sum())
    n = out.n_steps.numel()
    n_bytes = (n * (33 + 12) + stored * ndim * 4 * 2
               + rec.distinct() * nf * 5 * 4
               + end_cells * (npc * 3 + 1 + npc * ndim) * 4)
    ops = (stat["rounds"] * nf * 12 + stat["arrivals"] * 100
           + stat["iters"] * 60)
    return bound(n_bytes, ops), stat


def walk_bound(table, args, walk_kernel, nf, bound_fn=bound):
    """(bound_ms, bound_by) of one B3 walk_rows call, each byte once: per
    lane r0, r1, ic0 in and ic, r_p, steps, status out (52 B in float32,
    88 in float64), the nf*5 leading elements of every distinct row
    visited; ~12 flops per face and step and ~15 per lane for the
    direction.  Also the bound with the first design's inputs (u, total
    and active in place of r1: 57 B in float32, 97 in float64) and no
    direction flops."""
    rec = RowRecorder(table)
    _, _, steps, _ = walk_kernel.walk_rows_plain(rec, *args)
    n, e = args[0].shape[0], table.element_size()
    rows = rec.distinct() * nf * 5 * e
    ops = int(steps.sum()) * nf * 12
    return (bound_fn(n * (9 * e + 16) + rows, ops + 15 * n),
            bound_fn(n * (10 * e + 17) + rows, ops))


def trace_phase(dev, tiu, grid, counters, walk_kernel, trace_kernel, tmp,
                card):
    """bench.py's trace_at_scale protocol on the walk phase's grid; the
    1024-line result then goes through write_trace_vtk."""
    from interpolate_unstructured_tpu_torch.ops import icell_kernel

    res = {"launches": 0, "gc_launches": 0, "e1_launches": 0}
    gc_key = f"{walk_kernel.__name__}:get_cell"
    ik = icell_kernel.__name__
    t0 = time.perf_counter()
    c = grid.points[:, :2] - 0.5
    fld = (-c[:, 1], c[:, 0], torch.full_like(c[:, 0], 0.25))
    i_field = []
    for name, v in zip(("vx", "vy", "vz"), fld):
        grid, i = tiu.add_point_data(grid, name, v, fuse=False)
        i_field.append(i)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = tiu.build_trace_table(grid, i_field)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    print(f"B4 trace phase on the {grid.n_cells}-tet walk grid: "
          f"add_point_data x3 (fuse=False) {add_s:.4f} s, build_trace_table "
          f"{table_s:.4f} s, table {tuple(table.shape)} "
          f"{table.numel() * table.element_size() / 2**20:.1f} MiB")
    kw = dict(TRACE_KW, trace_table=table)
    max_steps = kw["max_steps"]

    def trace(y0):
        return tiu.integrate_along_field(grid, y0, i_field, **kw)

    runs = {}
    res["max_abs_err"] = 0.0
    for n in TRACE_N:
        y0 = torch.from_numpy(0.3 + 0.4 * np.random.default_rng(3).random(
            (n, 3))).to(device=dev, dtype=torch.float32)
        trace(y0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts = main_path(lambda: trace(y0), counters)
        wall = time.perf_counter() - t0
        n_b4 = counts[trace_kernel.__name__]
        n_b3 = counts[gc_key]
        check(n_b4 == 1, f"{n} lines: {n_b4} B4 launches on the main path, "
              "not one")
        check(n_b3 >= 1, f"{n} lines: get_cell's walk stage was not "
              "launched for the start cells")
        check(counts[ik] == 1, f"{n} lines: {counts[ik]} E1 launches for "
              "the start field, not one")
        res["launches"] += n_b4
        res["gc_launches"] += n_b3
        res["e1_launches"] += counts[ik]
        rec = {}
        with recorded_calls(trace_kernel, "trace_loop", rec):
            out2 = trace(y0)
        for a, b in zip(out, out2):
            check(torch.equal(a, b), f"{n} lines: a second run differs")
        inputs = rec["inputs"][0]
        # the plain loop (trace_plain stages + step_control, a host loop)
        # on the same CUDA tensors: every field bit for bit
        p_out = trace_kernel.trace_loop_plain(*inputs[0], **inputs[1])
        for name, a, b in zip(out._fields, out, p_out):
            n_bad = int((a != b).reshape(a.shape[0], -1).any(1).sum()
                        if a.ndim else int(a != b))
            res["max_abs_err"] = max(res["max_abs_err"], float(
                (a.double() - b.double()).abs().max()))
            check(torch.equal(a, b), f"{n} lines: B4 {name} differs from "
                  f"the plain loop on {n_bad} lines")
        del p_out
        n_steps = out.n_steps
        steps = int(n_steps.clamp(max=max_steps).sum())
        bm = out.boundary_material
        codes = {int(k): int(v) for k, v in zip(*torch.unique(
            bm, return_counts=True))}
        check(tiu.trace.BM_STEP_CAP not in codes,
              f"{n} lines: {codes.get(tiu.trace.BM_STEP_CAP)} step-cap ends")
        check(bool(torch.isfinite(out.y).all()), f"{n} lines: non-finite y")
        # helix radius about the axis (0.5, 0.5) along each line
        idx = torch.arange(max_steps, device=dev)[None, :]
        valid = idx < n_steps.clamp(max=max_steps)[:, None]
        rad = torch.sqrt((out.y[..., 0] - 0.5) ** 2 + (out.y[..., 1] - 0.5) ** 2)
        drift = float(torch.where(valid, (rad - rad[:, :1]).abs(), 0.0).max())
        b4_ms = rec["ms"][0]
        print(f"B4 {n} lines: {steps} steps in {wall * 1e3:.4f} ms = "
              f"{steps / wall:.4e} trace steps/s; RK iterations "
              f"{int(out.n_iterations.max())}, n_rounds {int(out.n_rounds)}, "
              f"B4 launches {n_b4}, get_cell walk launches {n_b3}, E1 "
              f"launches {counts[ik]}; every "
              f"TraceResult field torch.equal to trace_loop_plain on the "
              f"card; trace_loop CUDA events {b4_ms:.4f} ms "
              f"({b4_ms / (wall * 1e3):.2%} of the wall time); mean steps "
              f"{steps / n:.2f}; boundary codes {json.dumps(codes)}; largest "
              f"helix radius drift {drift:.3e}")
        walls = []
        for _ in range(TRACE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trace(y0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(walls))
        print(f"B4 {n} lines, {TRACE_REPS} more calls: median {med:.4f} ms "
              f"(min {min(walls):.4f}, max {max(walls):.4f}) = "
              f"{steps / med * 1e3:.4e} trace steps/s")
        prof = device_busy(lambda: trace(y0),
                           ("trace_loop_kernel", "walk_kernel"))
        if prof is None:
            print(f"B4 {n} lines, profiled call: no device activity "
                  "recorded; device busy share not measured")
        else:
            p_wall, busy, by_tag, n_ev = prof
            print(f"B4 {n} lines, profiled call: wall {p_wall:.4f} ms, device "
                  f"busy {busy:.4f} ms over {n_ev} device events ({busy / p_wall:.2%}"
                  f" of the profiled wall, {busy / med:.2%} of the median "
                  f"wall); B4 kernel {by_tag['trace_loop_kernel']:.4f} ms, B3 "
                  f"kernels {by_tag['walk_kernel']:.4f} ms")
        # B4 alone on this bundle's loop inputs, and the setup before it
        (tab_, *args), kw0 = inputs

        def b4():
            return trace_kernel.trace_loop_cuda(tab_, *args, **kw0)

        k_ms, ev_ms = kernel_ms(b4, "trace_loop_kernel", B4_REPS)
        r0 = trace_kernel.pad3(y0)
        setup = {
            "get_cell": steady_s(lambda: tiu.get_cell(grid, r0), 5),
            "interpolate_at_icell": steady_s(
                lambda: tiu.interpolate_at_icell(grid, r0, i_field, args[2]),
                5),
            "trace_loop": steady_s(b4, 5),
        }
        print(f"B4 {n} lines alone: {'not measured' if k_ms is None else f'{k_ms:.4f} ms'} "
              f"(profiler device time), CUDA events {ev_ms:.4f} ms a call; "
              f"host clock of the call's parts: "
              + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in setup.items()))
        print(f"B4 {n} lines, host time by op in one call (torch.profiler, "
              f"self CPU ms, top 8): " + host_ops(lambda: trace(y0), 8))
        runs[n] = dict(out=out, y0=y0, inputs=inputs, wall=wall, med=med,
                       k_ms=k_ms if k_ms is not None else ev_ms, steps=steps)

    res["trace_vtk_s"] = trace_vtk_check(tiu, runs[TRACE_N[0]]["out"], tmp,
                                         card)
    # for the oracle phase: the fused trace of 1024 lines and its inputs
    small = runs[TRACE_N[0]]
    res["oracle"] = dict(out=trace_host(small["out"]), y0=host64(small["y0"]),
                         field=np.stack([host64(grid.point_data[:, i])
                                         for i in i_field], axis=1),
                         rate=small["steps"] / small["med"] * 1e3)

    # B4's numbers at 65,536 lines: the kernel, the plain loop, the bound
    big = runs[TRACE_N[-1]]
    (tab_, *args), kw0 = big["inputs"]
    res["ms"] = big["k_ms"]
    res["plain_ms"] = cuda_ms(lambda: trace_kernel.trace_loop_plain(
        tab_, *args, **kw0), 1)
    res["bound"], stat = trace_bound(grid, big["out"], big["inputs"],
                                     trace_kernel)
    res["e2e"] = {n: (runs[n]["med"], runs[n]["k_ms"]) for n in TRACE_N}
    print(f"B4 {TRACE_N[-1]} lines, one launch: kernel {res['ms']:.4f} ms, "
          f"plain loop {res['plain_ms']:.4f} ms, bound "
          f"{res['bound'][0]:.4f} ms ({res['bound'][1]}; {stat['rounds']} "
          f"rounds, {stat['iters']} line iterations)")

    # The fused trace against the generic one (B3 walk_rows + torch): the
    # main path of traces the fused kernel does not support (icell masks,
    # float64 on the CPU)
    small = runs[TRACE_N[0]]
    walks = {}
    with generic_trace(trace_kernel), recorded_calls(walk_kernel,
                                                     "walk_rows", walks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen, counts = main_path(lambda: trace(small["y0"]), counters)
        gen_s = time.perf_counter() - t0
    res["walk_launches"] = counts[walk_kernel.__name__]
    check(res["walk_launches"] >= 1,
          "the generic trace did not launch B3's explicit walk")
    check(counts[ik] == 1, f"the generic trace launched E1 {counts[ik]} "
          "times for its start field, not once")
    res["e1_launches"] += counts[ik]
    fu = small["out"]
    differ = (fu.n_steps != gen.n_steps) | (
        fu.boundary_material != gen.boundary_material)
    n_diff = int(differ.sum())
    check(n_diff <= TRACE_DIFFER * TRACE_N[0],
          f"fused vs generic: {n_diff} of {TRACE_N[0]} lines differ")
    err = 0.0
    for b in torch.nonzero(~differ).squeeze(1).tolist():
        m = min(int(fu.n_steps[b]), max_steps)
        err = max(err, float((fu.y[b, :m] - gen.y[b, :m]).abs().max()),
                  float((fu.y_field[b, :m] - gen.y_field[b, :m]).abs().max()))
    check(err <= TRACE_TOL, f"fused vs generic: curves differ by {err}")
    for b in torch.nonzero(differ).squeeze(1).tolist():
        print(f"  line {b}: fused n_steps {int(fu.n_steps[b])} code "
              f"{int(fu.boundary_material[b])}, generic "
              f"{int(gen.n_steps[b])} code {int(gen.boundary_material[b])}")
    gsteps = int(gen.n_steps.clamp(max=max_steps).sum())
    print(f"B4 fused vs generic ({TRACE_N[0]} lines): {n_diff} lines differ in "
          f"n_steps or boundary code; the others agree within {err:.3e}; "
          f"generic path {gen_s * 1e3:.4f} ms = {gsteps / gen_s:.4e} trace "
          f"steps/s ({res['walk_launches']} walk_rows launches), fused "
          f"{small['wall'] * 1e3:.4f} ms")

    # B3 walk_rows at the size the generic trace launches it: the first
    # stage walk of its first iteration, against its plain version
    w_args, _ = walks["inputs"][0]
    k_out = walk_kernel.walk_cuda(*w_args)
    p_out = walk_kernel.walk_rows_plain(*w_args)
    for name, a, b in zip(("ic", "r_p", "steps", "status"), k_out, p_out):
        check(torch.equal(a, b), f"B3 walk_rows, {TRACE_N[0]} generic-trace "
              f"walks: {name} differs from the plain version")
    w_ms, w_ev = kernel_ms(lambda: walk_kernel.walk_cuda(*w_args),
                           "walk", WALK_REPS)
    w_plain = cuda_ms(lambda: walk_kernel.walk_rows_plain(*w_args), 3)
    w_bound, w_bound_old = walk_bound(w_args[0], w_args[1:], walk_kernel,
                                      grid.n_faces_per_cell)
    res["walk_small"] = dict(n=w_args[1].shape[0], ms=w_ms, ev_ms=w_ev,
                             plain_ms=w_plain, bound=w_bound,
                             bound_old=w_bound_old)
    print(f"B3 walk_rows, {w_args[1].shape[0]} walks of the generic trace "
          f"(its first stage walk), bit-identical to walk_rows_plain: kernel "
          f"{'not measured' if w_ms is None else f'{w_ms:.4f} ms'} "
          f"(profiler device time), CUDA events {w_ev:.4f} ms a call, plain "
          f"{w_plain:.4f} ms, bound {w_bound[0]:.4f} ms ({w_bound[1]}; "
          f"{w_bound_old[0]:.4f} ms with the first design's inputs); "
          f"CUDA events over the generic call's {len(walks['ms'])} walks: "
          f"mean {np.mean(walks['ms']):.4f} ms")
    return res


ACC_TOL = 1e-10  # accurate mode's gate (bench.py:401)
ACC_VAL_TOL = 1e-13  # kernel vs plain hi + lo where the verdicts agree
# float32 operations of one df32 operation in the least work that gives
# the kernels' bits (csrc/df32.cuh): a product takes its exact error from
# one FMA, counted as 2 operations (DF_MUL: 10 operations in 9
# instructions); a division or root is a product, a sum and 7 more
DF_ADD = 20
DF_MUL = 10
DF_DIV = DF_SQRT = DF_MUL + DF_ADD + 7


def acc_flops(cell_type, n_vars, fma_ops=2):
    """float32 operations of B5 for one query: the df32 weights, the
    simplex normalization and the contraction of ``n_vars`` variables;
    with ``fma_ops=1`` the instructions, an FMA counted once."""
    mul = DF_MUL - 2 + fma_ops
    div = sqrt = mul + DF_ADD + 7
    if cell_type == "tetra":  # 21 differences, 4 triple products
        w = 21 * DF_ADD + 4 * (9 * mul + 5 * DF_ADD)
        w += 3 * DF_ADD + 4 * div
    elif cell_type == "triangle":  # per area: 6 differences, cross, dot, sqrt
        w = 3 * (6 * DF_ADD + 9 * mul + 5 * DF_ADD + sqrt)
        w += 2 * DF_ADD + 3 * div
    else:  # inverse bilinear: about 35 adds, 24 products, 2 divisions, a root
        w = 35 * DF_ADD + 24 * mul + 2 * div + sqrt
    npc = 3 if cell_type == "triangle" else 4
    return w + n_vars * (npc * mul + (npc - 1) * DF_ADD)


def acc_compare(name, k_out, p_out, n_ids, exact=False):
    """Kernel vs plain for the accurate kernels: every output identical
    on >= AGREE of the queries (on all of them if ``exact``), hi + lo
    within ACC_VAL_TOL where the first ``n_ids`` outputs (ids, verdicts)
    agree.  Returns (n_differ, max |hi + lo diff| where the verdicts
    agree)."""
    same_ids = torch.ones_like(k_out[-1][:, 0], dtype=torch.bool)
    for a, b in zip(k_out[:n_ids], p_out[:n_ids]):
        same_ids &= a == b
    same = same_ids.clone()
    for a, b in zip(k_out[n_ids:], p_out[n_ids:]):
        same &= (a == b).all(1)
    n_bad = int((~same).sum())
    check(n_bad <= (0 if exact else (1 - AGREE) * same.numel()),
          f"{name}: {n_bad} of {same.numel()} queries differ")
    kv = k_out[-2].double() + k_out[-1].double()
    pv = p_out[-2].double() + p_out[-1].double()
    err = float((kv - pv)[same_ids].abs().max()) if same_ids.any() else 0.0
    check(err <= ACC_VAL_TOL, f"{name}: hi + lo differ by {err}")
    print(f"{name}: kernel vs plain: {n_bad} of {same.numel()} queries not "
          f"bit-identical; max |hi + lo diff| {err:.3e}")
    return n_bad, err


def accurate_phase(dev, tiu, grid, bf_inputs, counters, cand_kernel,
                   acc_kernel, walk_kernel, locate):
    """Accurate mode on the candidate phase's 998,250-tet grid (bench.py's
    accurate protocol, bench.py:353-402), then B5 on the brute-force
    phase's meshes."""
    from interpolate_unstructured_tpu_torch.ops import _kernels, interp_acc

    ck = cand_kernel.__name__
    res = {"ext_launches": 0, "gc_launches": 0, "df_launches": 0,
           "df_pass_launches": 0,
           "binned": {"bin_pass": 0, "bin_scatter": 0, "binned": 0,
                      "bin_unsort": 0}}
    timings = {}
    t0 = time.perf_counter()
    grid = tiu.prepare_accurate(grid, timings=timings)
    prep_s = time.perf_counter() - t0
    check(grid.cand_df_table is not None, "no df-plane rows on the 998k grid")
    mib = {f: getattr(grid, f).numel() * 4 / 2**20
           for f in ("acc_table", "cand_df_table")}
    print(f"accurate: prepare_accurate on {grid.n_cells} tets: {prep_s:.3f} "
          "s split " + json.dumps({k: round(v, 4) for k, v in timings.items()})
          + f"; acc_table {tuple(grid.acc_table.shape)} "
          f"{mib['acc_table']:.1f} MiB, cand_df_table "
          f"{tuple(grid.cand_df_table.shape)} {mib['cand_df_table']:.1f} MiB")

    r64 = torch.from_numpy(np.random.default_rng(2).random((N_CAND, 3))).to(dev)
    r_hi, r_lo = interp_acc.split_queries(r64)

    def acc_err(vh, vl, q):
        return float((vh[:, 0].double() + vl[:, 0].double()
                      - (q.sum(1) + 1.0)).abs().max())

    # Cold: one df-plane row per query, the bin-ordered pipeline (bin
    # pass, scatter, df probe, unsort) from the float64 queries as given,
    # no torch split or local frame, no B5; then the same queries as a
    # float32 hi/lo pair (the r_lo= argument)
    df_names = ("bin_pass", "bin_scatter", "df", "bin_unsort")
    cold = {}
    for label, call in (
            ("float64", lambda: tiu.interpolate_at_acc(grid, r64, (0,))),
            ("hi/lo pair", lambda: tiu.interpolate_at_acc(grid, r_hi, (0,),
                                                          r_lo=r_lo))):
        cold[label], counts = main_path(call, counters)
        got = {x: counts[f"{ck}:{x}"] for x in df_names}
        check(min(got.values()) >= 1 and counts[acc_kernel.__name__] == 0
              and counts[f"{ck}:binned"] == 0 and counts[f"{ck}:ext"] == 0,
              f"cold accurate call ({label}) launched {got}, B5 "
              f"{counts[acc_kernel.__name__]}, f32 probes "
              f"{counts[f'{ck}:binned']} + {counts[f'{ck}:ext']}")
        res["df_launches"] += got["df"]
        if label == "float64":
            res["df_pass_launches"] += got["bin_pass"]
        else:
            res["binned"]["bin_pass"] += got["bin_pass"]
        for x in ("bin_scatter", "bin_unsort"):
            res["binned"][x] += got[x]
    vh, vl, found, ic = cold["float64"]
    for name, a, b in zip(("vals_hi", "vals_lo", "found", "i_cell"),
                          cold["hi/lo pair"], cold["float64"]):
        check(torch.equal(a, b), f"cold accurate: the hi/lo pair's {name} "
              "differs from the float64 queries'")
    del cold
    check(bool(found.all()), f"{int((~found).sum())} cold accurate queries "
          "not found")
    err_c = acc_err(vh, vl, r64)
    check(err_c <= ACC_TOL, f"cold accurate error {err_c}")
    cold_s = steady_s(lambda: tiu.interpolate_at_acc(grid, r64, (0,)), 3)
    print(f"accurate: 10M cold interpolate_at_acc (float64 queries): steady "
          f"{cold_s * 1e3:.4f} ms = {N_CAND / cold_s:.4e} queries/s; B2-df "
          f"pipeline launches (float64 and pair calls) {res['df_launches']}; "
          f"the hi/lo pair's results torch.equal to the float64 queries'; "
          f"all found; max |hi + lo - f| {err_c:.3e}")
    # The same call without the df-plane rows (the build_df=False route:
    # get_cell on the float32 candidate rows, then B5), which finds the
    # same cells: both tables carry the same probe words; both routes in
    # turns
    no_df = dataclasses.replace(grid, cand_df_table=None)
    vh2, vl2, found2, ic2 = tiu.interpolate_at_acc(no_df, r64, (0,))
    check(torch.equal(ic2, ic) and bool(found2.all()),
          "cold accurate cells differ without the df-plane rows")
    err_n = acc_err(vh2, vl2, r64)
    check(err_n <= ACC_TOL, f"cold accurate error without df rows {err_n}")
    del vh2, vl2, found2, ic2
    t_route = turns({
        "df rows": lambda: tiu.interpolate_at_acc(grid, r64, (0,)),
        "get_cell + B5": lambda: tiu.interpolate_at_acc(no_df, r64, (0,)),
    }, 5)
    res["route"] = t_route
    print(f"accurate: 10M cold queries, CUDA events in turns: df-plane rows "
          f"in bin order {t_route['df rows'][0]:.4f} / "
          f"{t_route['df rows'][1]:.4f} ms, without them (get_cell + B5) "
          f"{t_route['get_cell + B5'][0]:.4f} / "
          f"{t_route['get_cell + B5'][1]:.4f} ms; max |hi + lo - f| "
          f"{err_n:.3e} without them")
    del no_df

    # Warm: the candidate phase's moved points in float64, guessed by the
    # cold cells: get_cell (B2, B3 on misses), then B5
    vel = torch.from_numpy(np.random.default_rng(5).random((N_CAND, 3))).to(dev)
    r_w = 0.005 + 0.98 * r64 + 0.01 * vel
    del vel, vh, vl, found
    (vh, vl, found, ic_w), counts = main_path(
        lambda: tiu.interpolate_at_acc(grid, r_w, (0,), guess=ic), counters)
    n_b5 = counts[acc_kernel.__name__]
    check(n_b5 >= 1, "the warm accurate call did not launch B5")
    res["acc_launches"] = n_b5
    res["ext_launches"] += counts[f"{ck}:ext"]
    for x in res["binned"]:
        res["binned"][x] += counts[f"{ck}:{x}"]
    n_gc = counts[f"{walk_kernel.__name__}:get_cell"]
    res["gc_launches"] += n_gc
    check(bool(found.all()), f"{int((~found).sum())} warm accurate queries "
          "not found")
    err_w = acc_err(vh, vl, r_w)
    check(err_w <= ACC_TOL, f"warm accurate error {err_w}")
    warm_s = steady_s(
        lambda: tiu.interpolate_at_acc(grid, r_w, (0,), guess=ic), 3)
    print(f"accurate: 10M warm interpolate_at_acc (moved points, guess = cold "
          f"cells): steady {warm_s * 1e3:.4f} ms = {N_CAND / warm_s:.4e} "
          f"queries/s; B5 launches {n_b5}, B2 in bin order "
          f"{counts[ck + ':binned']}, with extension rows "
          f"{counts[ck + ':ext']}, get_cell walk "
          f"{n_gc}; all found; max |hi + lo - f| {err_w:.3e}")
    del vh, vl, found

    # B2-df in bin order against its plain version (split, bin index,
    # hi/lo local frame, probe, from the same float64 queries) on the
    # first 1M, then each kernel of the pipeline timed on all 10M
    lay = locate._df_row_layout(grid, (0,))
    eps = locate._cand_eps(grid)
    table = grid.cand_df_table
    chunk = locate._cand_chunk(grid, table)
    bins = (grid.cand_rmin, grid.cand_inv_h, grid.cand_shape)
    n_bins = int(np.prod(grid.cand_shape))
    cut = slice(0, N_CMP)
    k_out = cand_kernel.cand_rows_df_query(table, r64[cut], None, *bins, lay,
                                           eps, lay.k, chunk)
    p_out = cand_kernel.cand_rows_df_plain(table, r64[cut], None, *bins, lay,
                                           eps, lay.k, chunk)
    for name, a, b in zip(("id", "aux"), k_out, p_out):
        check(torch.equal(a, b), f"B2-df in bin order: {name} differs from "
              f"the plain version on {int((a != b).sum())} of the first "
              f"{N_CMP} queries")
    _, err_df = acc_compare("B2-df in bin order, 998k-tet df-plane rows, "
                            "first 1M", k_out, p_out, 2)
    del k_out, p_out
    idx, _, _ = cand_kernel.probe_inputs_df_plain(r64, None, *bins)
    lanes = cand_kernel.binned_lanes(N_CAND, n_bins)
    lanes_guard = 4 if lanes == 2 else 2
    full = cand_kernel.cand_rows_df_query(table, r64, None, *bins, lay, eps,
                                          lay.k, chunk)
    _, _, perm, slot = cand_kernel.bin_order_cuda(r64, *bins)
    guard = cand_kernel.cand_rows_binned_cuda(table, r64, perm, slot, *bins,
                                              lay, eps, lay.k,
                                              lanes=lanes_guard)
    nv = len(lay.var_roles)
    for name, a, b in zip(("id", "aux", "vals_hi", "vals_lo"), full,
                          (guard[0], guard[1], guard[2][:, :nv],
                           guard[2][:, nv:])):
        check(torch.equal(a, b), f"B2-df in bin order: {name} differs "
              f"between {lanes} and {lanes_guard} lanes a query")
    print(f"B2-df in bin order, all {N_CAND} cold queries: id, aux and "
          f"values torch.equal with {lanes} and {lanes_guard} lanes a query")
    n_rows = int(torch.unique(idx).numel())
    n_planes = int(torch.unique(
        idx.long() * (grid.n_cells + 1) + full[0].long() + 1).numel())
    del full, guard, perm, slot

    lib = _kernels.lib()
    stream = torch.cuda.current_stream().cuda_stream
    rmin, inv_h = (t.contiguous() for t in bins[:2])
    counts_b = torch.zeros(n_bins, dtype=torch.int32, device=dev)
    bin_buf, rank_buf, perm_buf, slot_buf = (
        torch.empty(N_CAND, dtype=torch.int32, device=dev) for _ in range(4))

    def bin_pass64():  # with the 8 MB memset of the counts
        counts_b.zero_()
        _kernels.check(lib.iu_cand_bin_pass(
            r64.data_ptr(), 1, N_CAND, rmin.data_ptr(), inv_h.data_ptr(),
            *grid.cand_shape, counts_b.data_ptr(), bin_buf.data_ptr(),
            rank_buf.data_ptr(), stream), "iu_cand_bin_pass")

    bin_pass64()
    res["pass_err"] = float(int((bin_buf != idx).sum()))
    check(res["pass_err"] == 0, f"B2-df bin pass: {res['pass_err']:.0f} bins "
          "differ from the plain split and bin index")
    scan = torch.cumsum(counts_b, 0, dtype=torch.int32)

    def scatter():
        _kernels.check(lib.iu_cand_bin_scatter(
            bin_buf.data_ptr(), rank_buf.data_ptr(), scan.data_ptr(), N_CAND,
            perm_buf.data_ptr(), slot_buf.data_ptr(), stream),
            "iu_cand_bin_scatter")

    scatter()
    rec = torch.empty((N_CAND, 2 + 2 * nv), dtype=torch.int32, device=dev)
    vroles = torch.tensor(lay.var_roles, dtype=torch.int32, device=dev)

    def probe(g):  # the df probe alone, float64 queries, records by slot
        _kernels.check(lib.iu_cand_rows_binned(
            table.data_ptr(), table.shape[1], r64.data_ptr(), None, 1,
            perm_buf.data_ptr(), N_CAND, g, rmin.data_ptr(), inv_h.data_ptr(),
            *grid.cand_shape, lay.k, lay.nf, 3, lay.id_role, lay.count_col,
            float(eps), lay.k, cand_kernel.QINV, nv, vroles.data_ptr(),
            None, 0, 0, 0, rec.data_ptr(), stream), "iu_cand_rows_binned")

    outs = (torch.empty(N_CAND, dtype=torch.int32, device=dev),
            torch.empty(N_CAND, dtype=torch.int32, device=dev),
            torch.empty((N_CAND, 2 * nv), dtype=torch.float32, device=dev))

    def unsort():
        _kernels.check(lib.iu_cand_bin_unsort(
            rec.data_ptr(), slot_buf.data_ptr(), N_CAND, 2 * nv,
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            stream), "iu_cand_bin_unsort")

    ms_pass = cuda_ms(bin_pass64, 10)
    ms_scan = cuda_ms(lambda: torch.cumsum(counts_b, 0, dtype=torch.int32), 10)
    ms_scatter = cuda_ms(scatter, 10)
    t_lanes = turns({g: (lambda g=g: probe(g)) for g in (lanes, lanes_guard)},
                    10)
    probe(lanes)
    ms_unsort = cuda_ms(unsort, 10)
    t_whole = turns({
        "float64": lambda: cand_kernel.cand_rows_df_query(
            table, r64, None, *bins, lay, eps, lay.k, chunk),
        "hi/lo pair": lambda: cand_kernel.cand_rows_df_query(
            table, r_hi, r_lo, *bins, lay, eps, lay.k, chunk),
    }, 10)
    ms_p = cuda_ms(lambda: cand_kernel.cand_rows_df_plain(
        table, r64, None, *bins, lay, eps, lay.k, chunk), 1)
    ms_p_inputs = cuda_ms(lambda: cand_kernel.probe_inputs_df_plain(
        r64, None, *bins), 5)
    ms_p_pass = cuda_ms(lambda: torch.bincount(
        cand_kernel.probe_inputs_df_plain(r64, None, *bins)[0].long(),
        minlength=n_bins), 3)
    # Bounds, each byte once: the probe roles of K candidates (int16
    # normal and offset words, ids), count and dscale of every distinct
    # row, the df plane (8 floats) of every distinct (row, winner); per
    # query its float64 input (24 B, in place of the 24 B hi/lo local
    # frame of the direct design) and its permutation entry in, a record
    # (id, aux, hi/lo value) out: the direct design's bytes
    n_roles = -(-3 * lay.nf // 2) + -(-lay.nf // 2) + 1
    rows_b = n_rows * (n_roles * lay.k * 4 + 8) + n_planes * 32
    ops = N_CAND * (lay.k * lay.nf * 9 + 3 * (DF_MUL + DF_ADD))
    rec_b = 4 * (2 + 2 * nv)
    res["df"] = dict(ms=sum(t_lanes[lanes]) / 2, plain_ms=ms_p,
                     bound=bound(rows_b + N_CAND * (24 + 4 + rec_b), ops),
                     max_abs_err=err_df)
    res["df_pass"] = dict(ms=ms_pass, plain_ms=ms_p_pass,
                          bound=bound(N_CAND * (24 + 8) + n_bins * 4,
                                      N_CAND * 9))
    res["df_whole"] = dict(turns=t_whole,
                           bound=bound(rows_b + N_CAND * (24 + rec_b), ops))
    print(f"B2-df in bin order, 998k-tet, {N_CAND} cold float64 queries, "
          f"CUDA events: bin pass (float64) {ms_pass:.4f} ms (with the count "
          f"memset), scan {ms_scan:.4f} ms, scatter {ms_scatter:.4f} ms, df "
          f"probe " + ", ".join(f"{g} lanes {t_lanes[g][0]:.4f} / "
                                f"{t_lanes[g][1]:.4f} ms"
                                for g in (lanes, lanes_guard))
          + f" (binned_lanes picks {lanes}), unsort of the 2 + 2V records "
          f"{ms_unsort:.4f} ms; the whole query in turns: float64 "
          f"{t_whole['float64'][0]:.4f} / {t_whole['float64'][1]:.4f} ms, "
          f"hi/lo pair {t_whole['hi/lo pair'][0]:.4f} / "
          f"{t_whole['hi/lo pair'][1]:.4f} ms; row "
          f"{table.shape[1] * 4} B, {n_rows} distinct rows, {n_planes} (row, "
          f"winner) planes")
    print(f"B2-df plain versions at {N_CAND}: the whole query "
          f"(cand_rows_df_plain) {ms_p:.4f} ms, its torch split, bin index "
          f"and hi/lo frame {ms_p_inputs:.4f} ms, bin index + bincount "
          f"{ms_p_pass:.4f} ms")
    for name in ("df", "df_pass", "df_whole"):
        b = res[name]["bound"]
        print(f"B2-df {name} bound at {N_CAND} queries: {b[0]:.4f} ms ({b[1]})")
    del idx, rec, outs, bin_buf, rank_buf, perm_buf, slot_buf, counts_b

    # B5 against its plain version on the warm call's first 1M queries,
    # both timed on all 10M
    hi, lo = interp_acc.split_queries(r_w)
    cells = ic_w.clamp_min(0).to(torch.int32)
    meta = ("tetra", 4, grid.n_point_data, (0,))
    b5_args = (grid.acc_table, cells, hi, lo, *meta)
    b5_first = (grid.acc_table, cells[cut], hi[cut], lo[cut], *meta)
    _, err_b5 = acc_compare(
        "B5 998k-tet warm cells, first 1M",
        acc_kernel.interp_acc_cuda(*b5_first),
        acc_kernel.interp_acc_plain(*b5_first), 0, exact=True)
    ms_k = cuda_ms(lambda: acc_kernel.interp_acc_cuda(*b5_args), 10)
    ms_p = cuda_ms(lambda: acc_kernel.interp_acc_plain(*b5_args), 2)
    # bytes, each once: per query its cell id, hi/lo position and a hi/lo
    # value out; the used row floats (vertex hi/lo, one variable's hi/lo
    # data) of every distinct cell
    n_cells_used = int(torch.unique(cells).numel())
    n_bytes = N_CAND * (4 + 24 + 8) + n_cells_used * (4 * 6 + 2 * 4) * 4
    bnd = bound(n_bytes, N_CAND * acc_flops("tetra", 1))
    floor = N_CAND * acc_flops("tetra", 1, fma_ops=1) / F32_INSTR_S * 1e3
    res["b5"] = dict(ms=ms_k, plain_ms=ms_p, bound=bnd, floor_ms=floor,
                     max_abs_err=err_b5)
    print(f"B5 998k-tet, 10M warm queries: kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}; {n_cells_used} "
          f"distinct cells' rows once, 36 B per query, "
          f"{acc_flops('tetra', 1)} flops per query), instruction floor "
          f"{floor:.4f} ms ({acc_flops('tetra', 1, fma_ops=1)} instructions "
          f"per query)")
    del hi, lo, cells, b5_args, r64, r_hi, r_lo, r_w, ic, ic_w, grid
    torch.cuda.empty_cache()

    # B5 through interpolate_at_icell_acc on the brute-force meshes, at
    # the brute-force phase's 1M inside queries and B1's cells
    for label, g, r, ic in bf_inputs:
        g = tiu.prepare_accurate(g)
        (vh, vl), counts = main_path(
            lambda: tiu.interpolate_at_icell_acc(g, r, (0,), ic), counters)
        n_b5 = counts[acc_kernel.__name__]
        check(n_b5 >= 1, f"{label}: B5 was not launched")
        res["acc_launches"] += n_b5
        err = float((vh[:, 0].double() + vl[:, 0].double()
                     - (r.double().sum(1) + 1.0)).abs().max())
        check(err <= ACC_TOL, f"{label}: accurate error {err}")
        z = torch.zeros_like(r)
        args = (g.acc_table, ic.clamp_min(0), r, z, g.cell_type,
                g.n_points_per_cell, g.n_point_data, (0,))
        _, e = acc_compare(f"B5 {label}, 1M", (vh, vl),
                           acc_kernel.interp_acc_plain(*args), 0, exact=True)
        res["b5"]["max_abs_err"] = max(res["b5"]["max_abs_err"], e)
        ms = cuda_ms(lambda: acc_kernel.interp_acc_cuda(*args), 10)
        print(f"B5 {label} ({g.n_cells} cells), 1M queries: kernel "
              f"{ms:.4f} ms; max |hi + lo - f| {err:.3e}")
    return res


def same_bits(a, b):
    """Bit-for-bit equality of two tensors.  Float tensors compare as
    their bits: the quantized candidate rows hold int16 pairs in float32
    words, some of them NaN patterns that torch.equal of the floats
    would call unequal to themselves."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(it), b.view(it)
    return torch.equal(a, b)


def check_same_grid(name, a, b):
    """Every tensor leaf of two grids bit for bit, every metadata field
    equal; returns the number of tensor leaves compared."""
    from interpolate_unstructured_tpu_torch.models.grid import (
        DATA_FIELDS,
        META_FIELDS,
    )

    n = 0
    for f in DATA_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        check((x is None) == (y is None), f"{name}: leaf {f} is None on "
              "one grid only")
        if x is not None:
            check(same_bits(x, y), f"{name}: leaf {f} differs")
            n += 1
    for f in META_FIELDS:
        check(getattr(a, f) == getattr(b, f), f"{name}: {f} differs: "
              f"{getattr(a, f)!r} against {getattr(b, f)!r}")
    return n


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def vtu_rounded(pts):
    """The coordinates a .vtu holds: its writer stores points as Float32,
    as the reference's does (m_vtk.f90:79)."""
    return pts.astype(np.float32).astype(np.float64)


def io_phase(dev, tiu, meshgen, cand_grid, cand_res, counters, card, tmp):
    """Mesh files and checkpoints on the card: the brute-force meshes and
    the walk phase's 998,250-tet box read from .vtu files the port wrote
    (write_vtu, convert_to_binda, read_grid), each against build_grid
    from meshgen's arrays; the candidate phase's grid saved and loaded
    (save_grid, load_grid) with no candidate-list rebuild, then its 10M
    cold queries and accurate mode's cold and warm queries on both."""
    import os

    from interpolate_unstructured_tpu_torch.io import convert, vtk
    from interpolate_unstructured_tpu_torch.models import grid as tgrid
    from interpolate_unstructured_tpu_torch.ops import locate

    interp_kernel, cand_kernel, walk_kernel, acc_kernel, _ = counters
    gc_key = f"{walk_kernel.__name__}:get_cell"
    res = {"b1": {}, "counts": {}}

    # Brute-force meshes through read_grid: B1 on the grid read from the
    # file against B1 on the grid built from the same arrays
    rng = np.random.default_rng(1)
    for cell_type, label, (pts, cells, nbrs) in bf_meshes(meshgen):
        pd = {"Polynomial": pts.sum(1) + 1.0}
        path = os.path.join(tmp, f"bf_{cell_type}.vtu")
        vtk.write_vtu(path, pts, cells, cell_type, point_data=pd)
        g_file = tiu.read_grid(path, dtype=torch.float32, device=dev)
        g_arr = tiu.build_grid(vtu_rounded(pts), cells, nbrs, cell_type,
                               point_data=pd, dtype=torch.float32, device=dev)
        n_leaves = check_same_grid(f"read_grid {label}", g_file, g_arr)
        r = bf_queries(pts, rng, dev)
        out, counts = main_path(
            lambda: tiu.interpolate_scalar_at(g_file, r, 0, fill_value=FILL),
            counters)
        n_b1 = counts[interp_kernel.__name__]
        check(n_b1 >= 1, f"io {label}: B1 was not launched on the grid read "
              "from its file")
        add_counts(res["counts"], counts)
        res["b1"][label] = n_b1
        ref = tiu.interpolate_scalar_at(g_arr, r, 0, fill_value=FILL)
        for name, a, b in zip(("values", "i_cell", "found"), out, ref):
            check(same_bits(a, b), f"io {label}: B1 {name} on the grid read "
                  "from the file differs from the grid built from arrays")
        print(f"io {label}: read_grid of the port's .vtu, {n_leaves} tensor "
              f"leaves and every metadata field equal to build_grid of the "
              f"arrays; B1 ({n_b1} launches) values, cells and found masks "
              f"torch.equal on {r.shape[0]} queries")
        del g_file, g_arr, r, out, ref

    # The candidate phase's 998,250-tet grid: save, then load onto the
    # card; the candidate builder must not run
    path = os.path.join(tmp, "box.binda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiu.save_grid(cand_grid, path)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    rebuilds = []
    real_builder = tgrid.build_candidate_bins_dispatch

    def counting_builder(*a, **k):
        rebuilds.append(1)
        return real_builder(*a, **k)

    tgrid.build_candidate_bins_dispatch = counting_builder
    try:
        timings = {}
        t0 = time.perf_counter()
        loaded = tiu.load_grid(path, device=dev, timings=timings)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        tgrid.build_candidate_bins_dispatch = real_builder
    check(not rebuilds, "load_grid rebuilt the candidate lists")
    n_leaves = check_same_grid("load_grid of the 998k-tet box", cand_grid,
                               loaded)
    res.update(save_s=save_s, size=size, load_s=load_s, load=timings)
    print(f"io checkpoint, {cand_grid.n_cells} tets: save_grid {save_s:.3f} "
          f"s, {size} bytes; load_grid {load_s:.3f} s split "
          + json.dumps({k: round(v, 4) for k, v in timings.items()})
          + f"; this run's build_grid {cand_res['build_s']:.3f} s split "
          + json.dumps({k: round(v, 4) for k, v in cand_res["timings"].items()})
          + f"; no candidate-list rebuild; {n_leaves} tensor leaves (walk, "
          f"candidate and extension tables, bin_pack included) and every "
          f"metadata field equal to the built grid's [{card}]")

    # 10M cold queries on both grids
    r = torch.from_numpy(
        np.random.default_rng(2).random((N_CAND, 3)).astype(np.float32)
    ).to(dev)
    out, counts = main_path(
        lambda: tiu.interpolate_scalar_at(loaded, r, 0, fill_value=0.0),
        counters)
    ck = cand_kernel.__name__
    check(counts[f"{ck}:binned"] >= 1, "the loaded grid's cold queries did "
          "not launch B2 in bin order")
    add_counts(res["counts"], counts)
    ref = tiu.interpolate_scalar_at(cand_grid, r, 0, fill_value=0.0)
    for name, a, b in zip(("values", "i_cell", "found"), out, ref):
        check(same_bits(a, b), f"io checkpoint: 10M cold {name} on the "
              "loaded grid differ from the built grid's")
    check(bool(out[2].all()), "io checkpoint: a cold query was not found")
    print(f"io checkpoint: {N_CAND} cold interpolate_scalar_at on the loaded "
          f"grid torch.equal to the built grid's (B2 in bin order "
          f"{counts[f'{ck}:binned']} launches)")
    del r, out, ref

    # Accurate mode on both: prepare_accurate, then the accurate phase's
    # 10M float64 queries cold and moved warm (guess = cold cells)
    pa = tiu.prepare_accurate(cand_grid)
    t0 = time.perf_counter()
    pb = tiu.prepare_accurate(loaded)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    del loaded
    n_leaves = check_same_grid("prepare_accurate of the loaded grid", pa, pb)
    r64 = torch.from_numpy(np.random.default_rng(2).random((N_CAND, 3))).to(dev)
    vel = torch.from_numpy(np.random.default_rng(5).random((N_CAND, 3))).to(dev)
    r_w = 0.005 + 0.98 * r64 + 0.01 * vel
    del vel
    cold, counts = main_path(lambda: tiu.interpolate_at_acc(pb, r64, (0,)),
                             counters)
    check(counts[f"{ck}:df"] >= 1, "the loaded grid's cold accurate queries "
          "did not launch the df probe")
    # the float64 bin pass, kept apart from the float32 one
    res["df_pass"] = counts.pop(f"{ck}:bin_pass")
    add_counts(res["counts"], counts)
    warm, counts = main_path(
        lambda: tiu.interpolate_at_acc(pb, r_w, (0,), guess=cold[3]),
        counters)
    check(counts[acc_kernel.__name__] >= 1, "the loaded grid's warm accurate "
          "queries did not launch B5")
    add_counts(res["counts"], counts)
    cold_a = tiu.interpolate_at_acc(pa, r64, (0,))
    warm_a = tiu.interpolate_at_acc(pa, r_w, (0,), guess=cold_a[3])
    for label, a_out, b_out in (("cold", cold_a, cold), ("warm", warm_a, warm)):
        for name, a, b in zip(("vals_hi", "vals_lo", "found", "i_cell"),
                              a_out, b_out):
            check(same_bits(a, b), f"io checkpoint: {label} accurate {name} "
                  "on the loaded grid differs from the built grid's")
    check(bool(cold[2].all() and warm[2].all()),
          "io checkpoint: an accurate query was not found")
    print(f"io checkpoint: prepare_accurate of the loaded grid {prep_s:.3f} s "
          f"[{card}], {n_leaves} tensor leaves equal to the built grid's "
          f"(acc_table, cand_df_table included); {N_CAND} float64 queries "
          f"cold and warm: vals_hi, vals_lo, found, i_cell torch.equal")
    del pa, pb, r64, r_w, cold, warm, cold_a, warm_a
    torch.cuda.empty_cache()

    # A load whose rebuild takes the device builder: no cover rows, so K
    # drops to the row capacity and the lists are rebuilt from the stored
    # geometry, with extension rows; they equal build_grid's with the same
    # config
    from interpolate_unstructured_tpu_torch.ops import cand_build_kernel

    n = 55
    pts, cells, nbrs = meshgen.tet_box_mesh(n, n, n)
    pd = {"Polynomial": pts.sum(1) + 1.0}
    cfg = tiu.IUConfig(cand_cover_row_bytes=0)
    timings = {}
    t0 = time.perf_counter()
    rebuilt, counts = main_path(
        lambda: tiu.load_grid(path, config=cfg, device=dev, timings=timings),
        counters + (cand_build_kernel,))
    rebuild_load_s = time.perf_counter() - t0
    res["builder_launches"] = builder_launches(counts)
    check(min(res["builder_launches"].values()) >= 1,
          f"load_grid's rebuild did not launch D1 and D2: "
          f"{res['builder_launches']}")
    g_arr = tiu.build_grid(pts, cells, nbrs, "tetra", point_data=pd,
                           dtype=torch.float32, locate_mode="walk",
                           config=cfg, device=dev)
    check(rebuilt.cand_ids.shape[1] != cand_grid.cand_ids.shape[1]
          and rebuilt.cand_ext_ids is not None,
          "load_grid did not rebuild the lists with extension rows")
    for f in ("cand_ids", "cand_count", "cand_ext_ids", "cand_ext_slot",
              "cand_rmin", "cand_inv_h"):
        check(same_bits(getattr(rebuilt, f), getattr(g_arr, f)),
              f"io rebuild: {f} differs from build_grid's")
    check(rebuilt.cand_shape == g_arr.cand_shape
          and rebuilt.cand_ext_covers == g_arr.cand_ext_covers,
          "io rebuild: the bin shape or the cover flag differs")
    del g_arr
    builder_grid_match("io rebuild", rebuilt, pts, cells, nbrs, dev)
    r = torch.from_numpy(
        np.random.default_rng(2).random((N_CAND, 3)).astype(np.float32)
    ).to(dev)
    (vals, _, found), counts = main_path(
        lambda: tiu.interpolate_scalar_at(rebuilt, r, 0, fill_value=0.0),
        counters)
    check(counts[f"{cand_kernel.__name__}:ext"] >= 1, "io rebuild: the cold "
          "queries did not launch the probe with the extension rows")
    add_counts(res["counts"], counts)
    check(bool(found.all()), "io rebuild: a cold query was not found")
    lin = float((vals.double() - (r.double().sum(1) + 1.0)).abs().max())
    check(lin <= LIN_TOL, f"io rebuild: linear-exactness error {lin}")
    e2e = steady_s(lambda: tiu.interpolate_scalar_at(rebuilt, r, 0), 3)
    res["ext"] = ext_check("B2 io rebuild, 10M cold", rebuilt, r,
                           cand_kernel, locate)
    res["ext"]["e2e_ms"] = e2e * 1e3
    print(f"io rebuild, load_grid with cand_cover_row_bytes=0: "
          f"{rebuild_load_s:.3f} s split "
          + json.dumps({k: round(v, 4) for k, v in timings.items()})
          + f", the lists rebuilt on the card (D1/D2 launches "
          f"{json.dumps(res['builder_launches'])}), K="
          f"{rebuilt.cand_ids.shape[1]} + {rebuilt.cand_ext_ids.shape[1]} "
          f"extension, equal to build_grid's with the same config; "
          f"{N_CAND} cold queries all found, linear error {lin:.3e}, "
          f"interpolate_scalar_at steady {e2e * 1e3:.4f} ms [{card}]")
    del rebuilt, r, vals, found
    torch.cuda.empty_cache()

    # The walk phase's grid from a file: write_vtu, convert_to_binda,
    # read_grid with the walk phase's config (no candidate tables)
    vtu = os.path.join(tmp, "box55.vtu")
    t0 = time.perf_counter()
    vtk.write_vtu(vtu, pts, cells, "tetra", point_data=pd)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    binda = convert.convert_to_binda(vtu)
    convert_s = time.perf_counter() - t0
    cfg = tiu.IUConfig(use_candidate_bins=False)
    t0 = time.perf_counter()
    grid, counts = main_path(lambda: tiu.read_grid(
        binda, dtype=torch.float32, locate_mode="walk", config=cfg,
        device=dev), counters)
    read_s = time.perf_counter() - t0
    check(counts[gc_key] >= 1, "get_cell's walk stage was not launched by "
          "read_grid's refine")
    res["refine_launches"] = counts[gc_key]
    timings = {}
    t0 = time.perf_counter()
    g_arr = tiu.build_grid(vtu_rounded(pts), cells, nbrs, "tetra",
                           point_data=pd, dtype=torch.float32,
                           locate_mode="walk", config=cfg, device=dev,
                           timings=timings)
    build_s = time.perf_counter() - t0
    n_leaves = check_same_grid("read_grid of the 55^3 box", grid, g_arr)
    del g_arr
    res.update(write_s=write_s, convert_s=convert_s, read_s=read_s,
               walk_build_s=build_s, walk_grid=grid,
               vtu_bytes=os.path.getsize(vtu),
               binda_bytes=os.path.getsize(binda))
    print(f"io walk grid, {grid.n_cells} tets: write_vtu {write_s:.3f} s "
          f"({res['vtu_bytes']} bytes), convert_to_binda {convert_s:.3f} s "
          f"({res['binda_bytes']} bytes), read_grid {read_s:.3f} s (its "
          f"refine {res['refine_launches']} get_cell walk launches); "
          f"build_grid of the arrays {build_s:.3f} s split "
          + json.dumps({k: round(v, 4) for k, v in timings.items()})
          + f"; {n_leaves} tensor leaves and every metadata field equal "
          f"[{card}]")
    return res


def trace_vtk_check(tiu, out, tmp, card):
    """write_trace_vtk of a trace result, read back with the port's VTU
    decoding: the polyline points are each line's stored points."""
    import os
    from xml.etree import ElementTree

    from interpolate_unstructured_tpu_torch.io import vtu

    path = os.path.join(tmp, "trace.vtu")
    t0 = time.perf_counter()
    tiu.write_trace_vtk(out, path)
    write_s = time.perf_counter() - t0
    xml_text, blob, _ = vtu._split_appended_blob(open(path, "rb").read())
    arrays = {}
    for da in ElementTree.fromstring(xml_text).iter("DataArray"):
        raw = vtu._decode_block(blob[int(da.get("offset")):], np.uint32, False)
        arrays[da.get("Name")] = np.frombuffer(
            raw, dtype=vtu._VTK_TO_NP[da.get("type")])
    max_steps = out.y.shape[1]
    n = out.n_steps.clamp(max=max_steps).cpu().numpy()
    keep = n >= 2
    y = out.y.cpu().numpy()
    want = np.concatenate([y[i, :n[i], :3] for i in np.flatnonzero(keep)])
    got = arrays["Points"].reshape(-1, 3)
    check(got.shape == want.shape and np.array_equal(got, want),
          "write_trace_vtk: the points read back differ from the trace's")
    check(np.array_equal(arrays["offsets"], np.cumsum(n[keep])),
          "write_trace_vtk: polyline offsets differ")
    print(f"io write_trace_vtk: {int(keep.sum())} of {len(n)} lines, "
          f"{len(got)} points in {write_s:.3f} s ({os.path.getsize(path)} "
          f"bytes) [{card}]; the points read back equal the trace's")
    return write_s


# ---------------------------------------------------------------------
# float64 grids on the card: B1, B2 and B3 in double

LIN_TOL_F64_BF = 1e-14  # float64 linear exactness, the repo's invariant
LIN_TOL_F64 = 1e-12  # the goldens' tolerance: the 998k box in float64
F64_FLOPS_S = 34e12  # H100 SXM FP64 rate outside the tensor cores


def bound64(n_bytes, n_ops):
    """(bound_ms, bound_by) of float64 work: the bytes at the memory rate
    against the operations at the FP64 rate (an FMA counts 2)."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / F64_FLOPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def equal_or_fail(name, got, want):
    """Every output of a kernel torch.equal to its plain version's;
    returns the number of entries that differ (0)."""
    n_bad = 0
    for i, (a, b) in enumerate(zip(got, want)):
        bad = int((a != b).sum()) if a.shape == b.shape else -1
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"{name}: output {i} differs from the plain version on {bad} "
              "entries")
        n_bad += max(bad, 0)
    return n_bad


def f64_bruteforce(dev, tiu, meshgen, interp_kernel, counters):
    """B1 in double on the brute-force phase's meshes, the same 1M + 1%
    queries in float64."""
    rows = []
    rng = np.random.default_rng(1)
    for cell_type, label, (pts, cells, nbrs) in bf_meshes(meshgen):
        grid = tiu.build_grid(
            pts, cells, nbrs, cell_type,
            point_data={"Polynomial": pts.sum(1) + 1.0}, dtype=torch.float64,
            device=dev)
        check(grid.locate_mode == "bruteforce", f"{label} is not brute force")
        r = bf_queries(pts, rng, dev, np.float64)
        (vals, ic, found), counts = main_path(
            lambda: tiu.interpolate_scalar_at(grid, r, 0, fill_value=FILL),
            counters)
        n_b1 = counts[interp_kernel.__name__]
        check(n_b1 >= 1, f"float64 {label}: B1 was not launched")
        check(vals.dtype == torch.float64, f"float64 {label}: values are "
              f"{vals.dtype}")
        check(bool(found[:N_BF].all()), f"float64 {label}: an inside query "
              "was not found")
        out = slice(N_BF, None)
        check(not bool(found[out].any()) and bool((vals[out] == FILL).all()),
              f"float64 {label}: an outside query was found or lacks the fill")
        lin = float((vals[found] - (r[found].sum(1) + 1.0)).abs().max())
        check(lin <= LIN_TOL_F64_BF, f"float64 {label}: linear-exactness "
              f"error {lin}")
        pv, pic, pf = interp_kernel.interpolate_bruteforce_plain(grid, r, [0])
        kout = interp_kernel.interpolate_bruteforce_cuda(grid, r, [0])
        equal_or_fail(f"B1 float64 {label}", kout, (pv, pic, pf))
        equal_or_fail(f"B1 float64 {label}, main path", (vals, ic, found),
                      (torch.where(pf, pv[:, 0], FILL), pic, pf))
        del pv, pic, pf, kout
        rb = r[:N_BF]
        ms_k = cuda_ms(lambda: interp_kernel.interpolate_bruteforce_cuda(
            grid, rb, [0]), 10)
        ms_p = cuda_ms(lambda: interp_kernel.interpolate_bruteforce_plain(
            grid, rb, [0]), 3)
        e2e = steady_s(lambda: tiu.interpolate_scalar_at(grid, rb, 0), 5)
        nc, nf = grid.n_cells, grid.n_faces_per_cell
        npc = grid.n_points_per_cell
        n_bytes = (N_BF * (24 + 8 + 4 + 1) + nc * nf * 32
                   + nc * (npc * 3 * 8 + 8 + npc * 4) + grid.n_points * 8)
        bnd = bound64(n_bytes, N_BF * nc * nf * 7)
        print(f"B1 float64 {label} ({nc} cells), 1M queries: kernel "
              f"{ms_k:.4f} ms (CUDA events), plain {ms_p:.4f} ms; "
              f"interpolate_scalar_at {e2e * 1e3:.4f} ms = "
              f"{N_BF / e2e:.4e} queries/s; bound {bnd[0]:.4f} ms "
              f"({bnd[1]}, FP64); linear error {lin:.3e}; ids, found and "
              f"values torch.equal to the plain version, main path too")
        rows.append(dict(label=label, launches=n_b1, ms=ms_k, plain_ms=ms_p,
                         e2e_ms=e2e * 1e3, lin=lin, bound=bnd))
    return rows


def f64_cold(dev, tiu, grid, r, locate, cand_kernel, walk_kernel, counters):
    """The 998k box's cold float64 queries: the main path, then each B2
    stage against its plain version on the same inputs, timed, with
    bounds that count each byte once at the FP64 rate."""
    from interpolate_unstructured_tpu_torch.models.grid import cand_fused_nv
    from interpolate_unstructured_tpu_torch.ops import (
        _kernels,
        geometry,
        icell_kernel,
    )

    ck = cand_kernel.__name__
    gc_key = f"{walk_kernel.__name__}:get_cell"
    res = {}
    n = r.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (vals, ic, found), counts = main_path(
        lambda: tiu.interpolate_scalar_at(grid, r, 0, fill_value=0.0),
        counters)
    first_s = time.perf_counter() - t0
    res["binned"] = {x: counts[f"{ck}:{x}"] for x in
                     ("bin_pass", "bin_scatter", "ext", "bin_unsort")}
    res["gc_launches"] = counts[gc_key]
    res["e1_launches"] = counts[icell_kernel.__name__]
    check(min(res["binned"].values()) >= 1 and counts[f"{ck}:binned"] == 0,
          f"float64 cold: the bin-ordered B2 kernels with the extension "
          f"probe were not all launched: {res['binned']}")
    check(res["e1_launches"] >= 1, "float64 cold: E1 was not launched")
    check(vals.dtype == torch.float64, "float64 cold values are not float64")
    check(bool(found.all()), f"float64 cold: {int((~found).sum())} of "
          f"{n} queries not found")
    lin = float((vals - (r.sum(1) + 1.0)).abs().max())
    check(lin <= LIN_TOL_F64, f"float64 cold linear-exactness error {lin}")
    res["oracle"] = dict(oracle_sample(r, (vals, ic, found),
                                       slice(0, ORACLE_COLD_N)),
                         band=oracle_band(grid, host64(grid.points)))
    del vals, found
    # E1 against its plain version on the 10M cold queries in the cells
    # the main path found (K = 7 rows fuse no variable: every value is E1's)
    res["e1"] = e1_phase("998k box in float64, 10M cold", grid, r, (0,), ic,
                         bound64)
    del ic
    e2e = steady_s(lambda: tiu.interpolate_scalar_at(grid, r, 0,
                                                     fill_value=0.0), 3)
    loc = steady_s(lambda: tiu.get_cell(grid, r), 3)
    res.update(e2e_s=e2e, lin=lin)
    print(f"float64 cold interpolate_scalar_at, {n} queries: first call "
          f"{first_s:.4f} s, steady {e2e * 1e3:.4f} ms = {n / e2e:.4e} "
          f"queries/s (get_cell {loc * 1e3:.4f} ms); all found; linear "
          f"error {lin:.3e}; launches: bin-ordered {json.dumps(res['binned'])}"
          f" (ext: the probe with the extension rows), get_cell walk "
          f"{res['gc_launches']}, E1 {res['e1_launches']}")

    k = grid.cand_ids.shape[1]
    var = (0,) if cand_fused_nv(grid) > 0 else ()
    lay = locate._row_layout(grid, k, var)
    eps = locate._cand_eps(grid)
    chunk = locate._cand_chunk(grid)
    bins = (grid.cand_rmin, grid.cand_inv_h, grid.cand_shape)
    n_bins = int(np.prod(grid.cand_shape))
    idx, rq = locate._cand_probe_inputs(grid, r)
    pout = cand_kernel.probe_rows_plain(grid.cand_table, idx, rq, lay, eps,
                                        k, chunk)
    b_idx, ends, perm, slot = cand_kernel.bin_order_cuda(r, *bins)
    arange = torch.arange(n, device=dev, dtype=torch.int32)
    res["pass_err"] = float(int((b_idx != idx).sum()) + int(
        (ends.long() != torch.cumsum(torch.bincount(
            idx.long(), minlength=n_bins), 0)).sum()))
    check(res["pass_err"] == 0, f"B2 float64 bin pass: {res['pass_err']:.0f} "
          "bins or counts differ from the plain bin index and bincount")
    res["scatter_err"] = float(
        int((torch.sort(perm).values != arange).sum())
        + int((idx[perm.long()] != idx[cand_kernel.bin_order_plain(idx)])
              .sum())
        + int((perm[slot.long()] != arange).sum()))
    check(res["scatter_err"] == 0, "B2 float64 scatter: perm or slot is not "
          "the plain grouping and its inverse")
    lanes = cand_kernel.binned_lanes(n, n_bins)
    # the main rows' probe alone, and the unsort after it
    res["binned_err"] = float(equal_or_fail(
        "B2 float64 probe in bin order (main rows only) + unsort",
        cand_kernel.cand_rows_binned_cuda(grid.cand_table, r, perm, slot,
                                          *bins, lay, eps, k, lanes), pout))
    print(f"B2 float64 stages on the {n} cold queries: the bin pass's bins "
          f"equal the plain bin index and its counts the bincount, the "
          f"scatter groups as the stable argsort does, the main rows' probe "
          f"in bin order ({lanes} lanes a query) with the unsort torch.equal "
          f"to probe_rows_plain")
    res["ext"] = ext_check(f"B2 float64, the 998k box's {n} cold queries",
                           grid, r, cand_kernel, locate, bound64)
    res.update(n_ext=res["ext"]["n_ext"], n_walk=res["ext"]["n_walk"])

    lib = _kernels.lib()
    stream = torch.cuda.current_stream().cuda_stream
    rmin, inv_h = (t.contiguous() for t in bins[:2])
    counts_b = torch.zeros(n_bins, dtype=torch.int32, device=dev)
    bin_buf, rank_buf, perm_buf, slot_buf = (
        torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4))

    def bin_pass():  # with the memset of the counts
        counts_b.zero_()
        _kernels.check(lib.iu_cand_bin_pass_f64(
            r.data_ptr(), n, rmin.data_ptr(), inv_h.data_ptr(),
            *grid.cand_shape, counts_b.data_ptr(), bin_buf.data_ptr(),
            rank_buf.data_ptr(), stream), "iu_cand_bin_pass_f64")

    bin_pass()
    scan = torch.cumsum(counts_b, 0, dtype=torch.int32)

    def scatter():
        _kernels.check(lib.iu_cand_bin_scatter(
            bin_buf.data_ptr(), rank_buf.data_ptr(), scan.data_ptr(), n,
            perm_buf.data_ptr(), slot_buf.data_ptr(), stream),
            "iu_cand_bin_scatter")

    n_vars = len(lay.var_roles)
    n_words = 2 * n_vars
    rec = torch.empty((n, 2 + n_words), dtype=torch.int32, device=dev)
    outs = (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty((n, n_vars), dtype=torch.float64, device=dev))

    def unsort():
        _kernels.check(lib.iu_cand_bin_unsort(
            rec.data_ptr(), slot.data_ptr(), n, n_words, outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), stream),
            "iu_cand_bin_unsort")

    def unsort_plain():
        back = rec[slot.long()]
        return back[:, 0], back[:, 1], back[:, 2:].view(torch.float64)

    binned_probe_call(grid, r, perm, lay, eps, k, lanes, rec,
                      ext=(grid.cand_ext_table, locate._row_layout(
                          grid, grid.cand_ext_ids.shape[1], var)))
    unsort()
    res["unsort_err"] = float(equal_or_fail("B2 float64 unsort", outs,
                                            unsort_plain()))
    t = {
        "bin_pass": cuda_ms(bin_pass, 10),
        "bin_scatter": cuda_ms(scatter, 10),
        "bin_unsort": cuda_ms(unsort, 10),
    }
    tp = {
        "bin_pass": cuda_ms(lambda: torch.bincount(geometry.bin_flat(
            geometry.bin_ijk(r, *bins, torch.int32), grid.cand_shape).long(),
            minlength=n_bins), 3),
        "bin_scatter": cuda_ms(lambda: cand_kernel.bin_order_plain(idx), 3),
        "bin_unsort": cuda_ms(unsort_plain, 3),
    }
    lib_ms = {"bin_scatter": cuda_ms(lambda: torch.argsort(idx, stable=True),
                                     3),
              "bin_unsort": cuda_ms(lambda: rec[slot.long()], 3)}
    # bounds, each byte once, FP64; per query its inputs and outputs (a
    # record of 2 + 2 n_vars words between the probe and the unsort)
    n_rows = int(torch.unique(idx).numel())
    rec_b = 4 * (2 + n_words)
    bnd = {
        "bin_pass": bound64(n * (24 + 8) + n_bins * 4, n * 9),
        "bin_scatter": bound64(n * 16 + n_rows * 4, 0),
        "bin_unsort": bound64(n * (4 + 2 * rec_b), 0),
    }
    for name in t:
        print(f"B2 float64 {name}: kernel {t[name]:.4f} ms, plain "
              f"{tp[name]:.4f} ms"
              + (f", library call {lib_ms[name]:.4f} ms" if name in lib_ms
                 else "")
              + f"; bound {bnd[name][0]:.4f} ms ({bnd[name][1]})")
    res["stages"] = {name: dict(ms=t[name], plain_ms=tp[name],
                                library_ms=lib_ms.get(name),
                                bound=bnd[name]) for name in t}
    ex = res["ext"]
    res["stages"]["probe"] = dict(ms=ex["ms"], plain_ms=ex["plain_ms"],
                                  library_ms=None, bound=ex["bound"])
    return res


def f64_warm(dev, tiu, grid, locate, walk_kernel, counters):
    """B3 in double on the float64 walk grid of the box: 10M cold queries
    (bin-seeded walks), the same points moved and guessed by the cold
    cells plus 1% pushed out of the box, every walk in get_cell's walk
    stage, then E1; both B3 kernels against their plain versions."""
    from interpolate_unstructured_tpu_torch.ops import icell_kernel

    gc_key = f"{walk_kernel.__name__}:get_cell"
    ik = icell_kernel.__name__
    res = {"gc_launches": {}, "e1_launches": {}}
    rng = np.random.default_rng(4)
    r = torch.from_numpy(0.1 + 0.8 * rng.random((N_CAND, 3))).to(dev)
    r_warm = r + 0.01 * torch.from_numpy(rng.random((N_CAND, 3))).to(dev)
    (vals, ic, found), counts = main_path(
        lambda: tiu.interpolate_scalar_at(grid, r, 0, fill_value=FILL),
        counters)
    res["gc_launches"]["cold"] = counts[gc_key]
    res["e1_launches"]["cold"] = counts[ik]
    check(counts[gc_key] >= 1 and counts[ik] >= 1, "float64 cold walks: "
          "get_cell's walk stage or E1 was not launched")
    check(bool(found.all()), f"float64 cold walks: {int((~found).sum())} "
          "queries not found")
    lin_c = float((vals - (r.sum(1) + 1.0)).abs().max())
    check(lin_c <= LIN_TOL_F64, f"float64 cold walks: linear error {lin_c}")
    r_out = r_warm[:N_OFF].clone()
    r_out[:, 0] = 1.01 + 0.5 * torch.from_numpy(rng.random(N_OFF)).to(dev)
    rq = torch.cat([r_warm, r_out])
    guess = torch.cat([ic, ic[:N_OFF]])
    del r_out, vals, found
    (vals, ic_w, found), counts = main_path(
        lambda: tiu.interpolate_scalar_at(grid, rq, 0, guess=guess,
                                          fill_value=FILL), counters)
    res["gc_launches"]["warm"] = counts[gc_key]
    res["e1_launches"]["warm"] = counts[ik]
    check(counts[gc_key] >= 1 and counts[ik] >= 1, "float64 warm: "
          "get_cell's walk stage or E1 was not launched")
    check(bool(found[:N_CAND].all()), "float64 warm: an inside query was "
          "not found")
    check(not bool(found[N_CAND:].any()), "float64 warm: an outside query "
          "was found")
    check(bool((ic_w[N_CAND:] < 0).all() and (vals[N_CAND:] == FILL).all()),
          "float64 warm: outside queries lack a boundary code or the fill")
    lin_w = float((vals[:N_CAND] - (r_warm.sum(1) + 1.0)).abs().max())
    check(lin_w <= LIN_TOL_F64, f"float64 warm: linear error {lin_w}")
    # the last 1M (900,000 inside, the 100,000 outside) for the oracle
    res["oracle"] = dict(oracle_sample(rq, (vals, ic_w, found),
                                       slice(rq.shape[0] - ORACLE_N, None),
                                       guess=guess),
                         band=oracle_band(grid, host64(grid.points)))
    del vals, found
    cold_s = steady_s(lambda: tiu.interpolate_scalar_at(grid, r, 0), 3)
    warm_s = steady_s(lambda: tiu.interpolate_scalar_at(grid, rq, 0,
                                                        guess=guess), 3)
    loc_w = steady_s(lambda: tiu.get_cell(grid, rq, guess), 3)
    print(f"B3 float64 walk grid, 10M cold interpolate_scalar_at: steady "
          f"{cold_s * 1e3:.4f} ms = {N_CAND / cold_s:.4e} queries/s, linear "
          f"error {lin_c:.3e}; {rq.shape[0]} warm (1% outside): steady "
          f"{warm_s * 1e3:.4f} ms = {rq.shape[0] / warm_s:.4e} queries/s "
          f"(get_cell {loc_w * 1e3:.4f} ms), inside all found, outside none, "
          f"linear error {lin_w:.3e}")
    max_steps = grid.config.max_walk_steps
    p1 = grid.config.walk_phase1_steps
    gc_err = 0
    for label, q, st in (("warm", rq, guess), ("cold", r, None)):
        gc_err += equal_or_fail(
            f"B3 float64 get_cell walk, {label}",
            walk_kernel.get_cell_walk_cuda(grid, q, st, max_steps, p1),
            walk_kernel.get_cell_walk_plain(grid, q, st, max_steps, p1))
    ms_gc = cuda_ms(lambda: walk_kernel.get_cell_walk_cuda(
        grid, rq, guess, max_steps, p1), 10)
    ms_gc_p = cuda_ms(lambda: walk_kernel.get_cell_walk_plain(
        grid, rq, guess, max_steps, p1), 1)
    bnd_gc, rounds, rows = gc_bound(grid, rq, guess, max_steps, p1,
                                    walk_kernel, bound64)
    print(f"B3 float64 get_cell walk, {rq.shape[0]} warm queries: (ic, found) "
          f"torch.equal to get_cell_walk_plain, the 10M cold ones too; kernel "
          f"{ms_gc:.4f} ms, plain {ms_gc_p:.4f} ms, bound {bnd_gc[0]:.4f} ms "
          f"({bnd_gc[1]}; {rounds} rounds, {rows} distinct walk rows)")
    res["gc"] = dict(ms=ms_gc, plain_ms=ms_gc_p, bound=bnd_gc,
                     max_abs_err=float(gc_err))
    # the explicit walk (walk_rows) against its plain version on the 10M
    # warm walks from the cold cells' centers, and timed there
    r0 = walk_kernel.walk_origin(grid.walk_table, ic, grid.n_faces_per_cell,
                                 grid.n_points_per_cell)
    args = locate._walk_args(grid, r0, r_warm, ic)
    k_out = walk_kernel.walk_cuda(*args)
    p_out = walk_kernel.walk_rows_plain(*args)
    res["walk_err"] = float(equal_or_fail("B3 float64 walk_rows", k_out,
                                          p_out))
    steps = int(k_out[2].sum())
    del k_out, p_out
    ms_w = cuda_ms(lambda: walk_kernel.walk_cuda(*args), 10)
    ms_wp = cuda_ms(lambda: walk_kernel.walk_rows_plain(*args), 1)
    ms_walk = cuda_ms(lambda: tiu.walk(grid, r0, r_warm, ic), 10)
    bnd_w, bnd_old = walk_bound(grid.walk_table, args[1:], walk_kernel,
                                grid.n_faces_per_cell, bound64)
    print(f"B3 float64 walk_rows, {N_CAND} warm walks ({steps / N_CAND:.4f} "
          f"steps a walk): all four outputs torch.equal to walk_rows_plain; "
          f"kernel {ms_w:.4f} ms, plain {ms_wp:.4f} ms, public walk() "
          f"{ms_walk:.4f} ms (CUDA events), bound {bnd_w[0]:.4f} ms "
          f"({bnd_w[1]}; {bnd_old[0]:.4f} ms with the first design's "
          f"inputs)")
    res["walk"] = dict(ms=ms_w, plain_ms=ms_wp, bound=bnd_w,
                       bound_old=bnd_old, walk_ms=ms_walk)
    res.update(cold_s=cold_s, warm_s=warm_s, lin_c=lin_c, lin_w=lin_w)
    return res


def f64_trace(dev, tiu, grid, walk_kernel, trace_kernel, counters):
    """bench.py's helix on the float64 walk grid, 1024 lines: the generic
    path (B3's double walk_rows + torch, no B4), every TraceResult field
    torch.equal to the same loop with the plain walks on the card."""
    from interpolate_unstructured_tpu_torch.ops import icell_kernel

    c = grid.points[:, :2] - 0.5
    fld = (-c[:, 1], c[:, 0], torch.full_like(c[:, 0], 0.25))
    i_field = []
    for name, v in zip(("vx", "vy", "vz"), fld):
        grid, i = tiu.add_point_data(grid, name, v, fuse=False)
        i_field.append(i)
    table = tiu.build_trace_table(grid, i_field)
    y0 = torch.from_numpy(0.3 + 0.4 * np.random.default_rng(3).random(
        (TRACE_N[0], 3))).to(dev)
    kw = dict(TRACE_KW, trace_table=table)

    def trace():
        return tiu.integrate_along_field(grid, y0, i_field, **kw)

    trace()  # warm-up
    walks = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_calls(walk_kernel, "walk_rows", walks):
        out, counts = main_path(trace, counters)
    wall = time.perf_counter() - t0
    n_b4 = counts[trace_kernel.__name__]
    n_walk = counts[walk_kernel.__name__]
    n_gc = counts[f"{walk_kernel.__name__}:get_cell"]
    n_e1 = counts[icell_kernel.__name__]
    check(n_b4 == 0, f"the float64 trace launched B4 {n_b4} times")
    check(n_e1 == 1, f"the float64 trace launched E1 {n_e1} times for its "
          "start field, not once")
    check(n_walk >= 1 and n_gc >= 1, f"the float64 trace launched walk_rows "
          f"{n_walk} and get_cell's walk {n_gc} times")
    check(out.y.dtype == torch.float64, "the float64 trace is not float64")
    oracle = dict(out=trace_host(out), y0=host64(y0),
                  field=np.stack([host64(f) for f in fld], axis=1))
    with plain_walks(walk_kernel):
        p_out = trace()
    for name, a, b in zip(out._fields, out, p_out):
        check(torch.equal(a, b), f"float64 trace: {name} differs from the "
              "loop with the plain walks")
    max_steps = TRACE_KW["max_steps"]
    steps = int(out.n_steps.clamp(max=max_steps).sum())
    codes = {int(k): int(v) for k, v in zip(*torch.unique(
        out.boundary_material, return_counts=True))}
    check(tiu.trace.BM_STEP_CAP not in codes, "float64 trace: step-cap ends")
    walls = []
    for _ in range(TRACE_REPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trace()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    med = float(np.median(walls))
    with plain_walks(walk_kernel):
        plain_ms = steady_s(trace, 1) * 1e3
    print(f"float64 generic trace, {TRACE_N[0]} lines: {steps} steps; "
          f"main-path call {wall * 1e3:.4f} ms, median of {TRACE_REPS} more "
          f"{med:.4f} ms = {steps / med * 1e3:.4e} trace steps/s (with the "
          f"plain walks {plain_ms:.4f} ms); launches: walk_rows {n_walk}, "
          f"get_cell walk {n_gc}, E1 {n_e1}, B4 0; walk_rows CUDA events "
          f"over the call: {sum(walks['ms']):.4f} ms in "
          f"{len(walks['ms'])} launches; "
          f"every TraceResult field torch.equal to the loop with the plain "
          f"walks; boundary codes {json.dumps(codes)}")
    # walk_rows in double at the size the generic trace launches it: its
    # first stage walk, against its plain version, timed
    w_args, _ = walks["inputs"][0]
    w_err = float(equal_or_fail(
        f"B3 float64 walk_rows, {TRACE_N[0]} generic-trace walks",
        walk_kernel.walk_cuda(*w_args), walk_kernel.walk_rows_plain(*w_args)))
    w_ms, w_ev = kernel_ms(lambda: walk_kernel.walk_cuda(*w_args), "walk",
                           WALK_REPS)
    w_plain = cuda_ms(lambda: walk_kernel.walk_rows_plain(*w_args), 3)
    w_bound, w_bound_old = walk_bound(w_args[0], w_args[1:], walk_kernel,
                                      grid.n_faces_per_cell, bound64)
    print(f"B3 float64 walk_rows, {w_args[1].shape[0]} walks of the generic "
          f"trace (its first stage walk), torch.equal to walk_rows_plain: "
          f"kernel {'not measured' if w_ms is None else f'{w_ms:.4f} ms'} "
          f"(profiler device time), CUDA events {w_ev:.4f} ms a call, plain "
          f"{w_plain:.4f} ms, bound {w_bound[0]:.4f} ms ({w_bound[1]}; "
          f"{w_bound_old[0]:.4f} ms with the first design's inputs)")
    return dict(walk_launches=n_walk, gc_launches=n_gc, e1_launches=n_e1,
                wall_ms=med, steps=steps, walk_ms=sum(walks["ms"]),
                oracle=oracle,
                walk_small=dict(n=w_args[1].shape[0], ms=w_ms, ev_ms=w_ev,
                                plain_ms=w_plain, bound=w_bound,
                                bound_old=w_bound_old, max_abs_err=w_err))


def float64_phase(dev, tiu, meshgen, interp_kernel, locate, cand_kernel,
                  walk_kernel, trace_kernel, card):
    """Float64 grids on the card at full width: B1 in double on the three
    brute-force meshes; the 998,250-tet box in float64 (lists from D1 and
    D2), 10M cold queries through B2 in double (bin order, the extension
    rows probed in the same launch, then interpolate_at_icell); the
    box's float64 walk grid (no candidate tables) with 10.1M warm queries
    through B3's double get_cell walk; a float64 generic trace on it."""
    from interpolate_unstructured_tpu_torch.ops import (
        cand_build_kernel,
        icell_kernel,
    )

    counters = (interp_kernel, cand_kernel, walk_kernel, icell_kernel)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = {"bf": f64_bruteforce(dev, tiu, meshgen, interp_kernel, counters)}

    n = 55
    pts, cells, nbrs = meshgen.tet_box_mesh(n, n, n)
    pdata = {"Polynomial": pts.sum(1) + 1.0}
    timings = {}
    t0 = time.perf_counter()
    grid, counts = main_path(lambda: tiu.build_grid(
        pts, cells, nbrs, "tetra", point_data=pdata, dtype=torch.float64,
        locate_mode="walk", device=dev, timings=timings,
    ), counters + (cand_build_kernel,))
    build_s = time.perf_counter() - t0
    d_launches = builder_launches(counts)
    check(min(d_launches.values()) >= 1, f"float64 build_grid of the box did "
          f"not launch D1 and D2: {d_launches}")
    k = grid.cand_ids.shape[1]
    n_bins = grid.cand_count.numel()
    n_ext_bins = int((grid.cand_count > k).sum())
    mem = {name: t.numel() * t.element_size() / 1e9 for name, t in (
        ("walk rows", grid.walk_table), ("main rows", grid.cand_table),
        ("extension rows", grid.cand_ext_table))}
    print(f"float64 box tet_box_mesh({n},{n},{n}): {grid.n_cells} tets, "
          f"build_grid {build_s:.3f} s split "
          + json.dumps({kk: round(v, 4) for kk, v in timings.items()})
          + f"; D1/D2 launches {json.dumps(d_launches)}; K={k}, fused "
          f"variables {grid.cand_nv}, extension rows k_ext="
          f"{grid.cand_ext_ids.shape[1]} for {n_ext_bins} of {n_bins} bins; "
          + ", ".join(f"{a} {b:.3f} GB" for a, b in mem.items()))
    check(grid.cand_table.dtype == torch.float64
          and grid.cand_ext_table is not None,
          "the float64 box has no float64 candidate rows with extension rows")
    builder_grid_match("float64 box", grid, pts, cells, nbrs, dev)
    r = torch.from_numpy(np.random.default_rng(2).random((N_CAND, 3))).to(dev)
    res["cold"] = f64_cold(dev, tiu, grid, r, locate, cand_kernel,
                           walk_kernel, counters)
    res["cold"].update(build_s=build_s, timings=timings,
                       d_launches=d_launches)
    del grid, r
    torch.cuda.empty_cache()

    timings = {}
    t0 = time.perf_counter()
    wgrid, counts = main_path(lambda: tiu.build_grid(
        pts, cells, nbrs, "tetra", point_data=pdata, dtype=torch.float64,
        locate_mode="walk", device=dev, timings=timings,
        config=tiu.IUConfig(use_candidate_bins=False),
    ), counters)
    wbuild_s = time.perf_counter() - t0
    refine = counts[f"{walk_kernel.__name__}:get_cell"]
    check(wgrid.cand_table is None and refine >= 1,
          "the float64 walk grid has candidate tables or no refine walks")
    print(f"float64 walk grid (no candidate tables): build_grid "
          f"{wbuild_s:.3f} s split "
          + json.dumps({kk: round(v, 4) for kk, v in timings.items()})
          + f"; {int(np.prod(wgrid.bin_shape))} seed bins self-located by "
          f"the refine ({refine} get_cell walk launches)")
    res["warm"] = f64_warm(dev, tiu, wgrid, locate, walk_kernel, counters)
    res["warm"]["gc_launches"]["refine"] = refine
    res["trace"] = f64_trace(dev, tiu, wgrid, walk_kernel, trace_kernel,
                             counters + (trace_kernel,))
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"float64 phase: torch.cuda.max_memory_allocated "
          f"{res['peak_gb']:.3f} GB [{card}]")
    tr = res["trace"]
    res["oracle"] = dict(
        mesh=(host64(pts), host32i(cells), host32i(nbrs),
              host64(pdata["Polynomial"])),
        cold=res["cold"]["oracle"], warm=res["warm"]["oracle"],
        trace=tr["oracle"],
        rates=dict(cold_qps=N_CAND / res["cold"]["e2e_s"],
                   warm_qps=(N_CAND + N_OFF) / res["warm"]["warm_s"],
                   trace_sps=tr["steps"] / tr["wall_ms"] * 1e3))
    return res


SHARD_TRACE_N = TRACE_N[1]  # lines of the sharded trace
SHARD_TIMEOUT_S = 600  # a group of ranks must end within this
SHARD_OUT = {  # the sharded sequence's steps and their outputs
    "cold": ("values", "i_cell", "found"),
    "warm": ("values", "i_cell", "found"),
    "get_cell": ("i_cell", "found"),
    "cell_scalar": ("values", "i_cell", "found"),
    "icell_scalar": ("values", "i_cell", "found"),
    "acc_b5": ("vals_hi", "vals_lo", "found", "i_cell"),
    "acc_df": ("vals_hi", "vals_lo", "found", "i_cell"),
    "trace": ("y", "y_field", "n_steps", "boundary_material",
              "n_iterations"),
}


def rank_block(n, rank, world):
    """Rank's rows [lo, hi) of ``n``: unequal shares world + 1 - rank (6M
    and 4M of 10M for two ranks)."""
    w = np.arange(world + 1, 1, -1)
    cuts = np.concatenate([[0], np.cumsum(w)]) * n // w.sum()
    return int(cuts[rank]), int(cuts[rank + 1])


def digest(a):
    """[dtype, shape, sha256 of the bytes] of a host array or a tensor:
    equal digests are equal arrays, bit for bit."""
    import hashlib

    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    a = np.ascontiguousarray(a)
    return [str(a.dtype), list(a.shape),
            hashlib.sha256(a.tobytes()).hexdigest()]


def trace_seeds(n):
    """The trace phase's seeds, in float32."""
    return (0.3 + 0.4 * np.random.default_rng(3).random((n, 3))).astype(
        np.float32)


def with_cell_data(tiu, grid):
    """The grid with the cell lookups' data: rho (cell data), mat (icell
    data).  Returns (grid, i_rho, i_mat)."""
    n = grid.n_cells
    grid, icd = tiu.add_cell_data(grid, "rho", np.arange(n) + 0.5)
    grid, iicd = tiu.add_icell_data(grid, "mat", 7 - np.arange(n))
    return grid, icd, iicd


def warm_guess(ic, n_warm):
    """The warm queries' guesses: the cold cells, then those of the
    queries pushed out of the box (the first ones, moved)."""
    cat = torch.cat if isinstance(ic, torch.Tensor) else np.concatenate
    return cat([ic, ic[:n_warm - ic.shape[0]]])


def trace_blocks(tiu, helix, i_field, y0, world):
    """The single-device trace of each rank's block of ``y0`` as the rank
    holds it (padded with its last line to the largest block, as
    distribute_queries pads for one card a rank), the valid lines
    concatenated in rank order: the five batch fields.  Also the start
    cells get_cell gives each padded block (the tracer's first call)."""
    blocks = [rank_block(y0.shape[0], rank, world) for rank in range(world)]
    per = max(hi - lo for lo, hi in blocks)
    fields, cells = [], []
    for lo, hi in blocks:
        y = y0[lo:hi]
        y = torch.cat([y, y[-1:].expand(per - (hi - lo), -1)])
        res = tiu.integrate_along_field(helix, y, i_field, **TRACE_KW)
        fields.append([x[:hi - lo] for x in res[:5]])
        cells.append(tiu.get_cell(helix, y)[0][:hi - lo])
    return [torch.cat(x) for x in zip(*fields)], torch.cat(cells)


def trace_refs(tiu, helix, i_field, worlds, dev, card):
    """{world: {"trace/<field>": digest}}: the single-device trace of
    SHARD_TRACE_N helix lines taken block by block as ``world`` ranks
    hold them.  get_cell on a walk grid walks in two phases from
    walk_compact_min_batch queries on (the JAX package's rule), so a
    block's start cells may differ from the whole batch's where a seed
    lies on a face two cells share; the blocks of two ranks are held
    against the whole batch: every field bit for bit, but the start
    field y_field[:, 0] of the lines whose start cell differs, which
    must agree to LIN_TOL_ICELL."""
    y0 = torch.from_numpy(trace_seeds(SHARD_TRACE_N)).to(dev)
    whole = tiu.integrate_along_field(helix, y0, i_field, **TRACE_KW)
    refs = {}
    for world in worlds:
        fields, cells = trace_blocks(tiu, helix, i_field, y0, world)
        refs[world] = {f"trace/{f}": digest(x)
                       for f, x in zip(SHARD_OUT["trace"], fields)}
        if world == 1:
            continue
        moved = cells != tiu.get_cell(helix, y0)[0]
        for f, a, b in zip(SHARD_OUT["trace"], fields, whole):
            if f == "y_field":
                check(same_bits(a[:, 1:], b[:, 1:]), "trace blocks: y_field "
                      "past the start differs from the whole batch's")
                a, b = a[:, 0], b[:, 0]
                differ = (a != b).any(1)
                check(not bool((differ & ~moved).any()), "trace blocks: a "
                      "start field differs where the start cell does not")
                err = float((a - b).abs().max())
                check(err <= LIN_TOL_ICELL, f"trace blocks: start fields "
                      f"differ by {err}")
            else:
                check(same_bits(a, b), f"trace blocks: {f} differs from the "
                      "whole batch's")
        print(f"sharded trace reference, {world} blocks of "
              f"{SHARD_TRACE_N} lines against the whole batch: "
              f"{int(moved.sum())} start cells differ (seeds on a shared "
              f"face; the whole batch walks in two phases, the blocks in "
              f"one), {int(differ.sum())} start fields differ by at most "
              f"{err:.3e}; every other field bit for bit [{card}]")
    return refs


def shard_refs(tiu, grid, r64, warm_r, dev):
    """The single-device results of the sharded sequence's query steps on
    the same inputs: {step/output: digest}."""
    refs = {}

    def keep(name, res):
        for f, a in zip(SHARD_OUT[name], res):
            refs[f"{name}/{f}"] = digest(a)

    r = torch.from_numpy(r64.astype(np.float32)).to(dev)
    rw = torch.from_numpy(warm_r).to(dev)
    cold = tiu.interpolate_at(grid, r, [0])
    keep("cold", cold)
    guess = warm_guess(cold[1], rw.shape[0])
    keep("warm", tiu.interpolate_at(grid, rw, [0], guess))
    gc, icd, iicd = with_cell_data(tiu, grid)
    keep("get_cell", tiu.get_cell(gc, rw, guess))
    keep("cell_scalar", tiu.get_cell_scalar_at(gc, r, icd))
    keep("icell_scalar", tiu.get_icell_scalar_at(gc, r, iicd))
    del gc, cold, guess, rw
    r = torch.from_numpy(r64).to(dev)
    for name, build_df in (("acc_b5", False), ("acc_df", True)):
        grid = tiu.prepare_accurate(grid, build_df=build_df)
        keep(name, tiu.interpolate_at_acc(grid, r, (0,)))
    return refs


def shard_sequence(rank, world, tmp):
    """One rank's sharded sequence: its unequal block of each batch
    through distribute_queries, the sharded call, then collect_results of
    every output; the warm guesses are the collected cold cells.  Returns
    {"digests": {step/output: digest}, "ms": {step: {"call", "collect"}},
    "counts": {step: launches}, "n_rounds", "peak_gb", "device"}."""
    import os

    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.ops import (
        acc_kernel,
        cand_kernel,
        icell_kernel,
        trace_kernel,
        walk_kernel,
    )
    from interpolate_unstructured_tpu_torch.parallel import sharding as ps

    dev = torch.device("cuda", torch.cuda.current_device())
    counters = (cand_kernel, walk_kernel, trace_kernel, acc_kernel,
                icell_kernel)
    mesh = ps.make_mesh()
    with open(os.path.join(tmp, "shard_inputs.json")) as f:
        meta = json.load(f)
    r64 = np.load(os.path.join(tmp, "r64.npy"), mmap_mode="r")
    warm_r = np.load(os.path.join(tmp, "warm_r.npy"), mmap_mode="r")

    def block(a):
        lo, hi = rank_block(a.shape[0], rank, world)
        return np.array(a[lo:hi])

    grid = tiu.load_grid(os.path.join(tmp, "box.binda"), device=dev)
    helix = tiu.load_grid(os.path.join(tmp, "walk_helix.binda"),
                          config=tiu.IUConfig(**meta["walk_config"]),
                          device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"digests": {}, "ms": {}, "counts": {}, "device": str(dev)}

    def step(name, fn, local_b):
        t0 = time.perf_counter()
        res, counts = main_path(fn, counters)
        call_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got = [ps.collect_results(x, local_b)
               for x in res[:len(SHARD_OUT[name])]]
        out["ms"][name] = {"call": call_ms,
                           "collect": (time.perf_counter() - t0) * 1e3}
        out["counts"][name] = {k: v for k, v in counts.items() if v}
        for f, a in zip(SHARD_OUT[name], got):
            out["digests"][f"{name}/{f}"] = digest(a)
        return res, got

    r_sh, b = ps.distribute_queries(block(r64).astype(np.float32), mesh)
    interp = ps.sharded_interpolate_at(mesh)
    g = ps.replicate_grid(grid, mesh)
    _, cold = step("cold", lambda: interp(g, r_sh, [0]), b)
    w_sh, bw = ps.distribute_queries(block(warm_r), mesh)
    guess, _ = ps.distribute_queries(
        block(warm_guess(cold[1], warm_r.shape[0])), mesh)
    step("warm", lambda: interp(g, w_sh, [0], guess), bw)
    gc, icd, iicd = with_cell_data(tiu, grid)
    gc = ps.replicate_grid(gc, mesh)
    step("get_cell", lambda: ps.sharded_get_cell(mesh)(gc, w_sh, guess), bw)
    step("cell_scalar",
         lambda: ps.sharded_get_cell_scalar_at(mesh)(gc, r_sh, icd), b)
    step("icell_scalar",
         lambda: ps.sharded_get_icell_scalar_at(mesh)(gc, r_sh, iicd), b)
    del g, gc, w_sh, guess
    r_sh, _ = ps.distribute_queries(block(r64), mesh)
    acc = ps.sharded_interpolate_at_acc(mesh)
    for name, build_df in (("acc_b5", False), ("acc_df", True)):
        grid = tiu.prepare_accurate(grid, build_df=build_df)
        g = ps.replicate_grid(grid, mesh)
        step(name, lambda: acc(g, r_sh, [0]), b)
    del grid, g, r_sh
    y_sh, by = ps.distribute_queries(block(trace_seeds(SHARD_TRACE_N)), mesh)
    h = ps.replicate_grid(helix, mesh)
    tracer = ps.sharded_trace(mesh, **TRACE_KW)
    res, _ = step("trace", lambda: tracer(h, y_sh, meta["i_field"]), by)
    out["n_rounds"] = int(res.n_rounds)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def shard_rank(rank, world, backend, port, tmp):
    """One rank: its card, the process group, the sequence; the report
    goes to ``tmp/shard_<backend>_<rank>.json``."""
    import os

    import torch.distributed as dist

    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        out = shard_sequence(rank, world, tmp)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"shard_{backend}_{rank}.json"), "w") as f:
        json.dump(out, f)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world, backend, tmp):
    """Spawn ``world`` ranks of :func:`shard_rank` and wait for them all.
    A rank that fails, or ranks still running after SHARD_TIMEOUT_S,
    raise, and every rank still running is stopped.  Returns (the ranks'
    reports, seconds)."""
    import os

    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        shard_rank, args=(world, backend, free_port(), tmp), nprocs=world,
        join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() - t0 < SHARD_TIMEOUT_S,
                  f"{backend} ranks still running after {SHARD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    reports = []
    for rank in range(world):
        with open(os.path.join(tmp, f"shard_{backend}_{rank}.json")) as f:
            reports.append(json.load(f))
    return reports, time.perf_counter() - t0


def in_process_shards(ps, label, mesh, grid, args, b, refs, counters):
    """sharded_interpolate_at(mesh)(grid's copies, *args), counted, its
    outputs collected (trimmed to ``b``) and held against ``refs`` bit for
    bit.  Returns (ms of that call, steady ms, launches, the outputs)."""
    grid_r = ps.replicate_grid(grid, mesh)
    call = ps.sharded_interpolate_at(mesh)
    t0 = time.perf_counter()
    res, counts = main_path(lambda: call(grid_r, *args), counters)
    ms = (time.perf_counter() - t0) * 1e3
    for f, x, want in zip(SHARD_OUT["cold"], res, refs):
        got = torch.from_numpy(ps.collect_results(x, b))
        check(same_bits(got, want.cpu()), f"sharded {label}: {f} differs "
              "from the single-device call")
    steady = steady_s(lambda: call(grid_r, *args), 3) * 1e3
    return ms, steady, counts, res


def rank_launches(counts, kernels):
    """B2, B3, B4, B5 and E1 launches of a rank's report, summed over its
    steps."""
    cand_kernel, walk_kernel, trace_kernel, acc_kernel, icell_kernel = kernels
    ck, wk = cand_kernel.__name__, walk_kernel.__name__
    total = {}
    for c in counts.values():
        add_counts(total, c)
    return {
        "B2 in bin order": total.get(f"{ck}:binned", 0),
        "B2 with extension rows": total.get(f"{ck}:ext", 0),
        "B2-df": total.get(f"{ck}:df", 0),
        "B3 get_cell walk": total.get(f"{wk}:get_cell", 0),
        "B3 walk_rows": total.get(wk, 0),
        "B4": total.get(trace_kernel.__name__, 0),
        "B5": total.get(acc_kernel.__name__, 0),
        "E1": total.get(icell_kernel.__name__, 0),
    }


def sharded_phase(dev, tiu, meshgen, cand_grid, walk_grid, counters, card,
                  tmp):
    """parallel/sharding.py on the card.  In this process,
    sharded_interpolate_at on two shards of the card for the 750-tet
    brute-force mesh (B1), and on make_mesh() and two shards for the
    998k box's 10M cold and 10.1M warm queries; then the whole sharded
    sequence in spawned ranks, two over gloo on one card and one a card
    over NCCL, every collected result held against the single-device
    call bit for bit; then the port's examples on the card."""
    import os

    from interpolate_unstructured_tpu_torch.parallel import sharding as ps

    (interp_kernel, cand_kernel, walk_kernel, acc_kernel, icell_kernel,
     trace_kernel) = counters
    ck, gk = cand_kernel.__name__, f"{walk_kernel.__name__}:get_cell"
    res = {"counts": {}}
    torch.cuda.reset_peak_memory_stats()
    two = ps.make_mesh([dev, dev])
    meshes = {"make_mesh()": ps.make_mesh(), "two shards of cuda:0": two}
    print(f"sharded: make_mesh() = {[str(d) for d in meshes['make_mesh()']]}"
          f", {torch.cuda.device_count()} visible card(s) [{card}]")

    # B1: the 750-tet brute-force mesh, 1M + 1% queries on two shards
    cell_type, label, (pts, cells, nbrs) = bf_meshes(meshgen)[2]
    g_bf = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                          point_data={"Polynomial": pts.sum(1) + 1.0},
                          device=dev)
    r = bf_queries(pts, np.random.default_rng(1), dev)
    r_sh, b = ps.shard_batch(r, two)
    ms, steady, counts, _ = in_process_shards(
        ps, f"B1 {label}, two shards", two, g_bf, (r_sh, [0]), b,
        tiu.interpolate_at(g_bf, r, [0]), counters)
    check(counts[interp_kernel.__name__] >= 1, "sharded interpolation on "
          "the brute-force mesh did not launch B1")
    add_counts(res["counts"], counts)
    print(f"sharded in process, B1 {label}: {r.shape[0]} queries on two "
          f"shards torch.equal to the single-device call; the counted call "
          f"{ms:.4f} ms, steady {steady:.4f} ms; launches "
          + json.dumps({k: v for k, v in counts.items() if v}))
    del g_bf, r, r_sh

    # The 998k box: 10M cold, then 10.1M warm (1% outside) guessed by the
    # cold cells, built as the candidate phase builds them
    r64 = np.random.default_rng(2).random((N_CAND, 3))
    r = torch.from_numpy(r64.astype(np.float32)).to(dev)
    rng = np.random.default_rng(5)
    vel = torch.from_numpy(rng.random((N_CAND, 3)).astype(np.float32)).to(dev)
    r_in = 0.005 + 0.98 * r + 0.01 * vel
    n_out = N_CAND // 100
    r_out = r_in[:n_out].clone()
    r_out[:, 1] = 1.01 + 0.5 * torch.from_numpy(
        rng.random(n_out).astype(np.float32)).to(dev)
    rw = torch.cat([r_in, r_out])
    del vel, r_in, r_out
    cold_ref = tiu.interpolate_at(cand_grid, r, [0])
    guess = warm_guess(cold_ref[1], rw.shape[0])
    warm_ref = tiu.interpolate_at(cand_grid, rw, [0], guess)
    single = {
        "cold_ms": steady_s(lambda: tiu.interpolate_at(cand_grid, r, [0]),
                            3) * 1e3,
        "warm_ms": steady_s(lambda: tiu.interpolate_at(
            cand_grid, rw, [0], guess), 3) * 1e3}
    res["in_process"] = {"single device": single}
    for label, mesh in meshes.items():
        r_sh, b = ps.shard_batch(r, mesh)
        cold = in_process_shards(ps, f"10M cold, {label}", mesh, cand_grid,
                                 (r_sh, [0]), b, cold_ref, counters)
        check(cold[2][f"{ck}:binned"] >= 1, f"sharded cold queries on "
              f"{label} did not launch B2 in bin order")
        # the sharded cold cells, collected, are the warm guesses
        ic = torch.from_numpy(ps.collect_results(cold[3][1], b)).to(dev)
        rw_sh, bw = ps.shard_batch(rw, mesh)
        g_sh, _ = ps.shard_batch(warm_guess(ic, rw.shape[0]), mesh)
        warm = in_process_shards(ps, f"10.1M warm, {label}", mesh, cand_grid,
                                 (rw_sh, [0], g_sh), bw, warm_ref, counters)
        check(warm[2][gk] >= 1 and warm[2][icell_kernel.__name__] >= 1,
              f"sharded warm queries on {label} did not launch get_cell's "
              "walk and E1")
        add_counts(res["counts"], cold[2])
        add_counts(res["counts"], warm[2])
        res["in_process"][label] = {"cold_ms": cold[1], "warm_ms": warm[1]}
        print(f"sharded in process, {label} ({len(mesh)} shards): {N_CAND} "
              f"cold and {rw.shape[0]} warm queries, values, cells and found "
              f"masks torch.equal to the single-device calls; the counted "
              f"calls {cold[0]:.4f} / {warm[0]:.4f} ms, steady "
              f"{cold[1]:.4f} / {warm[1]:.4f} ms (single device, steady: "
              f"{single['cold_ms']:.4f} / {single['warm_ms']:.4f} ms) [{card}]")
        del r_sh, rw_sh, g_sh, ic, cold, warm
    res["in_process_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    warm_r = rw.cpu().numpy()
    del r, rw, cold_ref, warm_ref, guess

    # The ranks' inputs: the queries, the helix walk grid's checkpoint
    t0 = time.perf_counter()
    np.save(os.path.join(tmp, "r64.npy"), r64)
    np.save(os.path.join(tmp, "warm_r.npy"), warm_r)
    helix = walk_grid
    c = helix.points[:, :2] - 0.5
    i_field = []
    for name, v in zip(("vx", "vy", "vz"),
                       (-c[:, 1], c[:, 0], torch.full_like(c[:, 0], 0.25))):
        helix, i = tiu.add_point_data(helix, name, v, fuse=False)
        i_field.append(i)
    del c
    path = os.path.join(tmp, "walk_helix.binda")
    tiu.save_grid(helix, path)
    check_same_grid("load_grid of the helix walk grid", helix,
                    tiu.load_grid(path, config=helix.config, device=dev))
    with open(os.path.join(tmp, "shard_inputs.json"), "w") as f:
        json.dump({"i_field": i_field,
                   "walk_config": dataclasses.asdict(helix.config)}, f)
    refs = shard_refs(tiu, cand_grid, r64, warm_r, dev)
    ranks = (("gloo", 2), ("nccl", torch.cuda.device_count()))
    t_refs = trace_refs(tiu, helix, i_field, {w for _, w in ranks}, dev, card)
    del helix, r64, warm_r
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res["inputs_s"] = time.perf_counter() - t0
    print(f"sharded: the ranks' inputs saved and the single-device "
          f"references taken in {res['inputs_s']:.3f} s; this process's "
          f"peak {res['in_process_peak_gb']:.3f} GB")

    # The ranks: two over gloo on one card, then one a card over NCCL
    kernels = (cand_kernel, walk_kernel, trace_kernel, acc_kernel,
               icell_kernel)
    res["ranks"] = {}
    for backend, world in ranks:
        reports, secs = run_ranks(world, backend, tmp)
        want = {**refs, **t_refs[world]}
        for rank, rep in enumerate(reports):
            check(set(rep["digests"]) == set(want), f"{backend} rank {rank} "
                  "collected other outputs than the sequence's")
            bad = [k for k, v in rep["digests"].items() if v != want[k]]
            check(not bad, f"{backend} rank {rank}: collected {bad} differ "
                  "from the single-device results")
            lo_hi = {n: rank_block(n, rank, world)
                     for n in (N_CAND, SHARD_TRACE_N)}
            print(f"sharded {backend} rank {rank}/{world} on {rep['device']}"
                  f" (rows {lo_hi[N_CAND]} of the 10M, lines "
                  f"{lo_hi[SHARD_TRACE_N]}): host-clock ms "
                  + json.dumps({k: {kk: round(vv, 4) for kk, vv in v.items()}
                                for k, v in rep["ms"].items()})
                  + f"; peak {rep['peak_gb']:.3f} GB; n_rounds "
                  f"{rep['n_rounds']}; every collected array equal to the "
                  f"single-device result [{card}]")
        launches = rank_launches(reports[0]["counts"], kernels)
        for name in ("B2 in bin order", "B2-df", "B3 get_cell walk", "B4",
                     "B5", "E1"):
            check(launches[name] >= 1, f"{backend} rank 0 did not launch "
                  f"{name} on the sharded path")
        res["ranks"][backend] = {"world": world, "s": secs,
                                 "launches": launches, "reports": reports}
        print(f"sharded {backend}, {world} rank(s): {secs:.3f} s with the "
              f"spawn; rank 0's launches " + json.dumps(launches))

    # The port's examples on the card, each in its own process
    ex_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "torch_port")
    work = os.path.join(tmp, "examples")
    os.makedirs(work)
    res["examples"] = {}
    for name in sorted(os.listdir(ex_dir)):
        if not name.endswith(".py"):
            continue
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.join(ex_dir, name)],
                             cwd=work, capture_output=True, text=True,
                             timeout=300)
        secs = time.perf_counter() - t0
        check(run.returncode == 0, f"example {name} exited "
              f"{run.returncode}:\n{run.stdout[-2000:]}{run.stderr[-2000:]}")
        res["examples"][name] = secs
        last = run.stdout.strip().splitlines()[-1]
        print(f"example {name} on the card: exit 0 in {secs:.3f} s; {last}")
    check(len(res["examples"]) >= 4, "fewer than 4 examples ran")
    return res


# ---------------------------------------------------------------------
# Oracle phase: the card's answers against the independent serial C++
# oracle (native/serial_oracle.cc, built with g++ on this machine and run
# on one CPU core)

ORACLE_COLD_N = 4096  # float64 cold queries the oracle seeds by 1-NN search
ORACLE_N = 1_000_000  # warm and float32 queries held against it, each grid
ORACLE_TRACE_TOL = 1e-9  # float64 curves (tests/test_torch_trace.py)
ORACLE_STEPS = 8  # step counts may differ at the wall by this much


def host64(t):
    """A tensor or array as a host float64 array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def host32i(t):
    """A tensor or array as a host int32 array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.int32)


def oracle_sample(r, out, rows, guess=None):
    """Host copies of the queries ``r[rows]``, their guesses and the
    card's ``(values, cells, found)`` of one main-path call."""
    vals, ic, found = out
    return dict(r=host64(r[rows]), vals=host64(vals[rows]),
                ic=host32i(ic[rows]),
                found=found[rows].cpu().numpy().astype(bool),
                guess=None if guess is None else host32i(guess[rows]))


def trace_host(out):
    """A TraceResult's (y, y_field, n_steps, boundary_material) on the
    host, the curves as float64."""
    return (host64(out.y), host64(out.y_field), out.n_steps.cpu().numpy(),
            out.boundary_material.cpu().numpy())


def oracle_mesh(grid, points=None, data=None):
    """(points, cells, neighbors, data) of a grid on the host, float64
    and int32: ``points`` and ``data`` default to the grid's own, widened
    (a grid built from float64 arrays hands the oracle those)."""
    pts = host64(grid.points if points is None else points)
    d = host64(grid.point_data[:, 0] if data is None else data)
    return pts, host32i(grid.cells), host32i(grid.neighbors), d


def oracle_band(grid, pts64):
    """The tie band of a grid's answers against the oracle's.  The card
    takes a cell whose face margins, in the grid's own geometry, are at
    least -(eps_inside + cand_qeps) (the probe, ``locate._cand_eps``),
    or where a walk ends: its target lies within eps_arrive past the exit
    face, from a position a hop's nudge may have carried past a crossed
    face (``utils.config.walk_tolerances``: 64 and 16 eps(dtype) extent,
    7.6e-6 and 1.9e-6 on the unit box in float32).  The grid's vertices
    lie within ``rounding`` of the float64 points the oracle is given,
    which moves a face plane by about as much on each side, and its
    margins round within a few ulp of the extent.  So a cell either side
    picks holds the query, in the oracle's float64 geometry, within
    max(eps_inside + cand_qeps, eps_arrive + nudge) + 2 rounding + 8
    eps(dtype) extent (1e-10 on the float64 box)."""
    from interpolate_unstructured_tpu_torch.utils.config import (
        walk_tolerances,
    )

    nudge, eps_arrive = walk_tolerances(grid.dtype, grid.rmin, grid.rmax)
    rounding = float(np.abs(host64(grid.points) - pts64).max())
    extent = float(np.abs(pts64).max())
    eps = float(torch.finfo(grid.dtype).eps)
    return (max(grid.config.eps_inside + grid.cand_qeps, eps_arrive + nudge)
            + 2.0 * rounding + 8.0 * eps * max(extent, 1.0))


def tet_margins(pts, cells, c, q):
    """(n, 4) distances of the points ``q`` inside face k = (k, k+1,
    k+2) of the tets ``c`` (positive inside), float64 from ``pts``;
    face k's neighbor is ``neighbors[c, k]`` (the oracle's convention)."""
    v = pts[cells[c]]
    out = np.empty((len(c), 4))
    for k in range(4):
        a, b, d, o = (v[:, (k + j) % 4] for j in range(4))
        nrm = np.cross(b - a, d - a)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        side = np.sign(np.einsum("ij,ij->i", o - a, nrm))
        out[:, k] = side * np.einsum("ij,ij->i", q - a, nrm)
    return out


def oracle_verdict(label, mesh, s, orc, band, tol, found_exact):
    """Gates of the card's answers ``s`` against the oracle's ``orc`` on
    the same queries: found masks identical (``found_exact``), else where
    they differ the side that found a cell holds the query within
    ``band`` and within ``band`` of one of its boundary faces; cell ids
    identical except where both cells hold the query within ``band`` (a
    shared face or edge: the oracle walks from a centroid, the card
    probes candidates or walks from its own seeds); values within
    ``tol`` wherever both found a cell."""
    pts, cells, nbrs, _ = mesh
    vo, ico, fo = orc
    q, vc, icc, fc = s["r"], s["vals"], s["ic"], s["found"]
    fd = np.nonzero(fc != fo)[0]
    if found_exact:
        check(fd.size == 0, f"oracle, {label}: {fd.size} found masks differ")
    elif fd.size:
        c = np.where(fc[fd], icc[fd], ico[fd])
        m = tet_margins(pts, cells, c, q[fd])
        wall = np.where(nbrs[c] < 0, m, np.inf).min(1)
        tie = (m.min(1) >= -band) & (wall <= band)
        check(bool(tie.all()), f"oracle, {label}: {int((~tie).sum())} of "
              f"{fd.size} found-mask differences are not within {band:.3e} "
              f"of the domain's boundary")
    both = fc & fo
    di = np.nonzero(both & (icc != ico))[0]
    worst = 0.0
    if di.size:
        mc = tet_margins(pts, cells, icc[di], q[di]).min(1)
        mo = tet_margins(pts, cells, ico[di], q[di]).min(1)
        worst = float(-np.minimum(mc, mo).min())
        check(worst <= band, f"oracle, {label}: of {di.size} queries whose "
              f"cells differ, one lies {worst:.3e} outside a cell (tie band "
              f"{band:.3e})")
    err = float(np.abs(vc[both] - vo[both]).max()) if both.any() else 0.0
    check(err <= tol, f"oracle, {label}: values differ by {err:.3e} > {tol}")
    print(f"oracle, {label}: {len(q)} queries, {int(fc.sum())} found by the "
          f"card, found masks {'identical' if not fd.size else f'differ on {fd.size} (each within the tie band of the boundary)'}; "
          f"cells differ on {di.size} (both hold the query, worst "
          f"{max(worst, 0.0):.3e} outside, tie band {band:.3e}); max |value "
          f"- oracle| {err:.3e} (gate {tol})")
    return dict(n=len(q), found_differ=int(fd.size), ids_differ=int(di.size),
                err=err, band=band)


def first_cells(cells, n_points):
    """The first cell incident to each point, the oracle's seed map."""
    first = np.full(n_points, np.iinfo(np.int32).max, np.int64)
    np.minimum.at(first, cells.reshape(-1),
                  np.repeat(np.arange(len(cells)), cells.shape[1]))
    return first.astype(np.int32)


def oracle_trace_verdict(label, card, orc, curve_tol, final_tol, min_agree):
    """The rules of ``tests/test_torch_trace.py``'s ``_compare_traces``,
    line by line: identical boundary codes, step counts within
    ORACLE_STEPS, curves (points and field samples) within ``curve_tol``
    up to two points before the shorter end, final states within
    ``final_tol``; at least ``min_agree`` of the lines must pass."""
    y, yf, ns, bm = card
    oy, oyf, ons, obm = orc
    max_steps = y.shape[1]
    n = y.shape[0]
    ok = (bm == obm) & (np.abs(ns.astype(int) - ons.astype(int))
                        <= ORACLE_STEPS)
    curve = np.zeros(n)
    final = np.zeros(n)
    for t in range(n):
        nt, no = min(int(ns[t]), max_steps), min(int(ons[t]), max_steps)
        common = max(min(nt, no) - 2, 0)
        curve[t] = max(np.abs(y[t, :common] - oy[t, :common]).max(initial=0),
                       np.abs(yf[t, :common] - oyf[t, :common]).max(initial=0))
        final[t] = np.abs(y[t, max(nt, 1) - 1] - oy[t, max(no, 1) - 1]).max()
    ok &= (curve <= curve_tol) & (final <= final_tol)
    n_ok = int(ok.sum())
    for t in np.nonzero(~ok)[0][:5]:
        print(f"  {label}, line {t}: card n_steps {int(ns[t])} code "
              f"{int(bm[t])}, oracle {int(ons[t])} code {int(obm[t])}; "
              f"curve {curve[t]:.3e}, final {final[t]:.3e}")
    check(n_ok >= min_agree * n, f"oracle, {label}: {n - n_ok} of {n} lines "
          f"fail the trace rules")
    same = int((ns == ons).sum())
    print(f"oracle, {label}: {n_ok} of {n} lines pass (codes identical, "
          f"step counts within {ORACLE_STEPS}, curves within {curve_tol} up "
          f"to two points before the shorter end, final states within "
          f"{final_tol}); max curve difference {curve[ok].max(initial=0):.3e}, "
          f"max final-state difference {final[ok].max(initial=0):.3e}; step "
          f"counts identical on {same} lines, the others differ by at most "
          f"{int(np.abs(ns.astype(int) - ons.astype(int)).max())}")
    return dict(n=n, ok=n_ok, same_steps=same,
                curve=float(curve[ok].max(initial=0)),
                final=float(final[ok].max(initial=0)))


def cpu_model() -> str:
    """The first CPU's model name in /proc/cpuinfo, with its vendor,
    family, model and stepping numbers, and the number of CPUs."""
    import os

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    ids = ", ".join(f"{k} {info[k]}" for k in (
        "vendor_id", "cpu family", "model", "stepping") if k in info)
    return (f"{info.get('model name', 'unknown')} ({ids}; "
            f"{os.cpu_count()} CPUs)")


def oracle_phase(card, cand, walk, trace, f64):
    """The card's answers, gathered by the earlier phases, against the
    serial oracle on this machine's CPU: the float64 box's cold queries
    (the oracle's own brute-force 1-NN seeds) and warm ones (the card's
    guesses), the float32 candidate box's cold queries (seeded as the
    oracle seeds, by a kd-tree 1-NN and its first-incident-cell map) and
    the walk grid's warm and off-domain ones (the card's guesses), the
    float64 generic trace and the fused float32 trace of the helix.
    No fallback: a failed build or gate raises."""
    from scipy.spatial import cKDTree

    from interpolate_unstructured_tpu_torch.utils import serial_oracle

    t0 = time.perf_counter()
    lib = serial_oracle.build()  # raises with g++'s output
    check(serial_oracle.available(), "the serial oracle does not load")
    build_s = time.perf_counter() - t0
    cpu = cpu_model()
    print(f"oracle: {lib.name} built and loaded in {build_s:.3f} s "
          f"(g++ {' '.join(serial_oracle.CXX_FLAGS)}); CPU {cpu}")
    res = {}

    def query(label, mesh, s, tol, found_exact, guesses):
        pts, cells, nbrs, data = mesh
        t1 = time.perf_counter()
        serial_oracle.serial_query(pts, cells, nbrs, data, s["r"][:0])
        setup_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        orc = serial_oracle.serial_query(pts, cells, nbrs, data, s["r"],
                                         guesses=guesses)
        call_s = time.perf_counter() - t1
        out = oracle_verdict(label, mesh, s, orc, s["band"], tol, found_exact)
        out.update(call_s=call_s, setup_s=setup_s,
                   qps=len(s["r"]) / max(call_s - setup_s, 1e-9))
        return out

    m64 = f64["mesh"]
    res["f64_cold"] = query("float64 box, cold (the oracle's brute-force "
                            "1-NN seeds)", m64, f64["cold"], LIN_TOL_F64,
                            True, guesses=None)
    res["f64_warm"] = query("float64 walk grid, warm (the card's guesses), "
                            "the last 1M of 10.1M", m64, f64["warm"],
                            LIN_TOL_F64, True, f64["warm"]["guess"])
    mc = cand["mesh"]
    t1 = time.perf_counter()
    nn = cKDTree(mc[0]).query(cand["cold"]["r"])[1]
    seeds = first_cells(mc[1], len(mc[0]))[nn]
    seed_s = time.perf_counter() - t1
    res["f32_cand"] = query("float32 candidate box, cold, the first 1M "
                            "(1-NN seeds by kd-tree)", mc, cand["cold"],
                            LIN_TOL, False, guesses=seeds)
    res["f32_walk"] = query("float32 walk grid, 900,000 warm + 100,000 "
                            "off-domain (the card's guesses)", walk["mesh"],
                            walk["warm"], LIN_TOL_ICELL, False,
                            walk["warm"]["guess"])

    def traced(label, mesh, tr, curve_tol, min_agree):
        pts, cells, nbrs, data = mesh
        t1 = time.perf_counter()
        serial_oracle.serial_query(pts, cells, nbrs, data, tr["y0"][:0])
        setup_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        orc = serial_oracle.serial_trace(pts, cells, nbrs, tr["field"],
                                         tr["y0"], **TRACE_KW)
        call_s = time.perf_counter() - t1
        out = oracle_trace_verdict(label, tr["out"], orc, curve_tol,
                                   2.0 * TRACE_KW["min_dx"], min_agree)
        steps = int(np.minimum(orc[2], TRACE_KW["max_steps"]).sum())
        out.update(call_s=call_s, setup_s=setup_s, steps=steps,
                   sps=steps / max(call_s - setup_s, 1e-9))
        return out

    res["f64_trace"] = traced("float64 generic trace, 1024 helix lines",
                              m64, f64["trace"], ORACLE_TRACE_TOL, 1.0)
    res["f32_trace"] = traced("fused float32 trace (B4), 1024 helix lines",
                              walk["mesh"], trace, TRACE_TOL,
                              1.0 - TRACE_DIFFER)
    fc, fw, ft = res["f64_cold"], res["f64_warm"], res["f64_trace"]
    rates = f64["rates"]
    print(f"oracle speed on one CPU core ({cpu}), beside the card [{card}]: "
          f"cold {fc['qps']:.4e} queries/s ({ORACLE_COLD_N} queries in "
          f"{fc['call_s']:.3f} s, of which {fc['setup_s']:.3f} s is the mesh "
          f"set-up, timed by a call with no query) against the card's "
          f"{rates['cold_qps']:.4e} (float64 box, 10M cold), "
          f"{rates['cold_qps'] / fc['qps']:.4e}x; warm {fw['qps']:.4e} "
          f"queries/s ({fw['n']} in {fw['call_s']:.3f} s, set-up "
          f"{fw['setup_s']:.3f} s) against {rates['warm_qps']:.4e} (float64 "
          f"walk grid, 10.1M warm), {rates['warm_qps'] / fw['qps']:.4e}x; "
          f"trace {ft['sps']:.4e} steps/s ({ft['steps']} steps in "
          f"{ft['call_s']:.3f} s, set-up {ft['setup_s']:.3f} s; the 1024 "
          f"start cells by brute-force 1-NN included) against "
          f"{rates['trace_sps']:.4e} (float64 generic trace, 1024 lines), "
          f"{rates['trace_sps'] / ft['sps']:.4e}x; float32 on the card: "
          f"candidate cold {cand['rate']:.4e}, walk-grid warm "
          f"{walk['rate']:.4e} queries/s, fused trace {trace['rate']:.4e} "
          f"steps/s; kd-tree seeds for 1M queries {seed_s:.3f} s")
    res["build_s"] = build_s
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.ops import (
        _kernels,
        acc_kernel,
        cand_build_kernel,
        cand_kernel,
        icell_kernel,
        interp_kernel,
        locate,
        trace_kernel,
        walk_kernel,
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

    args = (dev, tiu, meshgen, interp_kernel, locate, cand_kernel,
            walk_kernel)
    phase_s = {}

    def timed_phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = round(time.perf_counter() - t0, 3)
        return out

    acc_counters = (interp_kernel, cand_kernel, walk_kernel, acc_kernel,
                    icell_kernel)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as tmp:
        b1 = timed_phase("bruteforce", bruteforce_phase, *args)
        b2 = timed_phase("candidate", candidate_phase, *args)
        bd = timed_phase("builder", builder_phase, dev, tiu, meshgen,
                         (interp_kernel, cand_kernel, walk_kernel,
                          cand_build_kernel), card)
        io = timed_phase("io", io_phase, dev, tiu, meshgen, b2["grid"], b2,
                         acc_counters, card, tmp)
        timed_phase("sharded", sharded_phase, dev, tiu, meshgen, b2["grid"],
                    io["walk_grid"], acc_counters + (trace_kernel,), card, tmp)
        b5 = timed_phase("accurate", accurate_phase, dev, tiu, b2.pop("grid"),
                         b1.pop("acc_inputs"), acc_counters, cand_kernel,
                         acc_kernel, walk_kernel, locate)
        b3 = timed_phase("walk", walk_phase, *args, io)
        b4 = timed_phase("trace", trace_phase, dev, tiu, b3.pop("grid"),
                         (interp_kernel, cand_kernel, walk_kernel,
                          trace_kernel, icell_kernel),
                         walk_kernel, trace_kernel, tmp, card)
    f64 = timed_phase("float64", float64_phase, *args, trace_kernel, card)
    timed_phase("oracle", oracle_phase, card, b2.pop("oracle"),
                b3.pop("oracle"), b4.pop("oracle"), f64.pop("oracle"))
    print("phase seconds: " + json.dumps(phase_s) + f" [{card}]")
    ck = cand_kernel.__name__
    io_n = io["counts"]
    print("io phase launches on its main paths (B1 on the grids read from "
          "files, the loaded checkpoint's cold and accurate queries): "
          + json.dumps({k: v for k, v in io_n.items() if v}))
    gc_launches = {**b3["gc_launches"], "candidate_warm": b2["gc_launches"],
                   "accurate_warm": b5["gc_launches"],
                   "trace_start_cells": b4["gc_launches"],
                   "io_checkpoint": io_n[f"{walk_kernel.__name__}:get_cell"]}
    print("B3 get_cell walk launches on the main path: "
          + json.dumps(gc_launches))
    binned = {x: b2["binned"][x] + b5["binned"][x] + io_n[f"{ck}:{x}"]
              for x in b2["binned"]}
    df_pass = b5["df_pass_launches"] + io["df_pass"]
    df_probe = b5["df_launches"] + io_n[f"{ck}:df"]
    ext_n = b2["ext_launches"] + b5["ext_launches"] + io_n[f"{ck}:ext"]
    b5_launches = b5["acc_launches"] + io_n[acc_kernel.__name__]
    d_launches = {x: b2["builder_launches"][x] + bd["launches"][x]
                  + io["builder_launches"][x] for x in BUILDER_KERNELS}
    print("device candidate builder launches on the main path (the 998k "
          "box's build_grid, the containment box's, the heavy-bin soup's, "
          "the io phase's rebuild): " + json.dumps(d_launches))
    e1_launches = {**b3["e1_launches"], "candidate_warm": b2["e1_launches"],
                   "trace_start_field": b4["e1_launches"],
                   "io": io_n[icell_kernel.__name__]}
    print("B2 bin-ordered launches on the main path: " + json.dumps(binned)
          + f"; B2-df: float64 bin pass {df_pass}, df probe "
          f"{df_probe}; B2 with extension rows "
          f"{ext_n}; B3 walk_rows "
          f"{b4['walk_launches']} (the generic trace); B4 {b4['launches']}; "
          f"B5 {b5_launches}; E1 {json.dumps(e1_launches)}")

    pkg = "interpolate_unstructured_tpu_torch"
    kernels = [
        *({"name": f"B1 interp_bruteforce, {row['label']}", "route": "cuda",
           "source": f"{pkg}/csrc/interp_bruteforce.cu",
           "replaces": "interpolate_unstructured_tpu/ops/pallas_interp.py:93",
           "launches": row["launches"] + io["b1"][row["label"]],
           "max_abs_err": row["max_abs_err"],
           "ms": row["ms"], "plain_ms": row["plain_ms"],
           "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
           "library_ms": None}
          for row in b1["rows"]),
        {"name": "B2 probe in bin order with extension rows",
         "route": "cuda", "source": f"{pkg}/csrc/cand_rows.cu",
         "replaces": "interpolate_unstructured_tpu/ops/pallas_cand.py:64",
         "launches": ext_n, "max_abs_err": b2["ext"]["max_abs_err"],
         "ms": b2["ext"]["ms"], "plain_ms": b2["ext"]["plain_ms"],
         "bound_ms": b2["ext"]["bound"][0],
         "bound_by": b2["ext"]["bound"][1], "library_ms": None},
        *({"name": f"B2 {label}", "route": "cuda",
           "source": f"{pkg}/csrc/cand_rows.cu",
           "replaces": "interpolate_unstructured_tpu/ops/pallas_cand.py:64",
           "launches": binned[key], "max_abs_err": b2[err],
           "ms": b2[part]["ms"], "plain_ms": b2[part]["plain_ms"],
           "bound_ms": b2[part]["bound"][0],
           "bound_by": b2[part]["bound"][1],
           "library_ms": b2[part].get("library_ms")}
          for label, key, part, err in (
              ("bin pass", "bin_pass", "bin_pass", "pass_err"),
              ("bin scatter", "bin_scatter", "bin_scatter", "scatter_err"),
              ("probe in bin order", "binned", "probe", "binned_err"),
              ("unsort", "bin_unsort", "bin_unsort", "unsort_err"))),
        {"name": "B3 walk_rows", "route": "cuda",
         "source": f"{pkg}/csrc/walk.cu",
         "replaces": "interpolate_unstructured_tpu/ops/pallas_walk.py:84",
         "launches": b4["walk_launches"], "max_abs_err": b3["max_abs_err"],
         "ms": b3["ms"], "plain_ms": b3["plain_ms"],
         "bound_ms": b3["bound"][0], "bound_by": b3["bound"][1],
         "library_ms": None},
        {"name": "B3 get_cell walk", "route": "cuda",
         "source": f"{pkg}/csrc/walk.cu",
         "replaces": "interpolate_unstructured_tpu/ops/pallas_walk.py:84",
         "launches": sum(gc_launches.values()),
         "max_abs_err": b3["gc"]["max_abs_err"],
         "ms": b3["gc"]["ms"], "plain_ms": b3["gc"]["plain_ms"],
         "bound_ms": b3["gc"]["bound"][0], "bound_by": b3["gc"]["bound"][1],
         "library_ms": None},
        {"name": "B4 trace loop", "route": "cuda",
         "source": f"{pkg}/csrc/trace.cu",
         "replaces": "interpolate_unstructured_tpu/ops/pallas_trace.py:103",
         "launches": b4["launches"], "max_abs_err": b4["max_abs_err"],
         "ms": b4["ms"], "plain_ms": b4["plain_ms"],
         "bound_ms": b4["bound"][0], "bound_by": b4["bound"][1],
         "library_ms": None},
        {"name": "B2-df bin pass, float64 queries", "route": "cuda",
         "source": f"{pkg}/csrc/cand_rows.cu",
         "replaces": "interpolate_unstructured_tpu/ops/pallas_cand.py:64",
         "launches": df_pass, "max_abs_err": b5["pass_err"],
         "ms": b5["df_pass"]["ms"], "plain_ms": b5["df_pass"]["plain_ms"],
         "bound_ms": b5["df_pass"]["bound"][0],
         "bound_by": b5["df_pass"]["bound"][1], "library_ms": None},
        {"name": "B2-df probe in bin order", "route": "cuda",
         "source": f"{pkg}/csrc/cand_rows.cu",
         "replaces": "interpolate_unstructured_tpu/ops/pallas_cand.py:64",
         "launches": df_probe, "max_abs_err": b5["df"]["max_abs_err"],
         "ms": b5["df"]["ms"], "plain_ms": b5["df"]["plain_ms"],
         "bound_ms": b5["df"]["bound"][0], "bound_by": b5["df"]["bound"][1],
         "library_ms": None},
        {"name": "B5 interp_acc", "route": "cuda",
         "source": f"{pkg}/csrc/interp_acc.cu",
         "replaces": "interpolate_unstructured_tpu/ops/pallas_acc.py:40",
         "launches": b5_launches, "max_abs_err": b5["b5"]["max_abs_err"],
         "ms": b5["b5"]["ms"], "plain_ms": b5["b5"]["plain_ms"],
         "bound_ms": b5["b5"]["bound"][0], "bound_by": b5["b5"]["bound"][1],
         "library_ms": None},
    ]
    cb = b2["builder"]
    e1 = b3["e1"]
    kernels.append({
        "name": "E1 interp_icell (no Pallas counterpart: XLA "
                "ops/interp.py:177)", "route": "cuda",
        "source": f"{pkg}/csrc/interp_icell.cu",
        "replaces": "interpolate_unstructured_tpu/ops/interp.py:177",
        "launches": sum(e1_launches.values()),
        "max_abs_err": e1["max_abs_err"], "ms": e1["ms"],
        "plain_ms": e1["plain_ms"], "bound_ms": e1["bound"][0],
        "bound_by": e1["bound"][1], "library_ms": None})
    for name, key, line in (
            ("D1 cand_bin count pass (no Pallas counterpart: XLA "
             "_gen_pairs)", "count", 56),
            ("D1 cand_bin write pass (no Pallas counterpart: XLA "
             "_gen_pairs, lax.sort)", "write", 56),
            ("D2 cand_order (no Pallas counterpart: XLA lax.sort, "
             "_fill_tables)", "order", 135)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{pkg}/csrc/cand_build.cu",
            "replaces": f"interpolate_unstructured_tpu/ops/cand_build.py:{line}",
            "launches": d_launches[key], "max_abs_err": 0.0,
            "ms": cb[key]["ms"], "plain_ms": cb[key]["plain_ms"],
            "bound_ms": cb[key]["bound"][0],
            "bound_by": cb[key]["bound"][1], "library_ms": None})
    f64_cold, f64_warm = f64["cold"], f64["warm"]
    f64_gc = {**f64_warm["gc_launches"],
              "trace_start_cells": f64["trace"]["gc_launches"]}
    f64_binned = dict(f64_cold["binned"])
    f64_e1 = {"box_cold": f64_cold["e1_launches"],
              **{f"walk_grid_{k}": v
                 for k, v in f64_warm["e1_launches"].items()},
              "trace_start_field": f64["trace"]["e1_launches"]}
    print("float64 phase launches on its main paths: B1 "
          + json.dumps({row["label"]: row["launches"] for row in f64["bf"]})
          + f"; B2 bin-ordered {json.dumps(f64_binned)} (ext: with the "
          f"extension rows); B3 get_cell walk {json.dumps(f64_gc)}, "
          f"walk_rows {f64['trace']['walk_launches']} (the generic trace); "
          f"E1 {json.dumps(f64_e1)}; "
          f"D1/D2 {json.dumps(f64_cold['d_launches'])}")
    kernels += [
        {"name": f"B1 interp_bruteforce float64, {row['label']}",
         "route": "cuda", "source": f"{pkg}/csrc/interp_bruteforce.cu",
         "replaces": "interpolate_unstructured_tpu/ops/pallas_interp.py:93",
         "launches": row["launches"], "max_abs_err": 0.0, "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
         "bound_by": row["bound"][1], "library_ms": None}
        for row in f64["bf"]]
    for label, part, launches, err in (
            ("bin pass", "bin_pass", f64_binned["bin_pass"], "pass_err"),
            ("bin scatter", "bin_scatter", f64_binned["bin_scatter"],
             "scatter_err"),
            ("probe in bin order with extension rows", "probe",
             f64_binned["ext"], "ext"),
            ("unsort", "bin_unsort", f64_binned["bin_unsort"], "unsort_err")):
        st = f64_cold["stages"][part]
        kernels.append({
            "name": f"B2 float64 {label}", "route": "cuda",
            "source": f"{pkg}/csrc/cand_rows.cu",
            "replaces": "interpolate_unstructured_tpu/ops/pallas_cand.py:64",
            "launches": launches,
            "max_abs_err": (f64_cold["ext"]["max_abs_err"] if err == "ext"
                            else f64_cold[err]),
            "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound"][0], "bound_by": st["bound"][1],
            "library_ms": st["library_ms"]})
    for label, part, launches, err in (
            ("get_cell walk", "gc", sum(f64_gc.values()),
             f64_warm["gc"]["max_abs_err"]),
            ("walk_rows", "walk", f64["trace"]["walk_launches"],
             f64_warm["walk_err"])):
        st = f64_warm[part]
        kernels.append({
            "name": f"B3 float64 {label}", "route": "cuda",
            "source": f"{pkg}/csrc/walk.cu",
            "replaces": "interpolate_unstructured_tpu/ops/pallas_walk.py:84",
            "launches": launches, "max_abs_err": err, "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound"][0],
            "bound_by": st["bound"][1], "library_ms": None})
    e1 = f64_cold["e1"]
    kernels.append({
        "name": "E1 interp_icell float64", "route": "cuda",
        "source": f"{pkg}/csrc/interp_icell.cu",
        "replaces": "interpolate_unstructured_tpu/ops/interp.py:177",
        "launches": sum(f64_e1.values()), "max_abs_err": e1["max_abs_err"],
        "ms": e1["ms"], "plain_ms": e1["plain_ms"],
        "bound_ms": e1["bound"][0], "bound_by": e1["bound"][1],
        "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
