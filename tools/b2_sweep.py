#!/usr/bin/env python3
"""Sweeps of B2's bin order and probe on one GPU, on the 998,250-tet box
of ``chip_smoke.py``'s candidate phase (float32 quantized rows, one
fused variable), and lanes a query of the df-plane probe (B2-df) on the
same box prepared for accurate mode.

    python3 tools/b2_sweep.py [--quick]

Builds the port's library and, beside it, ``tools/cand_order_alternatives.cu``
into ``build/kernels/libcand_order_sweep.so``.  Queries: the candidate
phase's 10M cold queries (``default_rng(2)``) and their first 65,536
and 1M, and a clustered 10M batch (normal about the box's center, sd
0.08, clipped into it; ``default_rng(4)``).  Every design is first held
torch.equal to ``probe_rows_plain``, then timed with CUDA events in
turns (old, new, new, old; or each setting in order, then in reverse):

1. the whole chain (order, probe, unsort) against the first design's
   (bin pass, ``torch.cumsum``, scatter a query at a time, probe through
   the permutation, unsort a query at a time), at 65,536, 1M and 10M
   uniform queries and the clustered 10M;
2. each stage of the chain alone beside its bound (bytes at 3.35 TB/s:
   the key pass reads the queries and writes key, rank and position;
   the scatter reads them and writes records and slots; the probe reads
   records and the distinct rows and writes results; the unsort reads
   slots, positions and results and writes the outputs), and the
   chain's split buckets;
3. the sizing: the chunk (``cand_kernel.MAX_CHUNK``), the span (through
   ``BUCKET_FILL``) and the tile (``TILES``), one at a time from the
   rule's choice, at 10M and 65,536 uniform queries and the clustered
   10M;
4. the fused probe (sort in shared memory and probe in one launch)
   against the separate sort (a kernel that writes each chunk in bin
   order, then a probe of the sorted records), at 10M and 65,536; and
   the whole chain with wider chunks (1024 threads and chunks of 8192,
   or 512 and 6144, each on keys of twice the rule's bins at 10M) against
   the rule's;
5. lanes a query of the probe, 1 to 32, at 1M, 2M, 4M and 10M queries
   (0.5 to 5 queries a bin) -- the measurement behind
   ``ops/cand_kernel.binned_lanes``; and of the df-plane probe at 1M and
   10M float64 queries (``default_rng(2)``).  ``--quick`` leaves 5 out.

Prints the card (nvidia-smi name and power limit) first; exits non-zero
without a CUDA device or when a check fails.
"""

from __future__ import annotations

import contextlib
import ctypes
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

UNIFORM = (65_536, 1_000_000, 10_000_000)  # chain against the first design
LANES = (1, 2, 4, 8, 16, 32)  # lanes a query of the probe
DENSITY = (1_000_000, 2_000_000, 4_000_000, 10_000_000)  # lanes sweep
DF_DENSITY = (1_000_000, 10_000_000)  # lanes sweep of the df-plane rows
CHUNKS = (1024, 2048, 4096)
FILLS = (0.375, 0.75, 1.5)
TILE_SETS = ((8192,), (4096,), (2048,))
REPS = 10
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def start_build():
    """Start nvcc on tools/cand_order_alternatives.cu; returns (process,
    library path)."""
    from interpolate_unstructured_tpu_torch.ops import _kernels

    src = Path(__file__).with_name("cand_order_alternatives.cu")
    out = _kernels.build_dir() / "libcand_order_sweep.so"
    _kernels.build_dir().mkdir(parents=True, exist_ok=True)
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def finish_build(proc, out):
    """Wait for nvcc and load the library."""
    text = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on cand_order_alternatives.cu:\n{text}")
    lib = ctypes.CDLL(str(out))
    sigs = {
        "alt_bin_pass": [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P],
        "alt_bin_scatter": [_P, _P, _P, _I, _P, _P, _P],
        "alt_rows_perm": [_P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I,
                          _I, _I, _F, _I, _F, _I, _P, _P, _P],
        "alt_bin_unsort": [_P, _P, _I, _I, _P, _P, _P, _P],
        "alt_chunk_sort": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I,
                           _I, _P, _P],
        "alt_rows_sorted": [_P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                            _I, _F, _I, _F, _I, _P, _P, _P],
    }
    for name in WIDE:
        sigs[name] = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I,
                      _I, _I, _I, _I, _I, _F, _I, _F, _I, _P, _P, _P]
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = _I, args
    return lib


@contextlib.contextmanager
def patched(mod, **values):
    """The module constants ``values`` set inside the block."""
    old = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def first_design(lib, grid, r, lay, eps, k):
    """The first design's chain on ``r``: (id, aux, values)."""
    from interpolate_unstructured_tpu_torch.ops import _kernels, cand_kernel

    b = r.shape[0]
    dev = r.device
    n_bins = grid.cand_table.shape[0]
    n_vars = len(lay.var_roles)
    stream = torch.cuda.current_stream().cuda_stream
    counts = torch.zeros(n_bins, dtype=torch.int32, device=dev)
    idx, rank, perm, slot = (torch.empty(b, dtype=torch.int32, device=dev)
                             for _ in range(4))
    bins = (grid.cand_rmin.data_ptr(), grid.cand_inv_h.data_ptr(),
            *grid.cand_shape)
    _kernels.check(lib.alt_bin_pass(r.data_ptr(), b, *bins,
                                    counts.data_ptr(), idx.data_ptr(),
                                    rank.data_ptr(), stream), "alt_bin_pass")
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    _kernels.check(lib.alt_bin_scatter(idx.data_ptr(), rank.data_ptr(),
                                       ends.data_ptr(), b, perm.data_ptr(),
                                       slot.data_ptr(), stream),
                   "alt_bin_scatter")
    rec = torch.empty((b, 2 + n_vars), dtype=torch.int32, device=dev)
    vroles = cand_kernel._var_roles(lay.var_roles, dev)
    _kernels.check(lib.alt_rows_perm(
        grid.cand_table.data_ptr(), grid.cand_table.shape[1], r.data_ptr(),
        perm.data_ptr(), b, cand_kernel.binned_lanes(b, n_bins), *bins,
        lay.k, lay.id_role, lay.count_col, float(eps), int(k),
        cand_kernel.QINV, n_vars, vroles.data_ptr(), rec.data_ptr(), stream),
        "alt_rows_perm")
    out = (torch.empty(b, dtype=torch.int32, device=dev),
           torch.empty(b, dtype=torch.int32, device=dev),
           torch.empty((b, n_vars), dtype=torch.float32, device=dev))
    _kernels.check(lib.alt_bin_unsort(rec.data_ptr(), slot.data_ptr(), b,
                                      n_vars, *(t.data_ptr() for t in out),
                                      stream), "alt_bin_unsort")
    return out


def separate_sort(lib, chain):
    """The separate sort's probe on the order of ``chain`` (a
    ``chip_smoke.B2Chain``): (id, aux, values)."""
    from interpolate_unstructured_tpu_torch.ops import _kernels

    o, sz, lay = chain.order, chain.sz, chain.lay
    b = chain.r.shape[0]
    sorted_ = torch.empty((b, 4), dtype=torch.int32, device=chain.r.device)
    rmin, inv_h, shape = chain.bins
    bins = (rmin.data_ptr(), inv_h.data_ptr(), *shape)
    _kernels.check(lib.alt_chunk_sort(
        o.rec.data_ptr(), o.starts.data_ptr(), o.counts.data_ptr(),
        o.chunk_end.data_ptr(), sz.n_keys, sz.span_shift, sz.chunk,
        sz.max_chunks, *bins, sorted_.data_ptr(), chain.stream),
        "alt_chunk_sort")
    _kernels.check(lib.alt_rows_sorted(
        chain.table.data_ptr(), chain.table.shape[1], sorted_.data_ptr(),
        b, chain.lanes, *bins, lay.k, lay.id_role, lay.count_col,
        float(chain.eps), int(chain.ovf_base), chain.ck.QINV,
        len(lay.var_roles),
        chain.vroles.data_ptr(), chain.res.data_ptr(), chain.stream),
        "alt_rows_sorted")
    chain.unsort()
    return chain.values()


def wide_probe(lib, chain, entry):
    """A wider chunk's probe (``entry``: ``alt_rows_chunked_wide``, 1024
    threads and chunks of up to 8192, or ``alt_rows_chunked_6k``, 512 and
    6144) on the order of ``chain`` (a ``chip_smoke.B2Chain`` made with a
    sizing of such chunks), into the chain's results."""
    from interpolate_unstructured_tpu_torch.ops import _kernels

    o, sz, lay = chain.order, chain.sz, chain.lay
    rmin, inv_h, shape = chain.bins
    _kernels.check(getattr(lib, entry)(
        chain.table.data_ptr(), chain.table.shape[1], o.rec.data_ptr(),
        o.starts.data_ptr(), o.counts.data_ptr(), o.chunk_end.data_ptr(),
        sz.n_keys, sz.span_shift, sz.chunk, sz.max_chunks, chain.lanes,
        rmin.data_ptr(), inv_h.data_ptr(), *shape, lay.k, lay.id_role,
        lay.count_col, float(chain.eps), int(chain.ovf_base), chain.ck.QINV,
        len(lay.var_roles), chain.vroles.data_ptr(), chain.res.data_ptr(),
        chain.stream), entry)


# the wider chunks' sizings: keys of twice the rule's bins at 5 a bin
WIDE = {"alt_rows_chunked_wide": {"MAX_CHUNK": 8192,
                                  "PROBE_SMEM": 200 * 1024},
        "alt_rows_chunked_6k": {"MAX_CHUNK": 6144, "BUCKET_FILL": 0.875}}


def main() -> int:
    if not torch.cuda.is_available():
        print("b2_sweep: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    quick = "--quick" in sys.argv[1:]
    import chip_smoke
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.models import cand_table
    from interpolate_unstructured_tpu_torch.ops import _kernels, cand_kernel
    from interpolate_unstructured_tpu_torch.utils import meshgen, timing

    print(f"card: {chip_smoke.card_line()}")
    proc, out = start_build()
    _kernels.build()
    lib = finish_build(proc, out)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    pts, cells, nbrs = meshgen.tet_box_mesh(55, 55, 55)
    grid = tiu.build_grid(
        pts, cells, nbrs, "tetra", point_data={"Polynomial": pts.sum(1) + 1.0},
        dtype=torch.float32, locate_mode="walk", device=dev)
    k = grid.cand_ids.shape[1]
    n_bins = int(np.prod(grid.cand_shape))
    row_bytes = 4 * grid.cand_table.shape[1]
    print(f"998,250-tet box with candidate tables in "
          f"{time.perf_counter() - t0:.3f} s: K={k}, {n_bins} bins, rows of "
          f"{row_bytes} bytes")
    r = torch.from_numpy(np.random.default_rng(2).random(
        (max(DENSITY), 3)).astype(np.float32)).to(dev)
    rc = torch.from_numpy(np.clip(np.random.default_rng(4).normal(
        0.5, 0.08, (10_000_000, 3)), 0.0, 0.999).astype(np.float32)).to(dev)
    lay = cand_table.layout(grid, k, (0,))
    eps = cand_table.probe_eps(grid)
    chunk = cand_table.probe_chunk(grid)
    bins = (grid.cand_rmin, grid.cand_inv_h, grid.cand_shape)
    batches = {f"{b} uniform": r[:b] for b in UNIFORM}
    batches["10000000 clustered"] = rc

    def new(rb):
        return cand_kernel.cand_rows_binned_query(grid.cand_table, rb, *bins,
                                                  lay, eps, k, chunk)

    def plain(rb):
        return cand_kernel.probe_rows_plain(
            grid.cand_table, *cand_table.probe_inputs(grid, rb), lay, eps, k,
            chunk)

    def held(name, got, want):
        for part, a, w in zip(("id", "aux", "values"), got, want):
            chip_smoke.check(torch.equal(a, w), f"{name}: {part} differs "
                             f"from probe_rows_plain")

    # 1-4 on each batch
    for label, rb in batches.items():
        b = rb.shape[0]
        want = plain(rb)
        held(f"{label}, the chain", new(rb), want)
        held(f"{label}, the first design",
             first_design(lib, grid, rb, lay, eps, k), want)
        t = chip_smoke.turns({
            "old": lambda: first_design(lib, grid, rb, lay, eps, k),
            "new": lambda: new(rb)}, REPS)
        idx = cand_table.probe_inputs(grid, rb)[0]
        distinct = int(torch.unique(idx).numel())
        del want
        chain = chip_smoke.B2Chain(grid.cand_table, rb, bins, lay, eps, k)
        sz = chain.sz
        with torch.profiler.profile():
            timing.metrics.reset()
            new(rb)
            torch.cuda.synchronize()
        split = timing.metrics.report()["counters"].get(
            "cand_order.split_buckets", 0.0)
        timing.metrics.reset()
        rw, ow = sz.rec_words * 4, sz.out_words * 4
        stage_bytes = {
            "key": b * (12 + 12), "scan": sz.n_keys * 12,
            "scatter": b * (12 + 12 + rw + 4),
            "probe": b * (rw + ow) + distinct * row_bytes,
            "unsort": b * (8 + 2 * ow)}
        st = {name: chip_smoke.cuda_ms(getattr(chain, name if name != "key"
                                               else "key_pass"), REPS)
              for name in ("key", "scan", "scatter", "probe", "unsort")}
        held(f"{label}, the stages alone", chain.values(), plain(rb))
        print(f"{label} ({b / n_bins:.2f} a bin, {distinct} distinct rows; "
              f"sizing {tuple(sz)}; {int(split)} split buckets): chain "
              f"torch.equal to probe_rows_plain, and the first design; in "
              f"turns, CUDA-event ms: first design {t['old'][0]:.4f} / "
              f"{t['old'][1]:.4f}, chain {t['new'][0]:.4f} / "
              f"{t['new'][1]:.4f}; stages alone (bound, bytes at 3.35 TB/s): "
              + ", ".join(f"{n} {st[n]:.4f} ({stage_bytes[n] / 3.35e9:.4f})"
                          for n in st))
        # the unsort's finished outputs against the torch.where calls
        # after the plain unsort (fill -7: NaN is never torch.equal)

        def wheres(rb=rb):
            i, a, v = new(rb)
            found = a == -2
            return (torch.where(found, i, -1), found,
                    torch.where(found[:, None], v, -7.0))

        def finished(rb=rb):
            return cand_kernel.cand_rows_found_query(
                grid.cand_table, rb, *bins, lay, eps, k, chunk, fill=-7.0)

        for part, a, w in zip(("cells", "found", "values"), finished(),
                              wheres()):
            chip_smoke.check(torch.equal(a, w), f"{label}: the finished "
                             f"{part} differ from the torch.where calls'")
        t = chip_smoke.turns({"wheres": wheres, "finished": finished}, REPS)
        print(f"{label}, the call's outputs in turns: unsort then "
              f"torch.where {t['wheres'][0]:.4f} / {t['wheres'][1]:.4f}, "
              f"the unsort's finished outputs {t['finished'][0]:.4f} / "
              f"{t['finished'][1]:.4f} ms")
        if label == "1000000 uniform":
            del chain
            continue
        # 3: the sizing, one factor at a time
        variants = {"rule": {}}
        for c in CHUNKS:
            if c != sz.chunk:
                variants[f"chunk {c}"] = {"MAX_CHUNK": c}
        for f in FILLS:
            if f != cand_kernel.BUCKET_FILL:
                variants[f"fill {f}"] = {"BUCKET_FILL": f}
        for ts in TILE_SETS:
            if ts[0] != sz.tile:
                variants[f"tile {ts[0]}"] = {"TILES": ts}
        fns = {}
        for name, values in variants.items():
            with patched(cand_kernel, **values):
                s = cand_kernel.order_sizing(b, n_bins, 3, sz.out_words)
                held(f"{label}, {name} {tuple(s)}", new(rb), plain(rb))

            def call(values=values):
                with patched(cand_kernel, **values):
                    return new(rb)

            fns[f"{name} {tuple(s)[:4]}"] = call
        t = chip_smoke.turns(fns, REPS)
        print(f"{label}, sizing (tile, span_shift, n_keys, chunk), whole "
              f"chain in order then in reverse: " + ", ".join(
                  f"{n}: {v[0]:.4f} / {v[1]:.4f}" for n, v in t.items()))
        # 4: fused against the separate sort
        held(f"{label}, separate sort", separate_sort(lib, chain), plain(rb))
        t = chip_smoke.turns({
            "separate": lambda: separate_sort(lib, chain),
            "fused": lambda: (chain.probe(), chain.unsort())}, REPS)
        print(f"{label}, probe and unsort in turns: separate sort "
              f"{t['separate'][0]:.4f} / {t['separate'][1]:.4f}, fused "
              f"{t['fused'][0]:.4f} / {t['fused'][1]:.4f} ms")
        # the wider chunks: the whole chain, order included, against the
        # rule
        for entry, values in WIDE.items():
            with patched(cand_kernel, **values):
                wide = chip_smoke.B2Chain(grid.cand_table, rb, bins, lay, eps,
                                          k)

            def wide_chain(entry=entry, values=values, wide=wide):
                with patched(cand_kernel, **values):
                    order = cand_kernel.bin_order_cuda(
                        rb, *bins, cand_kernel.out_words(lay,
                                                         grid.cand_table))
                wide.order = order
                wide_probe(lib, wide, entry)
                wide.unsort()
                return wide.values()

            held(f"{label}, {entry} {tuple(wide.sz)}", wide_chain(),
                 plain(rb))
            t = chip_smoke.turns({"rule": lambda: new(rb),
                                  "wide": wide_chain}, REPS)
            st = {"key": chip_smoke.cuda_ms(wide.key_pass, REPS),
                  "scatter": chip_smoke.cuda_ms(wide.scatter, REPS),
                  "probe": chip_smoke.cuda_ms(
                      lambda: wide_probe(lib, wide, entry), REPS),
                  "unsort": chip_smoke.cuda_ms(wide.unsort, REPS)}
            print(f"{label}, the whole chain in turns: rule "
                  f"{t['rule'][0]:.4f} / {t['rule'][1]:.4f}, {entry} "
                  f"{tuple(wide.sz)[:4]} {t['wide'][0]:.4f} / "
                  f"{t['wide'][1]:.4f} ms; its stages alone "
                  + ", ".join(f"{n} {v:.4f}" for n, v in st.items()))
            del wide
        del chain
    del rc, batches
    if quick:
        return 0

    # 5: lanes a query
    for b in DENSITY:
        rb = r[:b]
        order = cand_kernel.bin_order_cuda(
            rb, *bins, cand_kernel.out_words(lay, grid.cand_table))
        want = plain(rb)

        def probe(g):
            return cand_kernel.cand_rows_binned_cuda(
                grid.cand_table, order, *bins, lay, eps, k, lanes=g)

        for g in LANES:
            held(f"{b} queries, {g} lanes a query", probe(g), want)
        del want
        t = chip_smoke.turns({g: (lambda g=g: probe(g)) for g in LANES}, 10)
        print(f"B2 probe and unsort, {b} cold queries ({b / n_bins:.2f} a "
              f"bin; binned_lanes picks "
              f"{cand_kernel.binned_lanes(b, n_bins)}), torch.equal to "
              f"probe_rows_plain at every lane count; lanes a query (in "
              f"turns): " + ", ".join(f"{g}: {t[g][0]:.4f} / {t[g][1]:.4f} ms"
                                      for g in LANES))
        del rb, order
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
        order = cand_kernel.bin_order_cuda(
            rb, *bins, cand_kernel.out_words(lay, table), df=True)
        want = cand_kernel.cand_rows_df_plain(table, rb, None, *bins, lay,
                                              eps, k, chunk)

        def probe(g):
            return cand_kernel.cand_rows_binned_cuda(
                table, order, *bins, lay, eps, k, lanes=g)

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
        print(f"B2-df probe and unsort, {b} cold float64 queries "
              f"({b / n_bins:.2f} a bin; binned_lanes picks "
              f"{cand_kernel.binned_lanes(b, n_bins)}), torch.equal to "
              f"cand_rows_df_plain at every lane count; lanes a query (in "
              f"turns): " + ", ".join(f"{g}: {t[g][0]:.4f} / {t[g][1]:.4f} ms"
                                      for g in LANES))
        del rb, order
    return 0


if __name__ == "__main__":
    sys.exit(main())
