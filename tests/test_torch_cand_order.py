"""B2's bin order: coarse keys and tiles, then a chunk of a coarse bucket
put in bin order in shared memory (``ops/cand_kernel.py``,
``csrc/cand_rows.cu``).

On the CPU: the plain twin of the two-level order (``cand_order_plain``)
groups the queries by coarse key and, in each chunk of a bucket, by flat
bin in ascending order, and its inverse restores query order, on empty,
single, ragged, one-bin, over-a-chunk and off-grid batches; the sizing
rule; the order's plain checks (``order_mismatches``) catch a broken
order; the counters ``cand_order.queries`` and
``cand_order.split_buckets`` count only while tracing, and read nothing
back.  On the card: the key pass, scan and scatter against their plain
versions, and the chain's (id, aux, values) torch.equal to the plain
probes (``probe_rows_plain``, ``probe_rows_ext_plain``,
``cand_rows_df_plain``) on uniform and clustered batches, every row
kind, float64 grids, the df-plane rows from float64 queries and from a
hi/lo pair, extension rows, and a CUDA graph's capture and replay of
the chain.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models import cand_table
from interpolate_unstructured_tpu_torch.ops import cand_kernel
from interpolate_unstructured_tpu_torch.utils import meshgen, timing

HOST = tiu.IUConfig(cand_build="host")


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests: on
    some virtualized hosts a worker thread's first float32 torch.sqrt in
    a process is off by ~1e-4 relative, and the plain probes of triangles
    and quads call it."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


@pytest.fixture(autouse=True)
def _empty_registry():
    timing.metrics.reset()
    yield
    timing.metrics.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _box(device="cpu", n=6, dtype=torch.float32, cfg=HOST):
    pts, cells, nbrs = meshgen.tet_box_mesh(n, n, n)
    return pts, tiu.build_grid(pts, cells, nbrs, "tetra", dtype=dtype,
                               locate_mode="walk", config=cfg,
                               point_data={"a": pts.sum(1) + 1.0},
                               device=device)


def _batches(grid, device="cpu"):
    """Queries on the grid's bins: empty, one, a ragged uniform batch (not a
    multiple of any tile), every query in one bin, one coarse bucket over
    a chunk (queries spread over the bins of the first key), and
    queries outside the bin grid."""
    rng = np.random.default_rng(7)
    lo = grid.cand_rmin.cpu().double().numpy()
    hi = lo + np.array(grid.cand_shape) / grid.cand_inv_h.cpu().double(
        ).numpy()
    span = hi - lo
    uniform = lo + rng.random((5003, 3)) * span
    one_bin = np.repeat(uniform[:1], 9000, axis=0)
    first_key = lo + rng.random((9000, 3)) * span * np.array([0.05, 0.05,
                                                              1.0])
    outside = lo - 0.5 * span + rng.random((3000, 3)) * 2.0 * span
    out = {"empty": uniform[:0], "one": uniform[:1], "ragged": uniform,
           "one_bin": one_bin, "bucket_over_chunk": first_key,
           "outside": outside}
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in out.items()}


def _flat(grid, r):
    return cand_table.probe_inputs(grid, r)[0]


@pytest.mark.parametrize("batch", ["empty", "one", "ragged", "one_bin",
                                   "bucket_over_chunk", "outside"])
def test_plain_twin_groups_by_bin_and_goes_back(batch):
    """The plain twin's permutation takes the coarse keys in ascending
    order, cuts each bucket into chunks of at most ``chunk`` queries,
    puts each chunk in ascending flat-bin order, and its inverse puts the
    queries back in query order."""
    _, g = _box()
    r = _batches(g)[batch]
    idx = _flat(g, r).long()
    b = r.shape[0]
    n_bins = int(np.prod(g.cand_shape))
    sz = cand_kernel.order_sizing(b, n_bins, 3, 3)
    if batch in ("one_bin", "bucket_over_chunk"):  # a bucket over a chunk
        sz = sz._replace(chunk=1024)
    perm, chunk = cand_kernel.cand_order_plain(idx, sz)
    assert torch.equal(torch.sort(perm).values, torch.arange(b))
    slot = torch.empty_like(perm)
    slot[perm] = torch.arange(b)
    assert torch.equal(r[perm][slot], r)
    grouped = idx[perm]
    key = grouped >> sz.span_shift
    assert bool((key[1:] >= key[:-1]).all())
    assert bool((chunk[1:] >= chunk[:-1]).all())
    same = chunk[1:] == chunk[:-1]
    assert bool((grouped[1:][same] >= grouped[:-1][same]).all())
    # a chunk lies in one bucket and holds at most `chunk` queries
    assert bool((key[1:][same] == key[:-1][same]).all())
    counts = torch.bincount(chunk, minlength=1) if b else chunk
    assert b == 0 or int(counts.max()) <= sz.chunk
    _, _, chunk_end = cand_kernel.order_scan_plain(idx, sz)
    assert int(chunk_end[-1]) == (int(chunk[-1]) + 1 if b else 0)
    assert int(chunk_end[-1]) <= max(sz.max_chunks, 0) or sz.chunk == 1024
    if batch in ("one_bin", "bucket_over_chunk"):
        assert int(chunk_end[-1]) == -(-b // 1024)


@pytest.mark.parametrize("b,n_bins", [(0, 1), (1, 1), (5003, 1728),
                                      (65_536, 124 ** 3),
                                      (10_000_000, 124 ** 3),
                                      (10_000_000, 8192 * 4096)])
@pytest.mark.parametrize("words", [(3, 2), (3, 3), (6, 4), (6, 8), (3, 40)])
def test_sizing_rule(b, n_bins, words):
    """The sizing: tiles the kernels take, whose staged records fit; chunks
    whose records and results fit the probe's shared memory; at most
    MAX_KEYS keys of at most MAX_SPAN bins, the widest whose expected
    bucket fills at most BUCKET_FILL of a chunk; and enough blocks for
    every chunk."""
    rec, out = words
    sz = cand_kernel.order_sizing(b, n_bins, rec, out)
    assert sz.tile in cand_kernel.TILES
    fits = [t for t in cand_kernel.TILES if 4 * t * max(
        rec + 1, cand_kernel.UNSORT_WORDS) <= cand_kernel.TILE_SMEM]
    assert sz.tile == next((t for t in fits
                            if b >= cand_kernel.MIN_TILES * t),
                           cand_kernel.TILES[-1])
    assert sz.chunk <= cand_kernel.MAX_CHUNK
    assert (4 * (sz.chunk * max(rec, out) + (1 << sz.span_shift))
            + 2 * sz.chunk) <= cand_kernel.PROBE_SMEM
    assert sz.n_keys == ((n_bins - 1) >> sz.span_shift) + 1
    assert sz.n_keys <= cand_kernel.MAX_KEYS
    assert (1 << sz.span_shift) <= cand_kernel.MAX_SPAN
    span = 1 << sz.span_shift
    if span > 1 and ((n_bins - 1) >> (sz.span_shift - 1)) + 1 \
            <= cand_kernel.MAX_KEYS:
        assert b * span <= cand_kernel.BUCKET_FILL * sz.chunk * n_bins
    # every bucket's chunks: sum of ceil(count / chunk) <= max_chunks
    assert sz.max_chunks >= -(-b // sz.chunk) + (min(sz.n_keys, b) if b
                                                 else 0)
    if b == 10_000_000:  # the longest tile whose staged words fit
        assert sz.tile == (8192 if rec == 3 else 4096)


def test_sizing_refuses_too_many_bins():
    with pytest.raises(ValueError):
        cand_kernel.order_sizing(10, cand_kernel.MAX_KEYS
                                 * cand_kernel.MAX_SPAN + 1, 3, 3)


def _plain_order(r, idx, sz, words):
    """A BinOrder made by the plain versions (one tile order, as a kernel
    could make it)."""
    b = r.shape[0]
    counts, starts, chunk_end = cand_kernel.order_scan_plain(idx, sz)
    perm = torch.argsort(idx.long() >> sz.span_shift, stable=True)
    slot = torch.empty_like(perm)
    slot[perm] = torch.arange(b)
    rec = torch.empty_like(words)
    rec[slot] = words
    q = torch.arange(b)
    tile = q // sz.tile
    by = torch.argsort(tile * b + slot)
    pos = torch.empty_like(q)
    pos[by] = q - tile[by] * sz.tile
    return cand_kernel.BinOrder(rec, slot.int(), pos.int(), counts, starts,
                                chunk_end, sz)


def test_order_mismatches_catches_a_broken_order():
    """A sound order reads 0; a wrong count, record, slot or position does
    not."""
    _, g = _box()
    r = _batches(g)["ragged"]
    idx = _flat(g, r)
    sz = cand_kernel.order_sizing(r.shape[0], int(np.prod(g.cand_shape)), 3,
                                  3)
    sz = sz._replace(tile=512)
    words = cand_kernel.order_records_plain(r)
    good = _plain_order(r, idx, sz, words)
    assert cand_kernel.order_mismatches(good, idx, words) == 0

    def swap01(t):
        t[[0, 1]] = t[[1, 0]]

    def dup(t):
        t[0] = t[1]

    def bump(t):
        t[0] += 1

    for field, edit in (("counts", bump), ("rec", bump), ("slot", dup),
                        ("pos", swap01)):
        t = getattr(good, field).clone()
        edit(t)
        bad = good._replace(**{field: t})
        assert cand_kernel.order_mismatches(bad, idx, words) > 0, field


def test_records_plain():
    """The scatter's records: float32 words; a float64 grid's doubles; the
    df-plane rows' hi and lo, split or given."""
    r = torch.rand(7, 3, dtype=torch.float64)
    assert torch.equal(cand_kernel.order_records_plain(r.float()),
                       r.float().view(torch.int32))
    assert torch.equal(cand_kernel.order_records_plain(r),
                       r.view(torch.int32))
    hi = r.float()
    lo = (r - hi.double()).float()
    both = torch.cat([hi, lo], 1).view(torch.int32)
    assert torch.equal(cand_kernel.order_records_plain(r, True), both)
    assert torch.equal(cand_kernel.order_records_plain(hi, True, lo), both)
    zeros = torch.cat([hi, torch.zeros_like(hi)], 1).view(torch.int32)
    assert torch.equal(cand_kernel.order_records_plain(hi, True), zeros)


class _FakeLib:
    """Stands in for the kernel library: every entry point returns 0 and
    writes nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


@contextlib.contextmanager
def _no_card(monkeypatch):
    """bin_order_cuda's host side on CPU tensors: the library faked, the
    stream and device contexts stubbed, and any host read an error."""
    monkeypatch.setattr(cand_kernel._kernels, "lib", lambda: _FakeLib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())

    def no_read(*a, **k):
        raise AssertionError("host read")

    monkeypatch.setattr(timing, "host_read", no_read)
    monkeypatch.setattr(torch.Tensor, "item", no_read)
    yield


@pytest.mark.parametrize("traced", [False, True])
def test_counter_counts_only_while_tracing(monkeypatch, traced):
    """While tracing, the bin order counts its queries and adds its split
    buckets as a device count (read only by the report); off, it counts
    nothing and makes no count tensor; never a host read."""
    _, g = _box()
    r = _batches(g)["ragged"]
    bins = (g.cand_rmin, g.cand_inv_h, g.cand_shape)
    made = []
    real_zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: made.append(a) or
                        real_zeros(*a, **k))
    with _no_card(monkeypatch):
        ctx = torch.profiler.profile() if traced else contextlib.nullcontext()
        with ctx:
            order = cand_kernel.bin_order_cuda(r, *bins, 3)
            with timing.span("iu.interpolate_at", entry=True):
                cand_kernel.bin_order_cuda(r[:10], *bins, 3)
    monkeypatch.undo()
    assert order.rec.shape == (r.shape[0], 3)
    counters = timing.metrics.report()["counters"]
    if traced:
        assert counters["cand_order.queries"] == r.shape[0] + 10
        assert counters["cand_order.split_buckets"] == 0
        assert ((),) in made  # the split count, zeroed on the device
        call = timing.metrics.report()["entry_calls"][-1]["counters"]
        assert call["cand_order.queries"] == 10
    else:
        assert not any(k.startswith("cand_order.") for k in counters)
        assert ((),) not in made
    assert not any(k.startswith("host_reads.") for k in counters)


# ---------------------------------------------------------------- card

ROW_KINDS = {
    "quantized-tetra": ("tetra", lambda: meshgen.tet_box_mesh(12, 12, 12),
                        HOST),
    "quantized-triangle": ("triangle",
                           lambda: meshgen.triangle_rect_mesh(60, 50), HOST),
    "simplex-tetra": ("tetra", lambda: meshgen.tet_box_mesh(12, 12, 12),
                      dataclasses.replace(HOST, cand_quantized=False)),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(60, 50), HOST),
    "extension-tetra": ("tetra", lambda: meshgen.tet_box_mesh(12, 12, 12),
                        dataclasses.replace(
                            HOST, cand_bins_per_cell=0.3, cand_ext_max_k=256,
                            cand_cover_row_bytes=0)),
    "float64-tetra": ("tetra", lambda: meshgen.tet_box_mesh(12, 12, 12),
                      HOST),
}


def _card_grid(case, dev):
    cell_type, mesh, cfg = ROW_KINDS[case]
    pts, cells, nbrs = mesh()
    dtype = torch.float64 if case.startswith("float64") else torch.float32
    return pts, cell_type, tiu.build_grid(
        pts, cells, nbrs, cell_type, dtype=dtype, locate_mode="walk",
        config=cfg, device=dev,
        point_data={"a": pts.sum(1) + 1.0, "b": pts[:, 0] * pts[:, 1]})


def _card_batches(pts, cell_type, dtype, dev, n=300_000):
    """Uniform queries over the mesh (and a margin outside it) and a
    clustered batch (normal about one point), whose buckets split."""
    rng = np.random.default_rng(11)
    lo, hi = pts.min(0), pts.max(0)
    span = hi - lo
    uniform = lo - 0.05 * span + rng.random((n, 3)) * 1.1 * span
    clustered = np.clip(rng.normal(lo + 0.4 * span, 0.03 * span, (n, 3)),
                        lo, hi)
    out = {}
    for name, v in (("uniform", uniform), ("clustered", clustered)):
        if cell_type != "tetra":
            v[:, 2] = 0.0
        out[name] = torch.from_numpy(v.astype(
            np.float64 if dtype == torch.float64 else np.float32)).to(dev)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROW_KINDS))
def test_cuda_chain_matches_plain(cuda, case):
    """Key pass, scan and scatter equal their plain versions; the chain's
    id, aux and values are torch.equal to the plain probe (with the
    extension rows where the grid has them) on uniform and clustered
    batches."""
    pts, cell_type, g = _card_grid(case, cuda)
    k = g.cand_ids.shape[1]
    slots = tuple(range(g.cand_nv))
    lay = cand_table.layout(g, k, slots)
    eps = cand_table.probe_eps(g)
    chunk = cand_table.probe_chunk(g)
    bins = (g.cand_rmin, g.cand_inv_h, g.cand_shape)
    ext = None
    if g.cand_ext_table is not None:
        ext = (g.cand_ext_table,
               cand_table.layout(g, g.cand_ext_ids.shape[1], slots))
    assert ext is not None or case != "extension-tetra"
    for name, r in _card_batches(pts, cell_type, g.dtype, cuda).items():
        idx, rq = cand_table.probe_inputs(g, r)
        order = cand_kernel.bin_order_cuda(
            r, *bins, cand_kernel.out_words(lay, g.cand_table))
        assert cand_kernel.order_mismatches(
            order, idx, cand_kernel.order_records_plain(r)) == 0, name
        if ext is None:
            want = cand_kernel.probe_rows_plain(g.cand_table, idx, rq, lay,
                                                eps, k, chunk)
        else:
            want = cand_kernel.probe_rows_ext_plain(
                g.cand_table, ext[0], idx, rq, lay, ext[1], eps, k, chunk)
        got = cand_kernel.cand_rows_binned_query(g.cand_table, r, *bins, lay,
                                                 eps, k, chunk, ext)
        for a, w in zip(got, want):
            assert torch.equal(a, w), (case, name)


@pytest.mark.cuda
def test_cuda_df_chain_matches_plain(cuda):
    """The df-plane rows from float64 queries and from a float32 hi/lo
    pair, with and without the lo parts: the scatter's records equal
    their plain versions and the results cand_rows_df_plain's."""
    pts, _, g = _card_grid("quantized-tetra", cuda)
    g = tiu.prepare_accurate(g)
    lay = cand_table.df_layout(g, (0, 1))
    eps = cand_table.probe_eps(g)
    table = g.cand_df_table
    bins = (g.cand_rmin, g.cand_inv_h, g.cand_shape)
    for name, r64 in _card_batches(pts, "tetra", torch.float64,
                                   cuda).items():
        hi = r64.float()
        lo = (r64 - hi.double()).float()
        for r, r_lo in ((r64, None), (hi, lo), (hi, None)):
            idx = cand_kernel.probe_inputs_df_plain(r, r_lo, *bins)[0]
            order = cand_kernel.bin_order_cuda(
                r, *bins, cand_kernel.out_words(lay, table), df=True,
                r_lo=r_lo)
            assert cand_kernel.order_mismatches(
                order, idx, cand_kernel.order_records_plain(r, True, r_lo)
            ) == 0, name
            want = cand_kernel.cand_rows_df_plain(table, r, r_lo, *bins, lay,
                                                  eps, lay.k, 8192)
            got = cand_kernel.cand_rows_df_query(table, r, r_lo, *bins, lay,
                                                 eps, lay.k, 8192)
            for a, w in zip(got, want):
                assert torch.equal(a, w), (name, r.dtype, r_lo is None)


@pytest.mark.cuda
def test_cuda_chain_counts_split_buckets(cuda):
    """Traced, the counters hold the batch and the buckets of more than one
    chunk (the plain count); untraced, nothing."""
    pts, cell_type, g = _card_grid("quantized-tetra", cuda)
    lay = cand_table.layout(g, g.cand_ids.shape[1], (0,))
    bins = (g.cand_rmin, g.cand_inv_h, g.cand_shape)
    r = _card_batches(pts, cell_type, torch.float32, cuda)["clustered"]
    n_out = cand_kernel.out_words(lay, g.cand_table)
    cand_kernel.bin_order_cuda(r, *bins, n_out)
    assert not timing.metrics.report()["counters"]
    with torch.profiler.profile():
        order = cand_kernel.bin_order_cuda(r, *bins, n_out)
    counts, _, _ = cand_kernel.order_scan_plain(
        cand_table.probe_inputs(g, r)[0], order.sizing)
    split = int((counts > order.sizing.chunk).sum())
    assert split > 0
    c = timing.metrics.report()["counters"]
    assert c["cand_order.queries"] == r.shape[0]
    assert c["cand_order.split_buckets"] == split


@pytest.mark.cuda
def test_cuda_chain_replays_in_a_graph(cuda):
    """The chain captured in a CUDA graph and replayed on new queries gives
    the eager chain's outputs bit for bit."""
    pts, cell_type, g = _card_grid("quantized-tetra", cuda)
    k = g.cand_ids.shape[1]
    lay = cand_table.layout(g, k, (0,))
    eps = cand_table.probe_eps(g)
    bins = (g.cand_rmin, g.cand_inv_h, g.cand_shape)
    batches = _card_batches(pts, cell_type, torch.float32, cuda, 65_536)
    r = batches["uniform"].clone()

    def call():
        return cand_kernel.cand_rows_binned_query(g.cand_table, r, *bins, lay,
                                                  eps, k, 8192)

    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    graph = torch.cuda.CUDAGraph()
    with timing.capturing(), torch.cuda.stream(side):
        call()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = call()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(cuda).wait_stream(side)
    for batch in batches.values():
        r.copy_(batch)
        graph.replay()
        torch.cuda.synchronize()
        for a, w in zip(out, call()):
            assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["quantized-tetra", "extension-tetra",
                                  "float64-tetra", "quad"])
def test_cuda_finished_outputs_match_where(cuda, case):
    """The unsort's finished outputs (the cell or -1, the found mask, the
    values or the fill) are torch.equal to torch.where over the chain's
    id, aux and values, for a number and for NaN (compared as bits)."""
    pts, cell_type, g = _card_grid(case, cuda)
    k = g.cand_ids.shape[1]
    slots = tuple(range(g.cand_nv))
    lay = cand_table.layout(g, k, slots)
    args = (g.cand_table, None, g.cand_rmin, g.cand_inv_h, g.cand_shape, lay,
            cand_table.probe_eps(g), k, cand_table.probe_chunk(g))
    ext = None
    if g.cand_ext_table is not None:
        ext = (g.cand_ext_table,
               cand_table.layout(g, g.cand_ext_ids.shape[1], slots))
    bits = torch.int64 if g.dtype == torch.float64 else torch.int32
    for name, r in _card_batches(pts, cell_type, g.dtype, cuda).items():
        call = (args[0], r) + args[2:]
        i, a, v = cand_kernel.cand_rows_binned_query(*call, ext)
        found = a == -2
        # the uniform batch's margin outside the mesh; the clustered one
        # lies inside
        assert bool((~found).any()) == (name == "uniform"), name
        for fill in (-7.0, float("nan")):
            want = (torch.where(found, i, -1), found,
                    torch.where(found[:, None], v, fill))
            got = cand_kernel.cand_rows_found_query(*call, ext, fill)
            assert got[1].dtype == torch.bool
            for part, w in zip(got, want):
                if part.is_floating_point():
                    part, w = part.view(bits), w.view(bits)
                assert torch.equal(part, w), (case, name, fill)
