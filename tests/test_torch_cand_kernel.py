"""Kernel B2 (candidate-row probe) against the JAX package.

The JAX package's Pallas kernel runs in interpret mode
(``pallas_cand.cand_rows_query(..., interpret=True)``), driven as
``tests/test_pallas_cand.py`` drives it, on the float32 tables of a
walk grid; the same tables are carried into the port with
``grid_from_numpy`` and the port's plain version probes them with the
same row indices and queries.  All three float32 row layouts are
covered, on the main and on the extension table.  ``aux`` must be
identical, and so must ``id_best``, except for a miss (exact or
overflow) whose two best
margins lie within 4 eps of each other: XLA contracts the JAX kernel's
margin arithmetic into FMAs, torch rounds every operation, so an exact
tie on one side may be broken by an ulp on the other.  A miss's
``id_best`` is never used (an overflow miss reads only its slot).  Values agree to 1e-6 absolute plus 1e-6
relative: the f32-simplex layout forms values as sums of margin x
premultiplied-data products, where the FMA-versus-rounded difference
reaches a few ulp of values near 5.

The CUDA kernel is held against the plain version where a card exists;
those tests use the port alone, so that on a machine without jax they
run with ``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models import cand_table
from interpolate_unstructured_tpu_torch.models.grid import (
    DATA_FIELDS,
    META_FIELDS,
)
from interpolate_unstructured_tpu_torch.ops import cand_kernel, locate
from interpolate_unstructured_tpu_torch.utils import meshgen

HOST = tiu.IUConfig(cand_build="host")
CASES = {
    # kind of row layout, cell type, mesh, config
    "quantized-tetra": (
        "quantized", "tetra", lambda: meshgen.tet_box_mesh(6, 6, 6), HOST,
    ),
    "quantized-triangle": (
        "quantized", "triangle", lambda: meshgen.triangle_rect_mesh(24, 20),
        HOST,
    ),
    "simplex-tetra": (
        "simplex", "tetra", lambda: meshgen.tet_box_mesh(6, 6, 6),
        dataclasses.replace(HOST, cand_quantized=False),
    ),
    "quad": ("quad", "quad", lambda: meshgen.quad_rect_mesh(24, 20), HOST),
    "extension-tetra": (
        "quantized", "tetra", lambda: meshgen.tet_box_mesh(12, 12, 12),
        dataclasses.replace(HOST, cand_bins_per_cell=0.3, cand_ext_max_k=256,
                            cand_cover_row_bytes=0),
    ),
}


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests.

    On some virtualized x86 hosts the first float32 torch.sqrt that a worker
    thread runs in a process returns values off by ~1e-4 relative for
    that thread's chunk; every later call is exact.  The plain versions
    under test call torch.sqrt (triangle and quad weights), so the
    first, discarded call is made here."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax():
    """The JAX package's modules (the reference side of a parity test)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu
    from interpolate_unstructured_tpu.ops import locate as jlocate
    from interpolate_unstructured_tpu.ops import pallas_cand

    return jnp, jiu, jlocate, pallas_cand


def carry(ug, device="cpu"):
    """The JAX grid's state as a port grid (bit-identical tables)."""
    leaves = {
        f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
        for f in DATA_FIELDS
    }
    return tiu.grid_from_numpy(
        leaves, {f: getattr(ug, f) for f in META_FIELDS}, device
    )


def _point_data(pts):
    return {"Polynomial": pts.sum(1) + 1.0, "XY": pts[:, 0] * pts[:, 1]}


def _queries(pts, cell_type, n):
    rng = np.random.default_rng(5)
    lo, hi = pts.min(0), pts.max(0)
    span = hi - lo
    r = (lo - 0.1 * span + rng.random((n, 3)) * 1.2 * span).astype(np.float32)
    if cell_type != "tetra":
        r[:, 2] = 0.0
    return r


def _setup(case, n=3000):
    jnp, jiu, jlocate, _ = _jax()
    kind, cell_type, mesh, cfg = CASES[case]
    pts, cells, nbrs = mesh()
    ug = jiu.build_grid(
        pts, cells, nbrs, cell_type, dtype=jnp.float32, locate_mode="walk",
        config=jiu.IUConfig(**dataclasses.asdict(cfg)),
        point_data=_point_data(pts),
    )
    r = _queries(pts, cell_type, n)
    # bin index and probe frame from the JAX package, handed to both
    r_t = jnp.asarray(r).T
    ijk = jlocate._cand_bin_ijk_t(ug, r_t)
    nby, nbz = ug.cand_shape[1], ug.cand_shape[2]
    idx = (ijk[0] * nby + ijk[1]) * nbz + ijk[2]
    rq_t = jlocate._cand_local_t(ug, r_t, ijk) if kind == "quantized" else r_t
    return ug, np.array(idx, np.int32), np.array(rq_t).T.copy()


def _jax_probe(ug, table, idx, rq, k, lay, eps, ovf_base):
    jnp, _, _, pallas_cand = _jax()
    nv = ug.cand_nv
    return pallas_cand.cand_rows_query(
        ug, table, jnp.asarray(idx), jnp.asarray(rq).T, tuple(range(nv)),
        lay.count_col, eps, ovf_base, k_max=k, interpret=True,
        quantized=lay.kind == "quantized", nv_fused=nv,
    )


def _check_same(jout, tout, table, idx, rq, lay, eps):
    jid, jaux, jvals = (np.asarray(x) for x in jout)
    tid, taux, tvals = (x.numpy() for x in tout)
    np.testing.assert_array_equal(taux, jaux)
    differ = np.flatnonzero(tid != jid)
    if len(differ):
        assert (taux[differ] != -2).all()
        g = table[torch.from_numpy(idx[differ]).long()]
        _, m = cand_kernel._margins_plain(g, torch.from_numpy(rq[differ]), lay)
        top2 = torch.topk(m, 2, dim=1).values
        assert ((top2[:, 0] - top2[:, 1]) <= 4 * eps).all()
        assert len(differ) <= 0.01 * len(tid)
    found = taux == -2
    np.testing.assert_allclose(tvals[found], jvals.T[found], rtol=1e-6,
                               atol=1e-6)
    return taux


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(case):
    ug, idx, rq = _setup(case)
    tg = carry(ug)
    k = ug.cand_ids.shape[1]
    slots = tuple(range(tg.cand_nv))
    lay = cand_table.layout(tg, k, slots)
    assert lay.kind == CASES[case][0]
    eps = cand_table.probe_eps(tg)
    tout = cand_kernel.probe_rows_plain(
        tg.cand_table, torch.from_numpy(idx), torch.from_numpy(rq), lay,
        eps, k, chunk=1024,
    )
    aux = _check_same(
        _jax_probe(ug, ug.cand_table, idx, rq, k, lay, eps, k), tout,
        tg.cand_table, idx, rq, lay, eps,
    )
    assert (aux == -2).any() and (aux == -1).any()

    if ug.cand_ext_table is None:
        return
    # extension rows: every overflow-bin miss probes its bin's row
    sel = np.flatnonzero(aux >= 0)
    assert len(sel)
    k_ext = ug.cand_ext_ids.shape[1]
    lay_e = cand_table.layout(tg, k_ext, slots)
    tout_e = cand_kernel.probe_rows_plain(
        tg.cand_ext_table, torch.from_numpy(aux[sel]),
        torch.from_numpy(rq[sel]), lay_e, eps, k + k_ext, chunk=1024,
    )
    aux_e = _check_same(
        _jax_probe(ug, ug.cand_ext_table, aux[sel], rq[sel], k_ext, lay_e,
                   eps, k + k_ext),
        tout_e, tg.cand_ext_table, aux[sel], rq[sel], lay_e, eps,
    )
    assert (aux_e == -2).any()


def test_port_probe_inputs_match_jax():
    jnp, _, jlocate, _ = _jax()
    ug, idx, rq = _setup("quantized-tetra")
    tg = carry(ug)
    r_t = torch.from_numpy(rq)  # any (B, 3) queries will do
    jr_t = jnp.asarray(rq).T
    jijk = jlocate._cand_bin_ijk_t(ug, jr_t)
    tidx, trq = cand_table.probe_inputs(tg, r_t)
    nby, nbz = ug.cand_shape[1], ug.cand_shape[2]
    np.testing.assert_array_equal(
        tidx.numpy(), np.asarray((jijk[0] * nby + jijk[1]) * nbz + jijk[2])
    )
    np.testing.assert_array_equal(
        trq.numpy(), np.asarray(jlocate._cand_local_t(ug, jr_t, jijk)).T
    )


def _ext(tg, var_slots):
    """(extension table, its RowLayout) of a grid with extension rows,
    else None: the ``ext`` argument of the probe in bin order."""
    if tg.cand_ext_table is None:
        return None
    return (tg.cand_ext_table,
            cand_table.layout(tg, tg.cand_ext_ids.shape[1], var_slots))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_matches_plain(cuda, case):
    """The probe in bin order, with the extension probe on the grid that
    has extension rows, torch.equal to the plain composition
    (probe_rows_ext_plain, or probe_rows_plain without extension rows) on
    100,000 queries; one launch of the probe."""
    kind, cell_type, mesh, cfg = CASES[case]
    pts, cells, nbrs = mesh()
    tg = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                        locate_mode="walk", config=cfg,
                        point_data=_point_data(pts), device=cuda)
    r = torch.from_numpy(_queries(pts, cell_type, 100_000)).to(cuda)
    idx, rq = cand_table.probe_inputs(tg, r)
    k = tg.cand_ids.shape[1]
    slots = tuple(range(tg.cand_nv))
    lay = cand_table.layout(tg, k, slots)
    assert lay.kind == kind
    eps = cand_table.probe_eps(tg)
    ext = _ext(tg, slots)
    before = cand_kernel.binned_launches + cand_kernel.ext_launches
    got = cand_kernel.cand_rows_binned_query(
        tg.cand_table, r, tg.cand_rmin, tg.cand_inv_h, tg.cand_shape, lay,
        eps, k, 8192, ext)
    torch.cuda.synchronize()
    assert cand_kernel.binned_launches + cand_kernel.ext_launches == before + 1
    if ext is None:
        want = cand_kernel.probe_rows_plain(tg.cand_table, idx, rq, lay, eps,
                                            k, 8192)
    else:
        want = cand_kernel.probe_rows_ext_plain(
            tg.cand_table, ext[0], idx, rq, lay, ext[1], eps, k, 8192)
        main = cand_kernel.probe_rows_plain(tg.cand_table, idx, rq, lay, eps,
                                            k, 8192)
        assert bool((main[1] >= 0).any()) and not bool((want[1] >= 0).any())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# The bin-ordered probe of the main table: the plain bin ordering, the
# plain probe in bin order against the direct plain probe and the JAX
# package, the CUDA wrappers' checks; on the card, the three kernels
# against their plain versions, bit for bit.
def _order_batches(shape):
    """Flat bin indices (B,) int32 of skewed batches over ``shape`` bins:
    random with empty bins, all in one bin, one per bin in reverse order,
    and the empty batch."""
    n_bins = int(np.prod(shape))
    rng = np.random.default_rng(31)
    return {
        "random": rng.integers(0, n_bins // 3, 5000) * 3,
        "one_bin": np.full(777, n_bins // 2),
        "one_per_bin": np.arange(n_bins)[::-1].copy(),
        "empty": np.zeros(0, np.int64),
    }


@pytest.mark.parametrize("batch", ["random", "one_bin", "one_per_bin",
                                   "empty"])
def test_bin_order_plain(batch):
    """A permutation that groups the queries by bin in ascending bin order,
    stable in a bin; empty bins take no slot."""
    idx = torch.from_numpy(_order_batches((20, 17, 9))[batch]).to(torch.int32)
    perm = cand_kernel.bin_order_plain(idx)
    assert torch.equal(torch.sort(perm).values, torch.arange(len(idx)))
    grouped = idx[perm]
    assert bool((grouped[1:] >= grouped[:-1]).all())
    same_bin = grouped[1:] == grouped[:-1]
    assert bool((perm[1:][same_bin] > perm[:-1][same_bin]).all())


def _cpu_grid(case):
    kind, cell_type, mesh, cfg = CASES[case]
    pts, cells, nbrs = mesh()
    tg = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                        locate_mode="walk", config=cfg,
                        point_data=_point_data(pts), device="cpu")
    return pts, tg


@pytest.mark.parametrize("case", list(CASES))
def test_probe_in_bin_order_matches_direct(case):
    """The probe in bin order, put back in query order, equals the direct
    plain probe on every output, bit for bit; queries inside and outside
    the mesh, with a batch that falls in one bin."""
    pts, tg = _cpu_grid(case)
    k = tg.cand_ids.shape[1]
    lay = cand_table.layout(tg, k, tuple(range(tg.cand_nv)))
    eps = cand_table.probe_eps(tg)
    r = torch.from_numpy(_queries(pts, CASES[case][1], 4000))
    one = r[:1].repeat(300, 1) + 1e-6 * torch.arange(300)[:, None]
    for q in (r, one):
        idx, rq = cand_table.probe_inputs(tg, q)
        want = cand_kernel.probe_rows_plain(tg.cand_table, idx, rq, lay, eps,
                                            k, chunk=1024)
        perm = cand_kernel.bin_order_plain(idx)
        in_order = cand_kernel.probe_rows_plain(
            tg.cand_table, idx[perm], rq[perm], lay, eps, k, chunk=1024)
        query = cand_kernel.cand_rows_binned_query(
            tg.cand_table, q, tg.cand_rmin, tg.cand_inv_h, tg.cand_shape, lay,
            eps, k, chunk=1024)
        for a, b, c in zip(in_order, want, query):
            back = torch.empty_like(a)
            back[perm] = a
            assert torch.equal(back, b) and torch.equal(c, b)
    assert (want[1] == -2).any()


@pytest.mark.parametrize("case", ["quantized-tetra", "quad",
                                  "extension-tetra"])
def test_binned_query_matches_pallas_interpret(case):
    """The main-table probe in bin order (the CPU path of
    cand_rows_binned_query) against the JAX package's Pallas kernel in
    interpret mode, with the tolerances of the direct probe's test."""
    ug, idx, rq = _setup(case)
    tg = carry(ug)
    k = ug.cand_ids.shape[1]
    lay = cand_table.layout(tg, k, tuple(range(tg.cand_nv)))
    eps = cand_table.probe_eps(tg)
    pts = CASES[case][2]()[0]
    r = torch.from_numpy(_queries(pts, CASES[case][1], 3000))  # _setup's
    tout = cand_kernel.cand_rows_binned_query(
        tg.cand_table, r, tg.cand_rmin, tg.cand_inv_h, tg.cand_shape, lay,
        eps, k, chunk=1024)
    aux = _check_same(_jax_probe(ug, ug.cand_table, idx, rq, k, lay, eps, k),
                      tout, tg.cand_table, idx, rq, lay, eps)
    assert (aux == -2).any() and (aux == -1).any()


def test_cand_wrapper_checks():
    """The CUDA wrappers refuse a wrong dtype, device or stride before they
    reach a kernel."""
    pts, tg = _cpu_grid("quantized-tetra")
    k = tg.cand_ids.shape[1]
    lay = cand_table.layout(tg, k, (0,))
    eps = cand_table.probe_eps(tg)
    grid_args = (tg.cand_rmin, tg.cand_inv_h, tg.cand_shape)
    n_out = cand_kernel.out_words(lay, tg.cand_table)
    r = torch.full((5, 3), 0.5)
    meta = torch.empty((5, 3), device="meta")
    n_bins = int(np.prod(tg.cand_shape))

    def order(b=5, rec_words=3, out_words=n_out, bins=n_bins):
        sz = cand_kernel.order_sizing(b, bins, rec_words, out_words)

        def ints(*shape):
            return torch.zeros(shape, dtype=torch.int32)

        return cand_kernel.BinOrder(ints(b, rec_words), ints(b), ints(b),
                                    ints(sz.n_keys), ints(sz.n_keys),
                                    ints(sz.n_keys), sz)

    with pytest.raises(TypeError):  # float32 or float64 queries only
        cand_kernel.bin_order_cuda(r.half(), *grid_args, n_out)
    with pytest.raises(ValueError):
        cand_kernel.bin_order_cuda(meta, *grid_args, n_out)
    with pytest.raises(ValueError):
        cand_kernel.bin_order_cuda(r, tg.cand_rmin.double(), tg.cand_inv_h,
                                   tg.cand_shape, n_out)
    with pytest.raises(TypeError):  # float64 queries: df-plane rows only
        cand_kernel.bin_order_cuda(r.double(), *grid_args, n_out)
    with pytest.raises(ValueError):  # r_lo: df-plane rows only
        cand_kernel.bin_order_cuda(r, *grid_args, n_out, r_lo=r)
    with pytest.raises(TypeError):
        cand_kernel.cand_rows_binned_cuda(tg.cand_table, (r, r), *grid_args,
                                          lay, eps, k)
    with pytest.raises(ValueError):  # the df-plane rows' records
        cand_kernel.cand_rows_binned_cuda(tg.cand_table, order(rec_words=6),
                                          *grid_args, lay, eps, k)
    with pytest.raises(ValueError):  # sized for other results
        cand_kernel.cand_rows_binned_cuda(tg.cand_table,
                                          order(out_words=n_out + 1),
                                          *grid_args, lay, eps, k)
    with pytest.raises(ValueError):  # made for another bin grid
        cand_kernel.cand_rows_binned_cuda(tg.cand_table,
                                          order(bins=10 * n_bins),
                                          *grid_args, lay, eps, k)
    with pytest.raises(ValueError):
        cand_kernel.cand_rows_binned_cuda(tg.cand_table[:, ::2], order(),
                                          *grid_args, lay, eps, k)
    with pytest.raises(ValueError):
        cand_kernel.cand_rows_binned_cuda(tg.cand_table.to("meta"), order(),
                                          *grid_args, lay, eps, k)
    with pytest.raises(ValueError):
        cand_kernel.cand_rows_binned_cuda(tg.cand_table, order(), *grid_args,
                                          lay, eps, k, lanes=3)
    # extension rows: the main rows' layout with their own k, a
    # contiguous table of the main table's dtype that the layout fits
    lay_e = cand_table.layout(tg, 5, (0,))
    ext_t = torch.zeros((3, lay_e.count_col + 2))
    for bad in ((ext_t, dataclasses.replace(lay_e, kind="simplex")),
                (ext_t, dataclasses.replace(lay_e, id_role=lay.id_role + 1)),
                (ext_t.double(), lay_e), (ext_t[:, ::2], lay_e),
                (ext_t[:, :-2], lay_e)):
        with pytest.raises(ValueError):
            cand_kernel.cand_rows_binned_cuda(tg.cand_table, order(),
                                              *grid_args, lay, eps, k,
                                              ext=bad)
    df_lay = dataclasses.replace(lay, kind="qdf")
    with pytest.raises(ValueError):
        cand_kernel.cand_rows_binned_cuda(
            tg.cand_table, order(6, cand_kernel.out_words(df_lay,
                                                          tg.cand_table)),
            *grid_args, df_lay, eps, k, ext=(ext_t, lay_e))


def _skewed(pts, cell_type, tg, dev):
    """Skewed query batches on ``dev``: uniform (inside and outside),
    every query in one bin, one query per bin (the bin centers), a batch
    that is not a multiple of the block, and the empty batch."""
    uniform = _queries(pts, cell_type, 30_000)
    one = np.repeat(uniform[:1], 4000, axis=0)
    one = one + (1e-6 * np.random.default_rng(32).random(one.shape)).astype(
        np.float32)
    shape = tg.cand_shape
    inv_h = tg.cand_inv_h.cpu().numpy().astype(np.float64)
    h = np.divide(1.0, inv_h, out=np.zeros(3), where=inv_h > 0)
    axes = [tg.cand_rmin.cpu().numpy()[d] + (np.arange(shape[d]) + 0.5) * h[d]
            for d in range(3)]
    per_bin = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    out = {"uniform": uniform, "one_bin": one, "one_per_bin": per_bin,
           "ragged": uniform[:1037], "empty": uniform[:0]}
    for name, v in out.items():
        v = v.astype(np.float32)
        if cell_type != "tetra":
            v[:, 2] = 0.0
        out[name] = torch.from_numpy(v).to(dev)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_binned_matches_plain(cuda, case):
    """The key pass, scan and scatter give the plain counts, scans,
    records and slots (``order_mismatches``); the probe in bin order,
    with any number of lanes per query, is torch.equal to
    probe_rows_plain on every skewed batch (the extension case
    included)."""
    kind, cell_type, mesh, cfg = CASES[case]
    pts, cells, nbrs = mesh()
    tg = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                        locate_mode="walk", config=cfg,
                        point_data=_point_data(pts), device=cuda)
    k = tg.cand_ids.shape[1]
    lay = cand_table.layout(tg, k, tuple(range(tg.cand_nv)))
    eps = cand_table.probe_eps(tg)
    grid_args = (tg.cand_rmin, tg.cand_inv_h, tg.cand_shape)
    n_bins = int(np.prod(tg.cand_shape))
    n_out = cand_kernel.out_words(lay, tg.cand_table)
    for name, r in _skewed(pts, cell_type, tg, cuda).items():
        idx_p, rq = cand_table.probe_inputs(tg, r)
        order = cand_kernel.bin_order_cuda(r, *grid_args, n_out)
        torch.cuda.synchronize()
        assert order.sizing == cand_kernel.order_sizing(
            len(r), n_bins, 3, n_out), name
        assert cand_kernel.order_mismatches(
            order, idx_p, cand_kernel.order_records_plain(r)) == 0, name
        want = cand_kernel.probe_rows_plain(tg.cand_table, idx_p, rq, lay,
                                            eps, k, chunk=8192)
        for lanes in (1, 2, 4, 8, 16, 32):
            before = (cand_kernel.binned_launches,
                      cand_kernel.bin_unsort_launches)
            got = cand_kernel.cand_rows_binned_cuda(
                tg.cand_table, order, *grid_args, lay, eps, k, lanes=lanes)
            torch.cuda.synchronize()
            one = 1 if len(r) else 0
            assert (cand_kernel.binned_launches,
                    cand_kernel.bin_unsort_launches) == (
                        before[0] + one, before[1] + one)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (name, lanes)
        query = cand_kernel.cand_rows_binned_query(tg.cand_table, r, *grid_args,
                                                   lay, eps, k, 8192)
        for a, b in zip(query, want):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_binned_on_the_main_path(cuda):
    """Cold interpolate_scalar_at and get_cell on a candidate grid launch
    the bin order's kernels, the probe with the extension rows on
    the extension grid, and read nothing back to the host between the
    probe and the values where the rows cover every bin."""
    for case in ("quantized-tetra", "extension-tetra"):
        kind, cell_type, mesh, cfg = CASES[case]
        pts, cells, nbrs = mesh()
        tg = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                            locate_mode="walk", config=cfg,
                            point_data=_point_data(pts), device=cuda)
        assert tg.cand_ext_covers
        r = torch.from_numpy(_queries(pts, cell_type, 50_000)).to(cuda)
        for call in (lambda: tiu.interpolate_scalar_at(tg, r, 0),
                     lambda: tiu.get_cell(tg, r)):
            names = ("bin_pass_launches", "bin_scatter_launches",
                     "binned_launches", "ext_launches", "bin_unsort_launches")
            before = [getattr(cand_kernel, n) for n in names]
            call()
            torch.cuda.synchronize()
            d = [getattr(cand_kernel, n) - b for n, b in zip(names, before)]
            ext = case == "extension-tetra"
            assert d == [1, 1, int(not ext), int(ext), 1], (case, d)
        # no synchronizing copy from the probe to the returned values
        locate._candidates_query(tg, r, (0,))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            locate._candidates_query(tg, r, (0,))
        ops = {e.key for e in prof.key_averages()}
        assert not ops & {"aten::nonzero", "aten::item",
                          "aten::_local_scalar_dense"}, (case, ops)
