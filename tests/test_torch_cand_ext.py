"""Kernel B2's extension rows: the plain composition against the JAX
package, and the probe in bin order with the extension probe against it
on the card.

A grid whose bins overflow K candidates keeps candidates K..K+k_ext of
each overflow bin in an extension row; a query that no main candidate
contains probes it, and one that even the extension row does not hold
(a bin beyond K + k_ext: ``cand_ext_covers`` false) walks from its best
main candidate.  ``cand_kernel.probe_rows_ext_plain`` is the plain
version of the main probe, the extension probe and their merge;
``locate._candidates_query`` on CPU tensors runs it, then the residual
walks.  Grids here force the extension rows (``cand_bins_per_cell`` below
1, ``cand_cover_row_bytes=0``): quantized tets, float32 triangles
(quantized), quads (layout 2) and float64 tets (layout 1, K = 7), each
with an extension table that covers every bin (``cand_ext_max_k=256``)
and with one that does not (``cand_ext_max_k=2``).  The JAX package's
``_candidates_query`` runs the same queries on the same tables, carried
bit for bit: found masks identical; ids identical except near-ties, where
both cells contain the point (XLA contracts the JAX side's float32
arithmetic into FMAs); values within 1e-6 absolute plus 1e-6 relative
where the ids agree, the tolerance of
``test_torch_cand_kernel.py::test_binned_query_matches_pallas_interpret``.

The ``cuda`` case (skipped without a card) holds the probe in bin order
with the extension probe ``torch.equal`` to the plain composition on
the same grids, in float32 and float64, at every group size, and the
main path's results equal to the CPU's.
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

FORCED = dict(cand_build="host", cand_cover_row_bytes=0,
              walk_compact_min_batch=1 << 16)
CASES = {
    # cell type, mesh, dtype, bins a cell, row kind
    "quantized-tetra": ("tetra", lambda: meshgen.tet_box_mesh(12, 12, 12),
                        "float32", 0.3, "quantized"),
    "quantized-triangle": ("triangle",
                           lambda: meshgen.triangle_rect_mesh(40, 36),
                           "float32", 0.1, "quantized"),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(40, 36), "float32", 0.1,
             "quad"),
    "float64-tetra": ("tetra", lambda: meshgen.tet_box_mesh(12, 12, 12),
                      "float64", 0.3, "simplex"),
}
COVERS = {"covers": 256, "residual": 2}  # cand_ext_max_k


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests (on
    some virtualized hosts a thread's first float32 torch.sqrt is off by
    ~1e-4 relative; the triangle and quad weights and the walks call
    it)."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _config(case, covers):
    return dict(FORCED, cand_bins_per_cell=CASES[case][3],
                cand_ext_max_k=COVERS[covers])


def _mesh(case):
    cell_type, gen, dtype, _, _ = CASES[case]
    pts, cells, nbrs = gen()
    return cell_type, pts, cells, nbrs, dtype


def _point_data(pts):
    return {"Polynomial": pts.sum(1) + 1.0}


def _queries(pts, cell_type, n, dtype, seed=7):
    """Uniform in the mesh's box grown by 10% a side (outside queries
    included); 2D meshes stay in their plane."""
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(0), pts.max(0)
    r = lo - 0.1 * (hi - lo) + rng.random((n, 3)) * 1.2 * (hi - lo)
    if cell_type != "tetra":
        r[:, 2] = 0.0
    return r.astype(dtype)


def _ext_args(g):
    """(table, ext table, main layout, extension layout, eps, K) of a
    grid's probe with its extension rows, every fused variable."""
    slots = tuple(range(g.cand_nv))
    k = g.cand_ids.shape[1]
    lay = cand_table.layout(g, k, slots)
    lay_e = cand_table.layout(g, g.cand_ext_ids.shape[1], slots)
    return g.cand_table, g.cand_ext_table, lay, lay_e, cand_table.probe_eps(g), k


@pytest.mark.parametrize("covers", list(COVERS))
@pytest.mark.parametrize("case", list(CASES))
def test_ext_plain_matches_jax(case, covers):
    """The plain composition (locate._candidates_query on the CPU: the
    main probe, the extension probe, the merge, the residual walks)
    against the JAX package's _candidates_query."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu
    from interpolate_unstructured_tpu.ops import locate as jlocate

    cell_type, pts, cells, nbrs, dtype = _mesh(case)
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=getattr(jnp, dtype),
                        locate_mode="walk", point_data=_point_data(pts),
                        config=jiu.IUConfig(**_config(case, covers)))
    tg = tiu.grid_from_numpy(
        {f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
         for f in DATA_FIELDS},
        {f: getattr(ug, f) for f in META_FIELDS}, "cpu",
    )
    assert tg.cand_ext_table is not None
    assert tg.cand_ext_covers == (covers == "covers")
    table, ext_t, lay, lay_e, eps, k = _ext_args(tg)
    assert lay.kind == CASES[case][4]
    r = _queries(pts, cell_type, 3000, dtype)
    rt = torch.from_numpy(r)
    slots = tuple(range(tg.cand_nv))

    # the plain composition reaches the extension rows, and leaves
    # residual walks exactly where the extension rows do not cover
    idx, rq = cand_table.probe_inputs(tg, rt)
    main = cand_kernel.probe_rows_plain(table, idx, rq, lay, eps, k, 1024)
    ext = cand_kernel.probe_rows_ext_plain(table, ext_t, idx, rq, lay, lay_e,
                                           eps, k, 1024)
    reached = main[1] >= 0
    assert bool(reached.any()) and bool((ext[1][reached] == -2).any())
    assert bool((ext[1] >= 0).any()) == (covers == "residual")
    assert torch.equal(ext[1][~reached], main[1][~reached])
    # the CPU dispatch of the probe in bin order is the plain composition
    got = cand_kernel.cand_rows_binned_query(
        table, rt, tg.cand_rmin, tg.cand_inv_h, tg.cand_shape, lay, eps, k,
        1024, (ext_t, lay_e))
    for a, b in zip(got, ext):
        assert torch.equal(a, b)

    jic, jfound, jvals = jlocate._candidates_query(
        ug, jnp.asarray(r), slots if slots else None)
    tic, tfound, tvals = locate._candidates_query(tg, rt, slots)
    jic = torch.from_numpy(np.array(jic))
    assert torch.equal(tfound, torch.from_numpy(np.array(jfound)))
    assert 0 < int(tfound.sum()) < len(r)
    differ = torch.nonzero(jic != tic).squeeze(1)
    assert differ.numel() <= 0.01 * len(r)
    if differ.numel():
        rr = rt[differ]
        assert bool(tfound[differ].all())
        assert bool(tiu.point_is_inside_cell(tg, rr, jic[differ]).all())
        assert bool(tiu.point_is_inside_cell(tg, rr, tic[differ]).all())
    if slots:
        same = tfound & (jic == tic)
        np.testing.assert_allclose(tvals[same].numpy(),
                                   np.array(jvals).T[same.numpy()],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_ext_merge_rules(case):
    """The merged record, query by query, from its two probes: found in
    the extension row -> that winner; not there -> the main winner's id
    and values with the extension row's verdict; every other query the
    main probe's record."""
    cell_type, pts, cells, nbrs, dtype = _mesh(case)
    tg = tiu.build_grid(pts, cells, nbrs, cell_type,
                        dtype=getattr(torch, dtype), locate_mode="walk",
                        point_data=_point_data(pts),
                        config=tiu.IUConfig(**_config(case, "residual")),
                        device="cpu")
    table, ext_t, lay, lay_e, eps, k = _ext_args(tg)
    rt = torch.from_numpy(_queries(pts, cell_type, 3000, dtype, seed=8))
    idx, rq = cand_table.probe_inputs(tg, rt)
    mid, maux, mval = cand_kernel.probe_rows_plain(table, idx, rq, lay, eps,
                                                   k, 1024)
    gid, gaux, gval = cand_kernel.probe_rows_ext_plain(
        table, ext_t, idx, rq, lay, lay_e, eps, k, 1024)
    sel = maux >= 0
    eid, eaux, eval_ = cand_kernel.probe_rows_plain(
        ext_t, maux[sel], rq[sel], lay_e, eps, k + lay_e.k, 1024)
    found = eaux == -2
    assert bool(found.any()) and bool((eaux >= 0).any())
    assert torch.equal(gid[sel], torch.where(found, eid, mid[sel]))
    assert torch.equal(gaux[sel], eaux)
    assert torch.equal(gval[sel], torch.where(found[:, None], eval_,
                                              mval[sel]))
    for a, b in ((gid, mid), (gaux, maux), (gval, mval)):
        assert torch.equal(a[~sel], b[~sel])


@pytest.mark.cuda
@pytest.mark.parametrize("covers", list(COVERS))
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_ext_probe_matches_plain(cuda, case, covers):
    """The probe in bin order with the extension probe, torch.equal to
    probe_rows_ext_plain at every group size; one launch of it; the
    public cold call's cells and found masks equal to the CPU's, its
    values within 1e-6 (torch computes the bin frame on the CPU in
    another rounding than on the card)."""
    cell_type, pts, cells, nbrs, dtype = _mesh(case)
    grids = [tiu.build_grid(pts, cells, nbrs, cell_type,
                            dtype=getattr(torch, dtype), locate_mode="walk",
                            point_data=_point_data(pts),
                            config=tiu.IUConfig(**_config(case, covers)),
                            device=dev) for dev in (cuda, "cpu")]
    g = grids[0]
    table, ext_t, lay, lay_e, eps, k = _ext_args(g)
    rt = torch.from_numpy(_queries(pts, cell_type, 100_000, dtype)).to(cuda)
    idx, rq = cand_table.probe_inputs(g, rt)
    want = cand_kernel.probe_rows_ext_plain(table, ext_t, idx, rq, lay, lay_e,
                                            eps, k, 8192)
    assert bool((want[1] >= 0).any()) == (covers == "residual")
    bins = (g.cand_rmin, g.cand_inv_h, g.cand_shape)
    order = cand_kernel.bin_order_cuda(rt, *bins,
                                       cand_kernel.out_words(lay, table))
    assert cand_kernel.order_mismatches(
        order, idx, cand_kernel.order_records_plain(rt)) == 0
    for lanes in (1, 2, 4, 8, 32):
        before = cand_kernel.ext_launches
        got = cand_kernel.cand_rows_binned_cuda(table, order, *bins, lay, eps,
                                                k, lanes, ext=(ext_t, lay_e))
        torch.cuda.synchronize()
        assert cand_kernel.ext_launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), lanes
    fn = tiu.interpolate_scalar_at if g.cand_nv else tiu.get_cell
    args = (0,) if g.cand_nv else ()
    for a, b in zip(fn(g, rt, *args), fn(grids[1], rt.cpu(), *args)):
        if a.is_floating_point():  # the bin frame rounds as its device does
            torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6,
                                       equal_nan=True)
        else:
            assert torch.equal(a.cpu(), b)
