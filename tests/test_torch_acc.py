"""Accurate mode of the port against the JAX package.

Both packages build the same float32 walk grids natively
(``cand_build="host"``): the 7x7x7 tet box with the nonlinear data of
``tests/test_acc_fused.py``, and 12x10 triangle and quad rectangles
scaled by pi (``tests/test_torch_acc_kernel.py`` has the meshes), so
that coordinates and data carry float64 residuals.  Checks and their
tolerances:

* ``points_lo``, ``point_data_lo`` and ``acc_table`` are bit-identical;
  so are the df-plane rows' ids, counts, padding and g hi/lo words.  The
  c_loc pairs agree as float64 sums to 1e-14.  The int16 probe words and
  dscale are bit-identical to the port's own ``cand_table`` (both
  packers share one quantization) and agree with the JAX package's as
  ``tests/test_torch_build.py`` holds the candidate rows: XLA contracts
  the JAX packer's float32 sums into FMAs, so a word may move by one
  unit in a few slots and dscale by a few ulp (rtol 2e-6).
* The df32 operations match the JAX package's on random pairs, as
  hi + lo to 2^-44 relative.
* ``interpolate_at_acc`` on a grid carried over from the JAX package
  (its tables, bit for bit) gives the same cells and hi + lo within
  1e-13 times max(1, |value|) (the FMA-contracted JAX arithmetic,
  see test_torch_acc_kernel.py); on the port's own grids, linear data
  comes back within 1e-12 on the cold fused, warm and ``build_df=False``
  routes, and nonlinear data within 1e-12 of the float64 interpolant of
  the cell found, where the query lies inside that cell in float64.
* The mutation API keeps ``point_data_lo`` and ``acc_table`` in step as
  the JAX package does (bit-identical registries), and a repack clears
  ``cand_df_table`` (``tests/test_acc_fused.py:114``,
  ``tests/test_interp_acc.py:149``).
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import interpolate_unstructured_tpu as jiu  # noqa: E402
import interpolate_unstructured_tpu_torch as tiu  # noqa: E402
from interpolate_unstructured_tpu.ops import df32 as jdf  # noqa: E402
from interpolate_unstructured_tpu.ops import interp_acc as jacc  # noqa: E402
from interpolate_unstructured_tpu_torch.models import cand_table  # noqa: E402
from interpolate_unstructured_tpu_torch.ops import df32 as tdf  # noqa: E402
from interpolate_unstructured_tpu_torch.ops import (  # noqa: E402
    interp_acc as tacc,
)
from interpolate_unstructured_tpu_torch.ops import locate  # noqa: E402
from test_torch_acc_kernel import (  # noqa: E402
    MESHES,
    _split,
    _sum,
    carry,
    mesh_data,
    queries64,
)
from test_torch_build import _int16_halves  # noqa: E402

HOST = tiu.IUConfig(cand_build="host")


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Warm torch.sqrt on every intra-op thread first (PERF.md §7): the
    df32 triangle and quad weights take square roots."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


def _build_both(case, data=None, prepare=True):
    cell_type, pts, cells, nbrs, scale, data0 = mesh_data(case)
    data = data0 if data is None else data
    kw = dict(point_data=data, locate_mode="walk", coord_scale_factor=scale)
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jnp.float32,
                        config=jiu.IUConfig(**dataclasses.asdict(HOST)), **kw)
    tg = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                        config=HOST, device="cpu", **kw)
    if prepare:
        ug, tg = jacc.prepare_accurate(ug), tiu.prepare_accurate(tg)
    return ug, tg


def _lin_data(case):
    """Linear float64 data at the scaled float64 coordinates."""
    _, pts, _, _, scale, _ = mesh_data(case)
    p64 = np.asarray(pts, np.float64) * (1.0 if scale is None else scale)
    return {"lin": p64.sum(1) + 1.0}


@pytest.mark.parametrize("case", list(MESHES))
def test_residual_registries_and_acc_table_match_jax(case):
    ug, tg = _build_both(case)
    for f in ("points_lo", "point_data_lo", "acc_table"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(ug, f)), err_msg=f)
    assert np.abs(tg.points_lo.numpy()).max() > 0
    assert np.abs(tg.point_data_lo.numpy()).max() > 0
    assert tg.acc_table.shape[1] * 4 == 512


@pytest.mark.parametrize("case", ["triangle", "tetra"])
def test_cand_df_table_matches_jax(case):
    ug, tg = _build_both(case)
    assert tg.cand_df_table is not None and ug.cand_df_table is not None
    jt = np.asarray(ug.cand_df_table)[: tg.cand_df_table.shape[0]]
    tt = tg.cand_df_table.numpy()
    assert jt.shape == tt.shape
    ji, ti = jt.view(np.int32), tt.view(np.int32)
    nf = tg.n_faces_per_cell
    k, nv = tg.cand_ids.shape[1], tg.cand_nv
    head = (-(-3 * nf // 2) + -(-nf // 2)) * k
    # probe words: the port's own quantized rows, bit for bit ...
    ci = tg.cand_table.numpy().view(np.int32)
    np.testing.assert_array_equal(ti[:, :head], ci[:, :head])
    # ... and the JAX package's within one int16 unit in a few slots
    diff = np.abs(_int16_halves(ji[:, :head]) - _int16_halves(ti[:, :head]))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size
    planes = slice(head, head + 8 * nv * k)
    jp = jt[:, planes].reshape(-1, nv, 8, k)
    tp = tt[:, planes].reshape(-1, nv, 8, k)
    np.testing.assert_array_equal(tp[:, :, :6], jp[:, :, :6])  # g hi, g lo
    c_t = _sum(tp[:, :, 6], tp[:, :, 7])
    c_j = _sum(jp[:, :, 6], jp[:, :, 7])
    assert np.abs(c_t - c_j).max() <= 1e-14
    ccol = head + (8 * nv + 1) * k
    np.testing.assert_array_equal(ti[:, head + 8 * nv * k: ccol + 1],
                                  ji[:, head + 8 * nv * k: ccol + 1])  # ids, count
    np.testing.assert_array_equal(ti[:, ccol + 2:], ji[:, ccol + 2:])  # padding
    cq = cand_table.quantized(tg.cell_type, nv).per * k + 1
    np.testing.assert_array_equal(tt[:, ccol + 1], tg.cand_table.numpy()[:, cq])
    np.testing.assert_allclose(tt[:, ccol + 1], jt[:, ccol + 1], rtol=2e-6)


def _pairs(rng, n, positive=False, scale=1.0):
    x = rng.standard_normal(n) * scale
    if positive:
        x = np.abs(x) + 0.1
    x = x * (1.0 + rng.random(n) * 1e-9)  # bits below f32's mantissa
    return _split(x)


DF_OPS = {
    # name: (number of df arguments, positive inputs)
    "add": (2, False), "sub": (2, False), "mul": (2, False),
    "div": (2, False), "sqrt": (1, True), "dot3": (6, False),
    "cross": (6, False), "triple": (9, False),
}
ALL_OPS = list(DF_OPS) + ["two_sum", "quick_two_sum", "two_prod", "scale"]


@pytest.mark.parametrize("op", ALL_OPS)
def test_df32_op_matches_jax(op):
    rng = np.random.default_rng(ALL_OPS.index(op))
    n = 4096
    if op in DF_OPS:
        n_args, positive = DF_OPS[op]
        args = [_pairs(rng, n, positive) for _ in range(n_args)]
        t_out = getattr(tdf, op)(*[tuple(torch.from_numpy(a) for a in p)
                                   for p in args])
        j_out = getattr(jdf, op)(*[tuple(jnp.asarray(a) for a in p)
                                   for p in args])
    elif op == "scale":
        p = _pairs(rng, n)
        t_out = tdf.scale(tuple(torch.from_numpy(a) for a in p), -0.375)
        j_out = jdf.scale(tuple(jnp.asarray(a) for a in p),
                          jnp.float32(-0.375))
    else:
        a = rng.standard_normal(n).astype(np.float32)
        b = (rng.standard_normal(n) * 1e-3).astype(np.float32)
        t_out = getattr(tdf, op)(torch.from_numpy(a), torch.from_numpy(b))
        j_out = getattr(jdf, op)(jnp.asarray(a), jnp.asarray(b))
    if op not in ("cross",):
        t_out, j_out = [t_out], [j_out]
    for t, j in zip(t_out, j_out):
        tv, jv = _sum(t[0].numpy(), t[1].numpy()), _sum(j[0], j[1])
        scale = np.maximum(np.abs(jv), 1e-30)
        assert (np.abs(tv - jv) / scale).max() <= 2.0 ** -44


@pytest.mark.parametrize("case", list(MESHES))
def test_interpolate_at_acc_matches_jax_on_its_tables(case):
    ug, _ = _build_both(case, prepare=False)
    ug = jacc.prepare_accurate(ug)
    tg = carry(ug)
    r64 = queries64(case, 3000, 21, outside=0.05)
    jh, jl, jf, jic = jacc.interpolate_at_acc(ug, r64, (0,))
    th, tl, tf, tic = tiu.interpolate_at_acc(tg, torch.from_numpy(r64), (0,))
    np.testing.assert_array_equal(tic.numpy(), np.asarray(jic))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf[:2850].all() and not tf[2850:].any()
    got, ref = _sum(th, tl)[tf.numpy()], _sum(jh, jl)[np.asarray(jf)]
    assert np.abs(got - ref).max() <= 1e-13 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("case", list(MESHES))
def test_interpolate_at_acc_routes_reproduce_linear_data(case):
    _, tg = _build_both(case, data=_lin_data(case))
    simplex = case != "quad"
    assert (tg.cand_df_table is not None) == simplex
    r64 = queries64(case, 3000, 22)
    truth = r64.sum(1) + 1.0
    r = torch.from_numpy(r64)
    # cold: the fused df-plane probe on simplices, get_cell + B5 on quads
    vh, vl, found, ic = tiu.interpolate_at_acc(tg, r, (0,))
    assert bool(found.all())
    assert np.abs(_sum(vh[:, 0], vl[:, 0]) - truth).max() <= 1e-12
    if simplex:
        hi, lo = tacc.split_queries(r)
        fused = locate._candidates_query_df(tg, hi, (0,), r_lo=lo)
        assert torch.equal(fused[0], ic) and torch.equal(fused[2], vh)
    # warm: moved queries guessed by the cold cells (get_cell + B5)
    shift = np.array([0.003, 0.002, 0.001 if case == "tetra" else 0.0])
    r2 = torch.from_numpy(r64 + shift)
    vh2, vl2, found2, _ = tiu.interpolate_at_acc(tg, r2, (0,), guess=ic)
    assert bool(found2.all())
    assert np.abs(_sum(vh2[:, 0], vl2[:, 0])
                  - (truth + shift.sum())).max() <= 1e-12
    # build_df=False: get_cell + B5 answers the cold call too
    _, tg_nodf = _build_both(case, data=_lin_data(case), prepare=False)
    tg_nodf = tiu.prepare_accurate(tg_nodf, build_df=False)
    assert tg_nodf.acc_table is not None and tg_nodf.cand_df_table is None
    vh3, vl3, found3, _ = tiu.interpolate_at_acc(tg_nodf, r, (0,))
    assert bool(found3.all())
    assert np.abs(_sum(vh3[:, 0], vl3[:, 0]) - truth).max() <= 1e-12


@pytest.mark.parametrize("case", list(MESHES))
def test_nonlinear_values_match_f64_same_cells(case):
    _, tg = _build_both(case)
    cell_type, pts, cells, nbrs, scale, data = mesh_data(case)
    g64 = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jnp.float64,
                         point_data=data, locate_mode="walk",
                         coord_scale_factor=scale)
    r64 = queries64(case, 3000, 23)
    vh, vl, found, ic = tiu.interpolate_at_acc(tg, torch.from_numpy(r64), (0,))
    assert bool(found.all())
    ref = np.asarray(jiu.interpolate_at_icell(
        g64, jnp.asarray(r64), jnp.asarray([0]), jnp.asarray(ic.numpy())))
    inside = _inside_f64(g64, r64, ic)
    assert np.abs(_sum(vh, vl) - ref)[inside].max() <= 1e-12


def _inside_f64(g64, r64, ic):
    """Queries inside the float64 cell they were located in.  The f32
    locate may put a query within the quantization fuzz of a face into
    the neighbor; there the triangle's unsigned sub-areas (the float64
    formula) and the df planes' linear extension part ways."""
    inside = np.asarray(jiu.point_is_inside_cell(
        g64, jnp.asarray(r64), jnp.asarray(ic.numpy())))
    assert inside.mean() >= 0.99
    return inside


def test_float32_queries_and_explicit_residuals():
    _, tg = _build_both("tetra", data=_lin_data("tetra"))
    r64 = queries64("tetra", 500, 24)
    hi, lo = (torch.from_numpy(a) for a in _split(r64))
    a = tiu.interpolate_at_acc(tg, torch.from_numpy(r64), (0,))
    b = tiu.interpolate_at_acc(tg, hi, (0,), r_lo=lo)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # float32 queries alone: exact for the float32 positions
    vh, vl, found, _ = tiu.interpolate_at_acc(tg, hi, (0,))
    truth = hi.double().sum(1).numpy() + 1.0
    assert bool(found.all())
    assert np.abs(_sum(vh[:, 0], vl[:, 0]) - truth).max() <= 1e-12


def test_set_point_data_keeps_accurate_state_as_jax():
    """set_point_data refreshes point_data_lo and the column's acc_table
    slots as the JAX package does; the repack of a fused column clears
    the df-plane rows, and prepare_accurate rebuilds them against the
    new data (tests/test_acc_fused.py:114, tests/test_interp_acc.py:149)."""
    ug, tg = _build_both("tetra")
    pts64 = tg.points.double().numpy() + tg.points_lo.double().numpy()
    new = pts64.sum(1) + 2.0
    ug2, tg2 = jiu.set_point_data(ug, 0, new), tiu.set_point_data(tg, 0, new)
    for f in ("point_data", "point_data_lo", "acc_table"):
        np.testing.assert_array_equal(getattr(tg2, f).numpy(),
                                      np.asarray(getattr(ug2, f)), err_msg=f)
    assert tg2.cand_df_table is None and ug2.cand_df_table is None
    np.testing.assert_array_equal(tg2.acc_table.numpy(),
                                  tacc.build_acc_table(tg2).numpy())
    r64 = queries64("tetra", 2000, 25)
    truth = r64.sum(1) + 2.0
    # meanwhile the at-known-cell route answers with the new values
    vh, vl, found, _ = tiu.interpolate_at_acc(tg2, torch.from_numpy(r64), (0,))
    assert bool(found.all())
    assert np.abs(_sum(vh[:, 0], vl[:, 0]) - truth).max() <= 1e-12
    tg3 = tiu.prepare_accurate(tg2)
    assert tg3.cand_df_table is not None and tg3.acc_table is tg2.acc_table
    vh, vl, found, _ = tiu.interpolate_at_acc(tg3, torch.from_numpy(r64), (0,))
    assert np.abs(_sum(vh[:, 0], vl[:, 0]) - truth).max() <= 1e-12
    # a scalar broadcasts, with the exact float64 remainder of 0.1
    tg4 = tiu.set_point_data(tg, 0, 0.1)
    lo = tg4.point_data_lo[:, 0].double().numpy()
    np.testing.assert_allclose(lo + np.float64(np.float32(0.1)), 0.1,
                               atol=1e-16)


def test_add_point_data_keeps_accurate_state_as_jax():
    ug, tg = _build_both("triangle")
    rng = np.random.default_rng(26)
    rough = rng.standard_normal(tg.n_points)
    ug2, ju = jiu.add_point_data(ug, "rough", rough)
    tg2, tu = tiu.add_point_data(tg, "rough", rough)
    assert tu == ju == 1
    for f in ("point_data", "point_data_lo", "acc_table"):
        np.testing.assert_array_equal(getattr(tg2, f).numpy(),
                                      np.asarray(getattr(ug2, f)), err_msg=f)
    # float32 values carry no residual; fuse=False keeps the df rows
    tg3, _ = tiu.add_point_data(tg, "f32", rough.astype(np.float32),
                                fuse=False)
    assert not tg3.point_data_lo[:, 1].any()
    assert tg3.cand_df_table is tg.cand_df_table
    r64 = queries64("triangle", 500, 27)
    vh, vl, found, ic = tiu.interpolate_at_acc(tg2, torch.from_numpy(r64),
                                               (tu,))
    cell_type, pts, cells, nbrs, scale, data = mesh_data("triangle")
    g64 = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jnp.float64,
                         point_data={**data, "rough": rough},
                         locate_mode="walk", coord_scale_factor=scale)
    ref = np.asarray(jiu.interpolate_at_icell(
        g64, jnp.asarray(r64), jnp.asarray([1]), jnp.asarray(ic.numpy())))
    assert bool(found.all())
    inside = _inside_f64(g64, r64, ic)
    assert np.abs(_sum(vh, vl) - ref)[inside].max() <= 1e-12


def test_accurate_calls_check_their_arguments():
    _, tg = _build_both("triangle", prepare=False)
    r = torch.tensor([[0.3 * np.pi, 0.3 * np.pi, 0.0]], dtype=torch.float64)
    with pytest.raises(ValueError, match="prepare_accurate"):
        tiu.interpolate_at_acc(tg, r, (0,))
    tg = tiu.prepare_accurate(tg, build_df=False)
    tg, iv = tiu.add_point_data(tg, "two", np.full(tg.n_points, 2.0))
    nv = tg.n_point_data
    a = tiu.interpolate_at_acc(tg, r, (iv,))
    b = tiu.interpolate_at_acc(tg, r, (iv - nv,))  # python-style wrap
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert float(a[0][0, 0]) == 2.0
    for bad in (nv, -nv - 1):
        with pytest.raises(ValueError, match="point-data range"):
            tiu.interpolate_at_acc(tg, r, (bad,))
    g64 = tiu.build_grid(*mesh_data("triangle")[1:4], "triangle",
                         dtype=torch.float64, device="cpu")
    assert g64.points_lo is None
    with pytest.raises(ValueError, match="prepare_accurate"):
        tiu.interpolate_at_icell_acc(tiu.prepare_accurate(g64), r.float(),
                                     (0,), torch.zeros(1, dtype=torch.int32))
