"""Kernels B5 (df32 interpolation at known cells) and B2-df (the df-plane
candidate probe, in bin order from the queries as given) against the JAX
package.

The JAX package builds float32 walk grids with candidate tables
(``cand_build="host"``), prepares them for accurate mode, and its Pallas
kernels run in interpret mode (``pallas_acc.interp_acc_rows``,
``pallas_cand.cand_rows_query(..., df_planes=True)``), driven as
``tests/test_interp_acc.py`` and ``tests/test_pallas_cand.py`` drive
them.  The same tables are carried into the port with
``grid_from_numpy``, and the port's plain versions run on the same rows
and queries.  Meshes: the 7x7x7 tet box with the nonlinear data of
``tests/test_acc_fused.py``, and 12x10 triangle and quad rectangles
scaled by pi, so that coordinates and data need their float64 residuals.

Tolerances:

* B5: hi + lo (summed in float64) within 1e-13 of the Pallas kernel's and
  of the JAX package's ``interpolate_at_icell_acc``: XLA on the CPU
  contracts the JAX package's float32 products into FMAs, which moves
  the lo words by a few units of 2^-48 of the value (1.1e-14 seen), and
  within 1e-12 of the float64 interpolant of the same cell (the bound of
  ``tests/test_interp_acc.py:62``).
* B2-df: ``aux`` identical, ``id_best`` identical except for misses
  whose two best margins lie within 4 eps (B2's rule,
  ``tests/test_torch_cand_kernel.py``), values of found queries within
  1e-13 times max(1, |value|) as hi + lo: the
  FMA-contracted df32 plane evaluation of the JAX package differs by up
  to ~4e-14 relative (2.3e-13 seen on the scaled triangle mesh, whose
  values reach 6.3).  The whole cold query (split, bin, local frame,
  probe) against the JAX package's ``_candidates_query_df``: cells and
  found masks identical, values within the same bound; float64 queries
  and the same queries as a hi/lo pair give identical results.

The CUDA kernels are held against the plain versions where a card exists
(bit for bit: the kernels are built with ``--fmad=false``, and their one
FMA, in the df32 product, gives the bits of the plain Dekker product;
``tests/test_torch_fma_form.py``), B5 also on meshes scaled by 1e-6 and
1e3 with two variables in reverse order; those tests
use the port alone, so that on a machine without jax they run with
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
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
from interpolate_unstructured_tpu_torch.ops import (
    acc_kernel,
    cand_kernel,
    geometry,
    interp_acc,
    locate,
)
from interpolate_unstructured_tpu_torch.utils import meshgen

HOST = tiu.IUConfig(cand_build="host")
MESHES = {
    # cell type, mesh, coordinate scale
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(12, 10), np.pi),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(12, 10), np.pi),
    "tetra": ("tetra", lambda: meshgen.tet_box_mesh(7, 7, 7), None),
}
DF_MESHES = ("triangle", "tetra")  # the df-plane rows are simplex-only


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests:
    on some virtualized hosts the first float32 torch.sqrt a worker
    thread runs in a process is off by ~1e-4 relative (PERF.md §7), and
    the df32 triangle and quad weights take square roots."""
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
    from interpolate_unstructured_tpu.ops import interp_acc as jacc
    from interpolate_unstructured_tpu.ops import locate as jlocate
    from interpolate_unstructured_tpu.ops import pallas_acc, pallas_cand

    return jnp, jiu, jacc, jlocate, pallas_acc, pallas_cand


def carry(ug, device="cpu"):
    """The JAX grid's state as a port grid (bit-identical tables)."""
    leaves = {
        f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
        for f in DATA_FIELDS
    }
    return tiu.grid_from_numpy(
        leaves, {f: getattr(ug, f) for f in META_FIELDS}, device
    )


def mesh_data(case):
    """(cell_type, points, cells, neighbors, scale, point_data): the
    nonlinear float64 data of tests/test_acc_fused.py at the scaled
    coordinates."""
    cell_type, mesh, scale = MESHES[case]
    pts, cells, nbrs = mesh()
    p64 = np.asarray(pts, np.float64) * (1.0 if scale is None else scale)
    rng = np.random.default_rng(9)
    data = {"D0": np.sin(3 * p64[:, 0]) * p64[:, 1]
            + rng.random(len(p64)) * 1e-3}
    return cell_type, pts, cells, nbrs, scale, data


def queries64(case, n, seed, outside=0.0):
    """(n, 3) float64 queries inside the mesh's domain, the last
    ``outside`` share pushed out of it along x."""
    cell_type, _, scale = MESHES[case]
    s = 1.0 if scale is None else scale
    hi = np.array([2.0 * s, 2.0 * s, 0.0]) if cell_type != "tetra" else np.ones(3)
    rng = np.random.default_rng(seed)
    r = 0.02 * hi + rng.random((n, 3)) * 0.96 * hi
    n_out = int(n * outside)
    if n_out:
        r[n - n_out:, 0] = hi[0] * (1.05 + rng.random(n_out))
    return r


def _jax_grids(case):
    jnp, jiu, jacc, *_ = _jax()
    cell_type, pts, cells, nbrs, scale, data = mesh_data(case)
    kw = dict(point_data=data, locate_mode="walk", coord_scale_factor=scale,
              config=jiu.IUConfig(**dataclasses.asdict(HOST)))
    g32 = jacc.prepare_accurate(
        jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jnp.float32, **kw))
    g64 = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jnp.float64, **kw)
    return g32, g64


def _split(r64):
    hi = r64.astype(np.float32)
    return hi, (r64 - hi.astype(np.float64)).astype(np.float32)


def _sum(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


@pytest.mark.parametrize("case", list(MESHES))
def test_b5_plain_matches_pallas_and_f64(case):
    jnp, jiu, jacc, jlocate, pallas_acc, _ = _jax()
    ug, g64 = _jax_grids(case)
    tg = carry(ug)
    r64 = queries64(case, 3000, 11)
    r_hi, r_lo = _split(r64)
    ic, found = jlocate.get_cell(ug, jnp.asarray(r_hi))
    assert bool(np.asarray(found).all())
    ic = np.maximum(np.asarray(ic), 0).astype(np.int32)

    th, tl = acc_kernel.interp_acc_plain(
        tg.acc_table, torch.from_numpy(ic), torch.from_numpy(r_hi),
        torch.from_numpy(r_lo), tg.cell_type, tg.n_points_per_cell,
        tg.n_point_data, (0,),
    )
    got = _sum(th[:, 0], tl[:, 0])
    ph, pl = pallas_acc.interp_acc_rows(
        ug.acc_table[jnp.asarray(ic)], jnp.asarray(r_hi).T,
        jnp.asarray(r_lo).T, cell_type=ug.cell_type,
        npc=ug.n_points_per_cell, nv=ug.n_point_data, i_vars=(0,),
        interpret=True,
    )
    assert np.abs(got - _sum(ph[0], pl[0])).max() <= 1e-13
    jh, jl = jacc.interpolate_at_icell_acc(
        ug, jnp.asarray(r_hi), (0,), jnp.asarray(ic), jnp.asarray(r_lo))
    assert np.abs(got - _sum(jh[:, 0], jl[:, 0])).max() <= 1e-13
    truth = np.asarray(jiu.interpolate_at_icell(
        g64, jnp.asarray(r64), jnp.asarray([0]), jnp.asarray(ic)))[:, 0]
    assert np.abs(got - truth).max() <= 1e-12
    assert np.abs(_sum(ph[0], pl[0]) - truth).max() <= 1e-12


def _jax_df_probe(ug, r64):
    """The JAX package's df-plane probe inputs and its Pallas kernel's
    outputs (interpret mode)."""
    jnp, _, _, jlocate, _, pallas_cand = _jax()
    from interpolate_unstructured_tpu.models.grid import (
        _qdf_floats_per,
        cand_fused_nv,
    )

    r_hi, r_lo = _split(r64)
    rt_hi, rt_lo = jnp.asarray(r_hi).T, jnp.asarray(r_lo).T
    ijk = jlocate._cand_bin_ijk_t(ug, rt_hi)
    idx = jlocate._cand_bin_flat(ug, ijk)
    rq6 = jlocate._cand_local_df_t(ug, rt_hi, rt_lo, ijk)
    k = ug.cand_ids.shape[1]
    nv = cand_fused_nv(ug)
    out = pallas_cand.cand_rows_query(
        ug, ug.cand_df_table, idx, rq6, (0,),
        k * _qdf_floats_per(ug.cell_type, nv),
        ug.config.eps_inside + ug.cand_qeps, k, k_max=k, interpret=True,
        quantized=True, nv_fused=nv, df_planes=True,
    )
    return np.array(idx, np.int32), np.asarray(rq6).T.copy(), out


def _cand_ijk(g, r):
    """Integer candidate-bin coordinates of the (B, 3) queries ``r``."""
    return geometry.bin_ijk(r, g.cand_rmin, g.cand_inv_h, g.cand_shape,
                            torch.int32)


@pytest.mark.parametrize("case", DF_MESHES)
def test_df_probe_inputs_match_jax(case):
    ug, _ = _jax_grids(case)
    tg = carry(ug)
    r64 = queries64(case, 2000, 12, outside=0.1)
    idx, rq6, _ = _jax_df_probe(ug, r64)
    r_hi, r_lo = (torch.from_numpy(a) for a in _split(r64))
    ijk = _cand_ijk(tg, r_hi)
    assert np.array_equal(geometry.bin_flat(ijk, tg.cand_shape).numpy(), idx)
    hi, lo = cand_kernel.local_frame_df(r_hi, r_lo, tg.cand_rmin,
                                        tg.cand_inv_h, ijk)
    # hi is the quantized probe's r_local, bit for bit
    np.testing.assert_array_equal(hi.numpy(), rq6[:, :3])
    np.testing.assert_array_equal(hi.numpy(), geometry.cand_local_frame(
        r_hi, tg.cand_rmin, tg.cand_inv_h, ijk).numpy())
    np.testing.assert_array_equal(lo.numpy(), rq6[:, 3:])


@pytest.mark.parametrize("case", DF_MESHES)
def test_b2df_plain_matches_pallas_interpret(case):
    ug, _ = _jax_grids(case)
    tg = carry(ug)
    r64 = queries64(case, 3000, 13, outside=0.1)
    idx, rq6, (jid, jaux, jvals) = _jax_df_probe(ug, r64)
    lay = cand_table.df_layout(tg, (0,))
    eps = cand_table.probe_eps(tg)
    tid, taux, th, tl = cand_kernel.probe_rows_df_plain(
        tg.cand_df_table, torch.from_numpy(idx),
        torch.from_numpy(rq6[:, :3].copy()), torch.from_numpy(rq6[:, 3:].copy()),
        lay, eps, lay.k, chunk=1024,
    )
    jid, jaux, jvals = (np.asarray(x) for x in (jid, jaux, jvals))
    taux, tid = taux.numpy(), tid.numpy()
    np.testing.assert_array_equal(taux, jaux)
    assert (taux == -2).any() and (taux == -1).any()
    differ = np.flatnonzero(tid != jid)
    if len(differ):
        assert (taux[differ] != -2).all()
        g = cand_kernel._gather_rows(tg.cand_df_table,
                                     torch.from_numpy(idx[differ]))
        _, m = cand_kernel._margins_plain(
            g, torch.from_numpy(rq6[differ, :3].copy()), lay)
        top2 = torch.topk(m, 2, dim=1).values
        assert ((top2[:, 0] - top2[:, 1]) <= 4 * eps).all()
    f = taux == -2
    got = _sum(th[:, 0], tl[:, 0])[f]
    scale = max(1.0, np.abs(got).max())
    assert np.abs(got - _sum(jvals[0], jvals[1])[f]).max() <= 1e-13 * scale


def _cuda_grid(case, dev):
    cell_type, pts, cells, nbrs, scale, data = mesh_data(case)
    g = tiu.build_grid(pts, cells, nbrs, cell_type, point_data=data,
                       dtype=torch.float32, locate_mode="walk",
                       coord_scale_factor=scale, config=HOST, device=dev)
    return interp_acc.prepare_accurate(g)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MESHES))
def test_cuda_b5_matches_plain(cuda, case):
    g = _cuda_grid(case, cuda)
    r_hi, r_lo = (torch.from_numpy(a).to(cuda)
                  for a in _split(queries64(case, 200_000, 14)))
    ic, _ = tiu.get_cell(g, r_hi)
    ic = ic.clamp_min(0)
    args = (g.acc_table, ic, r_hi, r_lo, g.cell_type, g.n_points_per_cell,
            g.n_point_data, (0,))
    before = acc_kernel.launches
    kh, kl = acc_kernel.interp_acc(*args)
    torch.cuda.synchronize()
    assert acc_kernel.launches == before + 1
    ph, pl = acc_kernel.interp_acc_plain(*args)
    assert torch.equal(kh, ph) and torch.equal(kl, pl)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1e-6, 1e3])
@pytest.mark.parametrize("case", list(MESHES))
def test_cuda_b5_scaled_meshes(cuda, case, scale):
    """B5 on the meshes scaled by 1e-6 and 1e3 (coordinates, cell sizes
    and products far from 1), with nv = 2 and the slots in reverse,
    bit for bit against the plain version."""
    cell_type, mesh, s0 = MESHES[case]
    pts, cells, nbrs = mesh()
    s = scale * (1.0 if s0 is None else s0)
    p64 = np.asarray(pts, np.float64) * s
    data = {"D0": np.sin(3 * p64[:, 0] / s) * p64[:, 1],
            "D1": np.cos(2 * p64[:, 1] / s) + 7.0 * p64[:, 0]}
    g = interp_acc.prepare_accurate(tiu.build_grid(
        pts, cells, nbrs, cell_type, point_data=data, dtype=torch.float32,
        locate_mode="walk", coord_scale_factor=s, config=HOST, device=cuda),
        build_df=False)
    assert g.n_point_data == 2
    rng = np.random.default_rng(18)
    ic = rng.integers(0, len(cells), 100_000)
    w = rng.random((len(ic), cells.shape[1])) + 0.05
    w /= w.sum(1, keepdims=True)
    r64 = np.einsum("nk,nkd->nd", w, p64[cells[ic]])
    r_hi, r_lo = (torch.from_numpy(a).to(cuda) for a in _split(r64))
    ic = torch.from_numpy(ic.astype(np.int32)).to(cuda)
    for slots in ((1, 0), (0,), (1,)):
        args = (g.acc_table, ic, r_hi, r_lo, g.cell_type,
                g.n_points_per_cell, g.n_point_data, slots)
        kh, kl = acc_kernel.interp_acc_cuda(*args)
        ph, pl = acc_kernel.interp_acc_plain(*args)
        assert torch.equal(kh, ph) and torch.equal(kl, pl)
        assert bool((kl != 0).any())


@pytest.mark.parametrize("kind", ["float64", "pair"])
@pytest.mark.parametrize("case", DF_MESHES)
def test_df_query_plain_matches_jax(case, kind):
    """The plain df route (split, bin, hi/lo local frame, probe) against
    the JAX package's _candidates_query_df on the same tables, from
    float64 queries and from their hi/lo pair (nonzero lo)."""
    jnp, _, _, jlocate, _, _ = _jax()
    ug, _ = _jax_grids(case)
    tg = carry(ug)
    r64 = queries64(case, 3000, 17, outside=0.1)
    r_hi, r_lo = _split(r64)
    assert (r_lo != 0).any()
    jic, jfound, jh, jl = (np.asarray(x) for x in jlocate._candidates_query_df(
        ug, jnp.asarray(r_hi), (0,), r_lo=jnp.asarray(r_lo)))
    ic, found, vh, vl = locate._candidates_query_df(
        tg, torch.from_numpy(r64), (0,))
    if kind == "pair":
        pair = locate._candidates_query_df(
            tg, torch.from_numpy(r_hi), (0,), r_lo=torch.from_numpy(r_lo))
        for a, b in zip(pair, (ic, found, vh, vl)):
            assert torch.equal(a, b)
    np.testing.assert_array_equal(ic.numpy(), jic)
    np.testing.assert_array_equal(found.numpy(), jfound)
    assert found.numpy().any() and not found.numpy().all()
    got = _sum(vh[:, 0], vl[:, 0])[jfound]
    scale = max(1.0, np.abs(got).max())
    assert np.abs(got - _sum(jh[0], jl[0])[jfound]).max() <= 1e-13 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", DF_MESHES)
def test_cuda_b2df_matches_plain(cuda, case):
    """The bin-ordered df pipeline against its plain version, bit for
    bit, from float64 queries and from their hi/lo pair."""
    g = _cuda_grid(case, cuda)
    assert g.cand_df_table is not None
    r64 = torch.from_numpy(queries64(case, 200_000, 15, outside=0.05)).to(cuda)
    r_hi, r_lo = (torch.from_numpy(a).to(cuda)
                  for a in _split(r64.cpu().numpy()))
    lay = cand_table.df_layout(g, (0,))
    bins = (g.cand_rmin, g.cand_inv_h, g.cand_shape)
    eps = cand_table.probe_eps(g)
    want = cand_kernel.cand_rows_df_plain(g.cand_df_table, r64, None, *bins,
                                          lay, eps, lay.k, 8192)
    for r, lo in ((r64, None), (r_hi, r_lo)):
        cand_kernel.df_launches = cand_kernel.bin_pass_launches = 0
        cand_kernel.bin_unsort_launches = 0
        got = cand_kernel.cand_rows_df_query(g.cand_df_table, r, lo, *bins,
                                             lay, eps, lay.k, 8192)
        torch.cuda.synchronize()
        assert cand_kernel.df_launches == cand_kernel.bin_pass_launches == 1
        assert cand_kernel.bin_unsort_launches == 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        order = cand_kernel.bin_order_cuda(
            r, *bins, cand_kernel.out_words(lay, g.cand_df_table), df=True,
            r_lo=lo)
        idx = cand_kernel.probe_inputs_df_plain(r, lo, *bins)[0]
        assert cand_kernel.order_mismatches(
            order, idx, cand_kernel.order_records_plain(r, True, lo)) == 0
        for lanes in (1, 2, 4, 32):
            k = cand_kernel.cand_rows_binned_cuda(
                g.cand_df_table, order, *bins, lay, eps, lay.k, lanes=lanes)
            n = len(lay.var_roles)
            for a, b in zip((k[0], k[1], k[2][:, :n], k[2][:, n:]), want):
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_accurate_calls_launch_the_kernels(cuda):
    g = _cuda_grid("tetra", cuda)
    r64 = torch.from_numpy(queries64("tetra", 100_000, 16)).to(cuda)
    for name in ("df_launches", "bin_pass_launches", "bin_scatter_launches",
                 "bin_unsort_launches", "binned_launches", "ext_launches"):
        setattr(cand_kernel, name, 0)
    acc_kernel.launches = 0
    vh, vl, found, ic = tiu.interpolate_at_acc(g, r64, (0,))
    assert cand_kernel.df_launches == 1 and acc_kernel.launches == 0
    assert (cand_kernel.bin_pass_launches == cand_kernel.bin_scatter_launches
            == cand_kernel.bin_unsort_launches == 1)
    assert cand_kernel.binned_launches == cand_kernel.ext_launches == 0
    assert bool(found.all())
    r_hi, r_lo = interp_acc.split_queries(r64)
    pair = tiu.interpolate_at_acc(g, r_hi, (0,), r_lo=r_lo)
    for a, b in zip(pair, (vh, vl, found, ic)):
        assert torch.equal(a, b)
    vh2, vl2, found2, _ = tiu.interpolate_at_acc(g, r64, (0,), guess=ic)
    assert acc_kernel.launches == 1 and bool(found2.all())
    err = (vh.double() + vl.double() - (vh2.double() + vl2.double())).abs()
    assert float(err.max()) <= 1e-12
