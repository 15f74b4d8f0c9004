"""The port's multi-device sharding against its single-device calls and
against the JAX package's sharded functions.

The six scenarios of ``tests/test_sharding.py`` on ``meshgen`` meshes,
on a mesh of 8 ``cpu`` entries (the JAX side runs on its 8 virtual CPU
devices): brute-force and walk interpolation; a trace, with a prebuilt
table reused; ``distribute_queries`` / ``collect_results`` of 203
queries; accurate mode; the cell-data lookups, cold and warm.  Also
each shard as its own single-device batch on a walk grid, ``Grid.to``
and the wrappers' streams.

Tolerances.  Against the port's single-device call: every result
identical, bit for bit (NaN where the fill puts it).  Against the JAX
package's sharded functions, the port's slice tests' tolerances: found
masks, cell ids, step counts, boundary codes and cell-data lookups
identical; float64 values within 1e-13 (``tests/test_torch_slice.py``)
and float64 curves within 1e-9 (the tracer's float64 gate,
``tests/test_torch_trace.py``); accurate mode on the JAX package's own
tables (carried with ``grid_from_numpy``), hi + lo within 1e-13 times
max(1, |value|) (``tests/test_torch_acc.py``).
"""

import dataclasses
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models.grid import (
    DATA_FIELDS,
    META_FIELDS,
)
from interpolate_unstructured_tpu_torch.parallel import sharding as ps
from interpolate_unstructured_tpu_torch.utils import meshgen

HOST = tiu.IUConfig(cand_build="host")
N_DEV = 8
TRACE_KW = dict(nvar=0, min_dx=1e-5, max_dx=0.1, max_steps=64, rtol=1e-3,
                atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Warm torch.sqrt on every intra-op thread first (PERF.md §7): the
    plain triangle and quad weights take square roots."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mesh():
    return ps.make_mesh(["cpu"] * N_DEV)


def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu
    from interpolate_unstructured_tpu.parallel import sharding as jps

    assert len(jax.devices()) == N_DEV, "conftest provides 8 CPU devices"
    return jnp, jiu, jps, jps.make_mesh()


def _build_both(cell_type, mesh_arrays, point_data, dtype=torch.float64,
                **kw):
    """(JAX grid, port grid) built natively from the same arrays."""
    jnp, jiu, _, _ = _jax()
    pts, cells, nbrs = mesh_arrays
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jdt,
                        point_data=point_data,
                        config=jiu.IUConfig(**dataclasses.asdict(HOST)), **kw)
    tg = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=dtype,
                        point_data=point_data, config=HOST, device="cpu", **kw)
    return ug, tg


def _queries(rng, tg, n):
    """Uniform in the grid's bounding box (test_triangle.f90:33-37)."""
    lo, hi = tg.rmin.numpy().astype(np.float64), tg.rmax.numpy()
    return lo + rng.random((n, 3)) * (hi - lo)


def _same(got, want):
    """Bit-for-bit equality of a collected result and a tensor."""
    got = torch.from_numpy(np.ascontiguousarray(got))
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.is_floating_point:
        it = {4: torch.int32, 8: torch.int64}[got.element_size()]
        got, want = got.view(it), want.view(it)
    assert torch.equal(got, want)


def _check_sharded(out, mesh):
    for x in out:
        assert isinstance(x, ps.Sharded) and len(x.shards) == len(mesh)
        assert all(s.device == d for s, d in zip(x.shards, mesh))


def test_make_mesh_and_shard_batch(mesh):
    assert mesh == [torch.device("cpu")] * N_DEV
    x = torch.arange(13 * 3, dtype=torch.float64).reshape(13, 3)
    sh, b = ps.shard_batch(x, mesh)
    assert b == 13 and sh.shape == (16, 3)
    assert [s.shape[0] for s in sh.shards] == [2] * N_DEV
    full = torch.cat(sh.shards)
    assert torch.equal(full[:13], x) and torch.equal(full[13:], x[[-1] * 3])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ps.make_mesh()
    with pytest.raises(ValueError, match="does not split"):
        ps.sharded_get_cell(mesh)(None, x, None)


def test_sharded_interpolate_matches_local(mesh):
    jnp, jiu, jps, jmesh = _jax()
    pts, cells, nbrs = meshgen.triangle_rect_mesh(2, 2)
    ug, tg = _build_both("triangle", (pts, cells, nbrs),
                         {"Polynomial": pts.sum(1) + 1.0})
    assert tg.locate_mode == "bruteforce"
    grid = ps.replicate_grid(tg, mesh)
    assert list(grid) == [torch.device("cpu")] and grid[mesh[0]] is tg
    r = _queries(np.random.default_rng(10), tg, 256)
    r_sh, b = ps.shard_batch(torch.from_numpy(r), mesh)
    guess = torch.full((r_sh.shape[0],), -1, dtype=torch.int32)
    out = ps.sharded_interpolate_at(mesh)(grid, r_sh, torch.tensor([0]),
                                          guess)
    _check_sharded(out, mesh)
    local = tiu.interpolate_at(tg, torch.from_numpy(r), [0])
    for x, want in zip(out, local):
        _same(ps.collect_results(x, b), want)
    assert bool(local[2].all())

    jr_sh, jb = jps.shard_batch(jnp.asarray(r), jmesh)
    jv, jic, jf = jps.sharded_interpolate_at(jmesh)(
        jps.replicate_grid(ug, jmesh), jr_sh, jnp.asarray([0]),
        jnp.full(jr_sh.shape[0], -1, dtype=jnp.int32))
    np.testing.assert_array_equal(ps.collect_results(out[1], b),
                                  np.asarray(jic)[:jb])
    np.testing.assert_array_equal(ps.collect_results(out[2], b),
                                  np.asarray(jf)[:jb])
    np.testing.assert_allclose(ps.collect_results(out[0], b),
                               np.asarray(jv)[:jb], rtol=0, atol=1e-13)


def test_sharded_interpolate_walk_mode(mesh):
    jnp, jiu, jps, jmesh = _jax()
    pts, cells, nbrs = meshgen.tet_box_mesh(6, 6, 6)
    data = {"Polynomial": np.zeros(len(pts))}
    ug, tg = _build_both("tetra", (pts, cells, nbrs), data,
                         locate_mode="walk")
    exact = pts.sum(1) + 1
    ug = jiu.set_point_data(ug, 0, exact)
    tg = tiu.set_point_data(tg, 0, exact)
    r = _queries(np.random.default_rng(11), tg, 128)
    r_sh, b = ps.shard_batch(r, mesh)
    vals, ic, found = ps.sharded_interpolate_at(mesh)(
        ps.replicate_grid(tg, mesh), r_sh, [0])
    v = ps.collect_results(vals, b)
    assert bool(ps.collect_results(found, b).all())
    np.testing.assert_allclose(v[:, 0], r.sum(1) + 1, rtol=0, atol=1e-13)
    for x, want in zip((vals, ic, found),
                       tiu.interpolate_at(tg, torch.from_numpy(r), [0])):
        _same(ps.collect_results(x, b), want)

    jr_sh, _ = jps.shard_batch(jnp.asarray(r), jmesh)
    jv, jic, jf = jps.sharded_interpolate_at(jmesh)(
        jps.replicate_grid(ug, jmesh), jr_sh, jnp.asarray([0]))
    np.testing.assert_array_equal(ps.collect_results(ic, b),
                                  np.asarray(jic)[:b])
    np.testing.assert_allclose(v, np.asarray(jv)[:b], rtol=0, atol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sharded_trace(mesh, dtype):
    """float64 takes the generic path (held against the JAX package too),
    float32 the fused loop (B4's plain version here)."""
    jnp, jiu, jps, jmesh = _jax()
    pts, cells, nbrs = meshgen.triangle_rect_mesh(9, 8)
    field = {"vx": -pts[:, 1], "vy": pts[:, 0]}
    ug, tg = _build_both("triangle", (pts, cells, nbrs), field, dtype=dtype)
    grid = ps.replicate_grid(tg, mesh)
    y0 = np.stack([np.full(8, 1.5), np.linspace(0.05, 0.4, 8)], axis=1)
    y0_sh, b = ps.shard_batch(torch.from_numpy(y0), mesh)
    tracer = ps.sharded_trace(mesh, **TRACE_KW)
    res = tracer(grid, y0_sh, [0, 1])
    _check_sharded(res[:5], mesh)
    assert res.y.shape == (8, 64, 2)
    n = ps.collect_results(res.n_steps, b)
    assert (n >= 1).all()
    y = ps.collect_results(res.y, b)
    for i in range(b):  # circular traces keep their radius
        m = min(int(n[i]), 64)
        np.testing.assert_allclose(np.linalg.norm(y[i, :m], axis=1),
                                   np.linalg.norm(y0[i]), atol=6e-3)
    local = tiu.integrate_along_field(tg, torch.from_numpy(y0), [0, 1],
                                      **TRACE_KW)
    for x, want in zip(res[:5], local[:5]):
        _same(ps.collect_results(x, b), want)
    # n_rounds totals the shards' (one line each here)
    shard_rounds = [
        int(tiu.integrate_along_field(tg, s, [0, 1], **TRACE_KW).n_rounds)
        for s in y0_sh.shards]
    assert int(res.n_rounds) == sum(shard_rounds)
    assert (int(res.n_rounds) > 0) == (dtype == torch.float32)

    # a prebuilt table reused: identical results
    tt = tiu.build_trace_table(tg, [0, 1])
    res2 = tracer(grid, y0_sh, [0, 1], trace_table=tt)
    for x, x2 in zip(res[:5], res2[:5]):
        _same(ps.collect_results(x2), torch.cat(x.shards))

    if dtype == torch.float64:
        jres = jps.sharded_trace(jmesh, **TRACE_KW)(
            jps.replicate_grid(ug, jmesh), jps.shard_batch(
                jnp.asarray(y0), jmesh)[0], jnp.asarray([0, 1]))
        np.testing.assert_array_equal(n, np.asarray(jres.n_steps)[:b])
        np.testing.assert_array_equal(
            ps.collect_results(res.boundary_material, b),
            np.asarray(jres.boundary_material)[:b])
        for i in range(b):
            m = min(int(n[i]), 64)
            np.testing.assert_allclose(y[i, :m], np.asarray(jres.y)[i, :m],
                                       rtol=0, atol=1e-9)


def test_distribute_and_collect_roundtrip(mesh):
    jnp, jiu, jps, jmesh = _jax()
    pts, cells, nbrs = meshgen.triangle_rect_mesh(24, 24)
    ug, tg = _build_both("triangle", (pts, cells, nbrs),
                         {"Polynomial": pts.sum(1) + 1.0})
    assert tg.locate_mode == "walk"
    r = _queries(np.random.default_rng(12), tg, 203)  # not a multiple of 8
    r_sh, local_b = ps.distribute_queries(r, mesh)
    assert local_b == 203 and r_sh.shape == (208, 3)
    vals, ic, found = ps.sharded_interpolate_at(mesh)(
        ps.replicate_grid(tg, mesh), r_sh, [0])
    out = ps.collect_results(vals, local_b)
    assert out.shape == (203, 1)
    np.testing.assert_allclose(out[:, 0], r.sum(1) + 1, rtol=0, atol=1e-13)
    assert bool(ps.collect_results(found, local_b).all())
    local = tiu.interpolate_at(tg, torch.from_numpy(r), [0])
    for x, want in zip((vals, ic, found), local):
        _same(ps.collect_results(x, local_b), want)

    jr_sh, jb = jps.distribute_queries(r, jmesh)
    jv, jic, _ = jps.sharded_interpolate_at(jmesh)(
        jps.replicate_grid(ug, jmesh), jr_sh, jnp.asarray([0]))
    np.testing.assert_array_equal(ps.collect_results(ic, local_b),
                                  jps.collect_results(jic, jb))
    np.testing.assert_allclose(out, jps.collect_results(jv, jb), rtol=0,
                               atol=1e-13)


def _hi_lo(vh, vl):
    return vh.astype(np.float64) + vl.astype(np.float64)


def test_sharded_accurate_matches_local(mesh):
    jnp, jiu, jps, jmesh = _jax()
    from interpolate_unstructured_tpu.ops import interp_acc as jacc

    pts, cells, nbrs = meshgen.tet_box_mesh(5, 5, 5)
    data = {"P": np.sin(pts).sum(1)}
    ug, tg = _build_both("tetra", (pts, cells, nbrs), data,
                         dtype=torch.float32, locate_mode="walk")
    tg = tiu.prepare_accurate(tg)
    assert tg.cand_df_table is not None
    rng = np.random.default_rng(12)
    r = torch.from_numpy(0.05 + rng.random((256, 3)) * 0.9).float()
    r_sh, b = ps.shard_batch(r, mesh)
    f = ps.sharded_interpolate_at_acc(mesh)
    out = f(ps.replicate_grid(tg, mesh), r_sh, [0])
    _check_sharded(out, mesh)
    for x, want in zip(out, tiu.interpolate_at_acc(tg, r, (0,))):
        _same(ps.collect_results(x, b), want)
    assert bool(ps.collect_results(out[2], b).all())

    # the JAX package's tables carried over: same cells, hi + lo
    ug = jacc.prepare_accurate(ug)
    carried = tiu.grid_from_numpy(
        {k: None if getattr(ug, k) is None else np.asarray(getattr(ug, k))
         for k in DATA_FIELDS},
        {k: getattr(ug, k) for k in META_FIELDS}, "cpu")
    th, tl, tf, tic = (ps.collect_results(x, b) for x in f(
        ps.replicate_grid(carried, mesh), r_sh, [0]))
    jh, jl, jf, jic = jps.sharded_interpolate_at_acc(jmesh)(
        jps.replicate_grid(ug, jmesh), jps.shard_batch(
            jnp.asarray(r.numpy()), jmesh)[0], jnp.asarray([0]))
    np.testing.assert_array_equal(tic, np.asarray(jic)[:b])
    np.testing.assert_array_equal(tf, np.asarray(jf)[:b])
    ref = _hi_lo(np.asarray(jh)[:b], np.asarray(jl)[:b])
    assert np.abs(_hi_lo(th, tl) - ref).max() <= 1e-13 * max(
        1.0, np.abs(ref).max())


def test_sharded_cell_data_lookups(mesh):
    jnp, jiu, jps, jmesh = _jax()
    pts, cells, nbrs = meshgen.quad_rect_mesh(24, 24)
    ug, tg = _build_both("quad", (pts, cells, nbrs),
                         {"Polynomial": pts.sum(1) + 1.0})
    n_cells = tg.n_cells
    rho, mat = np.arange(n_cells, dtype=float) + 0.5, 7 - np.arange(n_cells)
    tg, icd = tiu.add_cell_data(tg, "rho", rho)
    tg, iicd = tiu.add_icell_data(tg, "mat", mat)
    ug, _ = jiu.add_cell_data(ug, "rho", rho)
    ug, _ = jiu.add_icell_data(ug, "mat", mat)
    grid = ps.replicate_grid(tg, mesh)
    jgrid = jps.replicate_grid(ug, jmesh)
    r = _queries(np.random.default_rng(13), tg, 203)
    r_sh, b = ps.shard_batch(r, mesh)
    jr_sh, _ = jps.shard_batch(jnp.asarray(r), jmesh)
    rt = torch.from_numpy(r)

    f = ps.sharded_get_cell_scalar_at(mesh)
    cold = f(grid, r_sh, icd)
    local = tiu.get_cell_scalar_at(tg, rt, icd)
    assert bool(local[2].all())
    for x, want in zip(cold, local):
        _same(ps.collect_results(x, b), want)
    jcold = jps.sharded_get_cell_scalar_at(jmesh)(jgrid, jr_sh, icd)
    for x, j in zip(cold, jcold):
        np.testing.assert_array_equal(ps.collect_results(x, b),
                                      np.asarray(j)[:b])

    # warm restart: the previous cells (a Sharded result) as guesses
    warm = f(grid, r_sh, icd, cold[1])
    for x, want in zip(warm, tiu.get_cell_scalar_at(tg, rt, icd, local[1])):
        _same(ps.collect_results(x, b), want)
    _same(ps.collect_results(warm[1], b), local[1])
    jwarm = jps.sharded_get_cell_scalar_at(jmesh)(jgrid, jr_sh, icd,
                                                 jcold[1])
    for x, j in zip(warm, jwarm):
        np.testing.assert_array_equal(ps.collect_results(x, b),
                                      np.asarray(j)[:b])

    icold = ps.sharded_get_icell_scalar_at(mesh)(grid, r_sh, iicd)
    for x, want in zip(icold, tiu.get_icell_scalar_at(tg, rt, iicd)):
        _same(ps.collect_results(x, b), want)
    jicold = jps.sharded_get_icell_scalar_at(jmesh)(jgrid, jr_sh, iicd)
    np.testing.assert_array_equal(ps.collect_results(icold[0], b),
                                  np.asarray(jicold[0])[:b])

    ic, found = ps.sharded_get_cell(mesh)(grid, r_sh, cold[1])
    for x, want in zip((ic, found), tiu.get_cell(tg, rt, local[1])):
        _same(ps.collect_results(x, b), want)
    jic, _ = jps.sharded_get_cell(jmesh)(jgrid, jr_sh, jcold[1])
    np.testing.assert_array_equal(ps.collect_results(ic, b),
                                  np.asarray(jic)[:b])


def test_sharded_get_cell_runs_each_shard_as_its_own_batch(mesh):
    """Each shard is one single-device call on its own batch.  On a walk
    grid, get_cell walks in two phases from ``walk_compact_min_batch``
    queries on (the JAX package's rule), so with the threshold between a
    shard's size and the whole batch's, the sharded cells are the
    shards' own calls' cells, and they may differ from the whole batch's
    only where both cells hold the point (a quarter of the queries lie
    on cube faces here; on the 998k box one of 65,536 trace seeds did,
    PERF.md §6)."""
    pts, cells, nbrs = meshgen.tet_box_mesh(8, 8, 8)
    cfg = dataclasses.replace(HOST, use_candidate_bins=False,
                              walk_compact_min_batch=1024)
    tg = tiu.build_grid(pts, cells, nbrs, "tetra", dtype=torch.float64,
                        point_data={"P": pts.sum(1)}, locate_mode="walk",
                        config=cfg, device="cpu")
    rng = np.random.default_rng(14)
    r = _queries(rng, tg, 4000)  # shards of 500, under the threshold
    on_face = rng.random(4000) < 0.25
    r[on_face, 0] = np.round(r[on_face, 0] * 8) / 8  # cube faces
    r_sh, b = ps.shard_batch(r, mesh)
    ic, found = ps.sharded_get_cell(mesh)(ps.replicate_grid(tg, mesh), r_sh)
    per_shard = [tiu.get_cell(tg, s) for s in r_sh.shards]
    _same(ps.collect_results(ic, b), torch.cat([p[0] for p in per_shard]))
    _same(ps.collect_results(found, b), torch.cat([p[1] for p in per_shard]))
    rt = torch.from_numpy(r)
    w_ic, w_found = tiu.get_cell(tg, rt)
    _same(ps.collect_results(found, b), w_found)
    got = torch.from_numpy(ps.collect_results(ic, b))
    differ = got != w_ic
    assert bool(tiu.point_is_inside_cell(tg, rt[differ], got[differ]).all())
    assert bool(tiu.point_is_inside_cell(tg, rt[differ], w_ic[differ]).all())


def test_grid_to_keeps_every_leaf_and_meta_field():
    pts, cells, nbrs = meshgen.tet_box_mesh(4, 4, 4)
    g = tiu.build_grid(pts, cells, nbrs, "tetra", dtype=torch.float32,
                       point_data={"P": pts.sum(1)}, locate_mode="walk",
                       config=HOST, device="cpu")
    g = tiu.prepare_accurate(g)
    assert g.to("cpu") is g
    moved = g.to("meta")
    assert moved.device == torch.device("meta")
    n = 0
    for f in DATA_FIELDS:
        a, m = getattr(g, f), getattr(moved, f)
        assert (a is None) == (m is None), f
        if a is not None:
            assert m.device.type == "meta" and m.dtype == a.dtype, f
            assert m.shape == a.shape, f
            n += 1
    assert n >= 20
    for f in META_FIELDS:
        assert getattr(moved, f) == getattr(g, f), f


def test_no_wrapper_reads_the_current_devices_stream():
    """A wrapper launches on the stream of the device its tensors lie on,
    whatever the current device is: every ``current_stream`` call names
    the device."""
    ops = pathlib.Path(tiu.__file__).parent / "ops"
    calls = 0
    for path in sorted(ops.glob("*_kernel.py")):
        src = path.read_text()
        calls += len(re.findall(r"current_stream\(", src))
        bare = re.findall(r"current_stream\(\s*\)", src)
        assert not bare, f"{path.name} reads current_stream() with no device"
    assert calls >= 9


@pytest.mark.cuda
def test_grid_to_cuda_answers_as_on_the_cpu(cuda):
    pts, cells, nbrs = meshgen.tet_box_mesh(6, 6, 6)
    g = tiu.build_grid(pts, cells, nbrs, "tetra", dtype=torch.float32,
                       point_data={"P": pts.sum(1) + 1.0}, device="cpu")
    gc = g.to(cuda)
    assert gc.device.type == "cuda"
    r = torch.from_numpy(np.random.default_rng(4).random((5000, 3))).float()
    cpu = tiu.interpolate_scalar_at(g, r, 0)
    dev = tiu.interpolate_scalar_at(gc, r.to(cuda), 0)
    for a, b in zip(cpu, dev):
        b = b.cpu()
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    assert not math.isnan(float(dev[0].max()))
