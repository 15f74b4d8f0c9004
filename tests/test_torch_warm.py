"""The port's warm path and neighbor walk against the JAX package.

Both packages build their walk grids natively from the same mesh
(``cand_build="host"``) — with candidate tables, without them (cold
starts walk from the refined bin seeds), and with ``seed_mode="kdtree"``
— and answer the same queries through ``get_cell`` (cold, and warm with
guesses in range, negative and past the last cell), ``interpolate_at``
with a guess or an unfused variable, ``interpolate_at_icell``,
``get_cell_scalar_at`` and ``get_icell_scalar_at``.  The configs lower
``walk_compact_min_batch`` to 2048 so that the 4000-query batches take
the two-phase walk (phase 1, then the stragglers resume).  Grids whose
candidate rows do not cover every bin (``cand_ext_max_k`` 2, and 0: no
extension table) run the residual walk.

Tolerances: float32 found masks identical; cell ids identical except
near-ties, where both cells contain the point (XLA on the CPU contracts
the JAX side's float32 arithmetic into FMAs and torch does not, so a
point on a shared face may land on either side); not-found codes
identical; values within 2e-6 where found.  float64: linear exactness
1e-14 and agreement with the JAX package to 1e-13.
"""

import dataclasses

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.ops import walk_kernel
from interpolate_unstructured_tpu_torch.utils import meshgen

HOST = tiu.IUConfig(cand_build="host", walk_compact_min_batch=2048)
CONFIGS = {
    "cand": HOST,
    "nocand": dataclasses.replace(HOST, use_candidate_bins=False),
    "kdtree": dataclasses.replace(HOST, seed_mode="kdtree"),
}
MESHES = {
    "tetra": ("tetra", lambda: meshgen.tet_box_mesh(8, 8, 8)),
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(24, 24)),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(24, 24)),
}
N = 4000


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests.

    On some virtualized x86 hosts the first float32 torch.sqrt that a
    worker thread runs in a process returns values off by ~1e-4 relative
    for that thread's chunk; every later call is exact.  The walk and
    the triangle and quad weights call torch.sqrt, so the first,
    discarded call is made here."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu

    return jnp, jiu


def _data(pts, n_cells):
    point_data = {"Polynomial": pts.sum(1) + 1.0, "XY": pts[:, 0] * pts[:, 1]}
    ids = np.arange(n_cells)
    cell_data = {"half": ids * 0.5}
    icell_data = {"id3": ids % 3, "id": ids}
    return point_data, cell_data, icell_data


def _build_both(mesh, cfg, dtype=torch.float32):
    jnp, jiu = _jax()
    cell_type, gen = MESHES[mesh]
    pts, cells, nbrs = gen()
    pd, cd, icd = _data(pts, len(cells))
    kw = dict(point_data=pd, cell_data=cd, icell_data=icd, locate_mode="walk")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jdt,
                        config=jiu.IUConfig(**dataclasses.asdict(cfg)), **kw)
    tg = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=dtype, config=cfg,
                        device="cpu", **kw)
    return pts, ug, tg


def _queries(pts, cell_type, n=N, seed=3, grow=0.1):
    """Uniform in the mesh's box grown by ``grow`` a side (2D meshes stay
    in their plane)."""
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(0), pts.max(0)
    span = hi - lo
    r = lo - grow * span + rng.random((n, 3)) * (1 + 2 * grow) * span
    if cell_type != "tetra":
        r[:, 2] = 0.0
    return r


def _guesses(ic, n_cells, seed=4):
    """The cold cells as guesses, with some negative (cold restarts) and
    some past the last cell (reseeded as cold)."""
    g = np.array(ic, dtype=np.int32)
    rng = np.random.default_rng(seed)
    g[rng.random(len(g)) < 0.1] = -1
    g[rng.random(len(g)) < 0.05] = n_cells + 7
    return g


def _check_cells(tg, r, jic, jf, tic, tf):
    """Found masks identical; cell ids identical except near-ties where
    both cells contain the point."""
    jic = torch.from_numpy(np.array(jic))
    jf = torch.from_numpy(np.array(jf))
    assert torch.equal(tf, jf)
    differ = torch.nonzero(jic != tic).squeeze(1)
    assert differ.numel() <= 0.01 * len(tic)
    if differ.numel():
        rr = torch.as_tensor(r, dtype=tg.dtype)[differ]
        assert bool(tf[differ].all())
        assert bool(tiu.point_is_inside_cell(tg, rr, jic[differ]).all())
        assert bool(tiu.point_is_inside_cell(tg, rr, tic[differ]).all())
    return jf


@pytest.fixture
def count_resumes(monkeypatch):
    """Count the straggler resumes of the two-phase walk (phase 2 of the
    get_cell walk's plain version, which runs on CPU tensors)."""
    calls = []
    real = walk_kernel._resume_plain

    def spy(grid, r_p, r1, ic, max_steps):
        calls.append(r_p.shape[0])
        return real(grid, r_p, r1, ic, max_steps)

    monkeypatch.setattr(walk_kernel, "_resume_plain", spy)
    return calls


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_get_cell_matches_jax(mesh, cfg, count_resumes):
    jnp, jiu = _jax()
    pts, ug, tg = _build_both(mesh, CONFIGS[cfg])
    assert (tg.cand_table is not None) == (cfg == "cand")
    assert (tg.kd_node_points is not None) == (cfg == "kdtree")
    count_resumes.clear()  # the refine of the bin seeds walks too
    cell_type = MESHES[mesh][0]
    r = _queries(pts, cell_type).astype(np.float32)
    jic, jf = jiu.get_cell(ug, jnp.asarray(r))
    tic, tf = tiu.get_cell(tg, torch.from_numpy(r))
    jf = _check_cells(tg, r, jic, jf, tic, tf)
    assert 0 < int(jf.sum()) < N

    # warm: queries moved a little, guessed by the cold cells
    rw = r + (0.02 * np.random.default_rng(5).random(r.shape)).astype(
        np.float32)
    if cell_type != "tetra":
        rw[:, 2] = 0.0
    g = _guesses(tic, tg.n_cells)
    jic2, jf2 = jiu.get_cell(ug, jnp.asarray(rw), jnp.asarray(g))
    tic2, tf2 = tiu.get_cell(tg, torch.from_numpy(rw), torch.from_numpy(g))
    _check_cells(tg, rw, jic2, jf2, tic2, tf2)
    assert (tic2[~tf2] < 0).all()
    if cfg != "cand":
        # the two-phase walk ran, and stragglers resumed
        assert count_resumes and max(count_resumes) > 0


@pytest.mark.parametrize("cfg", ["cand", "nocand"])
def test_interpolate_at_warm_and_unfused_match_jax(cfg):
    jnp, jiu = _jax()
    pts, ug, tg = _build_both("quad", CONFIGS[cfg])
    r = _queries(pts, "quad").astype(np.float32)
    if cfg == "cand":
        assert tg.cand_nv == 1 < tg.n_point_data  # "XY" is not fused
    # an unfused variable, cold
    jv, jic, jf = jiu.interpolate_at(ug, jnp.asarray(r), [1, 0],
                                     fill_value=-3.0)
    tv, tic, tf = tiu.interpolate_at(tg, torch.from_numpy(r), [1, 0],
                                     fill_value=-3.0)
    jf = _check_cells(tg, r, jic, jf, tic, tf).numpy()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=2e-6)
    assert (tv.numpy()[~jf] == -3.0).all()
    # with a guess
    g = _guesses(tic, tg.n_cells)
    jv, jic, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(r), 0,
                                            guess=jnp.asarray(g))
    tv, tic2, tf = tiu.interpolate_scalar_at(tg, torch.from_numpy(r), 0,
                                             guess=torch.from_numpy(g))
    jf = _check_cells(tg, r, jic, jf, tic2, tf).numpy()
    np.testing.assert_allclose(tv.numpy()[jf], np.asarray(jv)[jf], rtol=0,
                               atol=2e-6)
    assert np.isnan(tv.numpy()[~jf]).all()
    lin = np.abs(tv.numpy()[jf] - (r[jf].astype(np.float64).sum(1) + 1.0))
    assert lin.max() <= 2e-6

    # cell data and integer cell data at the located cells
    for j_fn, t_fn, i_var, fill, dtype in (
        (jiu.get_cell_scalar_at, tiu.get_cell_scalar_at, 0, -2.0,
         torch.float32),
        (jiu.get_icell_scalar_at, tiu.get_icell_scalar_at, 1, -1,
         torch.int32),
    ):
        jv, jic, jf = j_fn(ug, jnp.asarray(r), i_var, guess=jnp.asarray(g),
                           fill_value=fill)
        tv, tic3, tf = t_fn(tg, torch.from_numpy(r), i_var,
                            guess=torch.from_numpy(g), fill_value=fill)
        _check_cells(tg, r, jic, jf, tic3, tf)
        assert tv.dtype == dtype
        same = tic3.numpy() == np.asarray(jic)
        np.testing.assert_array_equal(tv.numpy()[same], np.asarray(jv)[same])
    assert tiu.get_cell_data_index(tg, "half") == 0
    assert tiu.get_icell_data_index(tg, "id") == 1
    assert tiu.get_icell_data_index(tg, "nope") == -1


@pytest.mark.parametrize("n_queries", [100, N])
def test_interpolate_at_icell_matches_jax(n_queries):
    """Both gather routes: the per-call row table (B * 4 >= n_cells) and
    the walk rows plus connectivity."""
    jnp, jiu = _jax()
    pts, ug, tg = _build_both("tetra", CONFIGS["nocand"])
    r = _queries(pts, "tetra", n_queries, grow=0.0).astype(np.float32)
    ic = np.asarray(tiu.get_cell(tg, torch.from_numpy(r))[0])
    assert (ic >= 0).all()
    jv = jiu.interpolate_at_icell(ug, jnp.asarray(r), jnp.asarray([0, 1]),
                                  jnp.asarray(ic))
    tv = tiu.interpolate_at_icell(tg, torch.from_numpy(r), [0, 1],
                                  torch.from_numpy(ic))
    assert tv.shape == (n_queries, 2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=2e-6)
    lin = np.abs(tv.numpy()[:, 0] - (r.astype(np.float64).sum(1) + 1.0))
    assert lin.max() <= 2e-6


@pytest.mark.parametrize("ext_k", [2, 0])
def test_residual_walk_matches_jax(ext_k, monkeypatch):
    """Bins whose candidates exceed K + k_ext: their misses walk from the
    best candidate (cand_ext_max_k 2), or every overflow miss walks (0:
    no extension table)."""
    jnp, jiu = _jax()
    cfg = dataclasses.replace(HOST, cand_bins_per_cell=0.3,
                              cand_ext_max_k=ext_k, cand_cover_row_bytes=0)
    pts, ug, tg = _build_both("tetra", cfg)
    assert not tg.cand_ext_covers
    assert (tg.cand_ext_table is None) == (ext_k == 0)
    walked = []
    real_walk = walk_kernel.get_cell_walk

    def spy(grid, r, start, max_steps, p1):
        walked.append(len(r))
        return real_walk(grid, r, start, max_steps, p1)

    monkeypatch.setattr(walk_kernel, "get_cell_walk", spy)
    r = _queries(pts, "tetra").astype(np.float32)
    jv, jic, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(r), 0)
    tv, tic, tf = tiu.interpolate_scalar_at(tg, torch.from_numpy(r), 0)
    assert walked and min(walked) > 0
    jf = _check_cells(tg, r, jic, jf, tic, tf).numpy()
    np.testing.assert_allclose(tv.numpy()[jf], np.asarray(jv)[jf], rtol=0,
                               atol=2e-6)
    assert (tic.numpy()[~jf] == -1).all()
    inner = ((r > 1e-4) & (r < 1 - 1e-4)).all(1)
    assert tf.numpy()[inner].all()


@pytest.mark.parametrize("cfg", ["nocand", "kdtree"])
def test_float64_warm_linear_exactness(cfg):
    jnp, jiu = _jax()
    pts, ug, tg = _build_both("tetra", CONFIGS[cfg], torch.float64)
    r = _queries(pts, "tetra")
    tic, _ = tiu.get_cell(tg, torch.from_numpy(r))
    rw = r + 0.02 * np.random.default_rng(6).random(r.shape)
    g = _guesses(tic, tg.n_cells)
    tv, tic2, tf = tiu.interpolate_scalar_at(tg, torch.from_numpy(rw), 0,
                                             guess=torch.from_numpy(g))
    jv, jic2, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(rw), 0,
                                             guess=jnp.asarray(g))
    f = _check_cells(tg, rw, jic2, jf, tic2, tf).numpy()
    assert f.any() and not f.all()
    assert np.abs(tv.numpy()[f] - (rw[f].sum(1) + 1.0)).max() <= 1e-14
    np.testing.assert_allclose(tv.numpy()[f], np.asarray(jv)[f], rtol=0,
                               atol=1e-13)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["cand", "nocand", "kdtree"])
def test_cuda_warm_matches_cpu(cfg):
    """The warm path on the card (B2 and B3) gives the CPU's answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell_type, gen = MESHES["tetra"]
    pts, cells, nbrs = gen()
    pd, cd, icd = _data(pts, len(cells))
    grids = [
        tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                       point_data=pd, locate_mode="walk",
                       config=CONFIGS[cfg], device=d)
        for d in ("cpu", "cuda")
    ]
    assert torch.equal(grids[0].bin_table, grids[1].bin_table.cpu())
    r = torch.from_numpy(_queries(pts, cell_type).astype(np.float32))
    g = torch.from_numpy(_guesses(np.zeros(N, np.int32), len(cells)))
    outs = [tiu.interpolate_scalar_at(grid, r, 0, guess=g) for grid in grids]
    (cv, cic, cf), (gv, gic, gf) = outs
    assert torch.equal(gf.cpu(), cf) and torch.equal(gic.cpu(), cic)
    assert (gv.cpu()[cf] - cv[cf]).abs().max().item() <= 2e-6


def test_kdtree_matches_jax():
    """The kd-tree's node layout is the JAX package's, node for node, and
    batched nearest-center queries return the same cells (exact 1-NN)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from interpolate_unstructured_tpu.ops import kdtree as jkdtree
    from interpolate_unstructured_tpu_torch.ops import kdtree

    rng = np.random.default_rng(7)
    pts = rng.random((999, 3))
    jt = jkdtree.build_kdtree(pts, dtype=jnp.float64)
    tt = kdtree.build_kdtree(pts, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(tt.node_ids.numpy(), np.asarray(jt.node_ids))
    np.testing.assert_array_equal(tt.node_points.numpy(),
                                  np.asarray(jt.node_points))
    assert tt.max_depth == jt.max_depth
    q = rng.random((500, 3)) * 1.2 - 0.1
    jidx, jd2 = jkdtree.nearest(jt, jnp.asarray(q))
    tidx, td2 = kdtree.nearest(tt, torch.from_numpy(q))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    brute = ((q[:, None, :] - pts[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(tidx.numpy(), brute.argmin(1))
    np.testing.assert_allclose(td2.numpy(), brute.min(1), rtol=1e-12)
