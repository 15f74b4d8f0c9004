"""Float64 grids: the port against the JAX package's float64 route, and
the double kernels of B1, B2 and B3 against their plain versions.

The JAX package answers a float64 grid through XLA (its Pallas kernels
take float32 only); the port answers it on the CPU through the plain
versions and on the card through B1, B2 and B3 instantiated for double.
The CPU cases hold the port against the JAX package (with x64):

* bin coordinates of queries on candidate-bin and seed-bin edges and
  one float64 ulp either side, computed in float64 from the grid's
  float64 origin and inverse sizes (float32 rounding would move some);
* a float64 tet box whose rows hold K = 7 candidates and no fused
  variable, so most bins have extension rows: cold cell ids and found
  masks identical, linear exactness 1e-14;
* float64 triangle and quad grids with fused values in their rows: ids
  and found identical, values within 1e-13 and linear exactness 1e-13;
* the wrappers' dtype checks, which run before any kernel is built.

The ``cuda`` cases (skipped without a card) hold each double kernel
``torch.equal`` to its plain version on the same CUDA tensors: B1 on
triangles, quads and tets; B2's bin pass, probe in bin order and unsort
with fused values, and the probe with the extension rows; both B3
kernels.  A float64 ``load_grid`` of a checkpoint saved by the JAX
package is covered by ``tests/test_torch_checkpoint.py``
("tetra-float64", "triangle-float64").

The file imports jax only inside the tests that compare with the JAX
package, so that the card, which has no jax, collects its ``cuda``
tests with ``--noconftest``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models import cand_table
from interpolate_unstructured_tpu_torch.ops import (
    cand_kernel,
    geometry,
    interp_kernel,
    locate,
    walk_kernel,
)
from interpolate_unstructured_tpu_torch.utils import meshgen

HOST = tiu.IUConfig(cand_build="host", walk_compact_min_batch=2048)
NOCAND = dataclasses.replace(HOST, use_candidate_bins=False)
BRUTE = {
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(2, 2)),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(8, 8)),
    "tetra": ("tetra", lambda: meshgen.tet_box_mesh(5, 5, 5)),
}
FUSED = {
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(24, 24)),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(24, 24)),
}
# rows wide enough for both variables in float64 (the default 1024 bytes
# fuse one into the triangles' rows and none into the quads')
FUSED_CFG = dataclasses.replace(HOST, cand_row_bytes=4096)
# 48,000 tets: float64 rows of K = 7 candidates, no fused variable
EXT_BOX = ("tetra", lambda: meshgen.tet_box_mesh(20, 20, 20))


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests (on
    some virtualized hosts a thread's first float32 torch.sqrt is off by
    ~1e-4 relative; the float32 comparisons here call it)."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax():
    """The JAX package and jax.numpy (the reference side)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu

    return jnp, jiu


def _point_data(pts):
    return {"Polynomial": pts.sum(1) + 1.0, "XY": pts[:, 0] * pts[:, 1]}


def _queries(pts, n=4000, seed=3, plane=False):
    """Uniform in the mesh's box grown by 10% on each side; 2D meshes
    keep their plane z = 0."""
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(0), pts.max(0)
    span = hi - lo
    r = lo - 0.1 * span + rng.random((n, 3)) * 1.2 * span
    if plane:
        r[:, 2] = 0.0
    return r


def _build(cell_type, mesh, cfg=HOST, locate_mode="auto", device="cpu"):
    pts, cells, nbrs = mesh()
    return pts, tiu.build_grid(pts, cells, nbrs, cell_type,
                               dtype=torch.float64,
                               point_data=_point_data(pts),
                               locate_mode=locate_mode, config=cfg,
                               device=device)


def _build_both(cell_type, mesh, cfg=HOST, locate_mode="auto"):
    jnp, jiu = _jax()
    pts, cells, nbrs = mesh()
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jnp.float64,
                        point_data=_point_data(pts), locate_mode=locate_mode,
                        config=jiu.IUConfig(**dataclasses.asdict(cfg)))
    _, tg = _build(cell_type, mesh, cfg, locate_mode)
    assert tg.locate_mode == ug.locate_mode
    return pts, ug, tg


def _edge_queries(rmin, inv_h, shape, n, seed):
    """(3 n, 3) float64 queries whose coordinates lie on bin edges rmin +
    i / inv_h, and one float64 ulp below and above them, in random
    order over the axes' inner edges (an inactive axis, inv_h = 0, stays
    at rmin)."""
    rng = np.random.default_rng(seed)
    rmin = np.asarray(rmin, np.float64)
    inv_h = np.asarray(inv_h, np.float64)
    h = np.divide(1.0, inv_h, out=np.zeros(3), where=inv_h > 0)
    edge = rmin + rng.integers(1, np.maximum(shape, 2), (n, 3)) * h
    return np.concatenate([np.nextafter(edge, -np.inf), edge,
                           np.nextafter(edge, np.inf)])


# ---------------------------------------------------------------------
# Against the JAX package, on the CPU


def test_float64_bin_coordinates_match_jax():
    """Candidate and seed bins of queries on bin edges, and a float64 ulp
    either side, are the JAX package's: floor((r - rmin) * inv_h) in
    float64 from the grid's float64 origin and inverse sizes."""
    jnp, _ = _jax()
    from interpolate_unstructured_tpu.ops import locate as jlocate

    pts, ug, tg = _build_both("tetra", lambda: meshgen.tet_box_mesh(8, 8, 8))
    assert tg.cand_rmin.dtype == tg.bin_rmin.dtype == torch.float64
    for name, rmin, inv_h, shape, port, jax_bins in (
        ("candidate", tg.cand_rmin, tg.cand_inv_h, tg.cand_shape,
         lambda r: cand_table.probe_inputs(tg, r)[0].long(),
         lambda r: jlocate._cand_bin_flat(
             ug, jlocate._cand_bin_ijk_t(ug, r.T))),
        ("seed", tg.bin_rmin, tg.bin_inv_h, tg.bin_shape,
         lambda r: walk_kernel.seed_bins(tg, r),
         lambda r: jlocate._bin_index(ug, r)),
    ):
        r = _edge_queries(rmin.numpy(), inv_h.numpy(), shape, 2000, 7)
        got = port(torch.from_numpy(r)).numpy()
        want = np.asarray(jax_bins(jnp.asarray(r)))
        np.testing.assert_array_equal(got, want, err_msg=name)
        # the float32 rounding of the same queries and bin grid, the bin
        # pass of a float32 grid, lands some of them in another bin
        ijk32 = geometry.bin_ijk(torch.from_numpy(r.astype(np.float32)),
                                 rmin.float(), inv_h.float(), shape,
                                 torch.int64)
        moved = geometry.bin_flat(ijk32, shape).numpy() != got
        assert moved.any(), name


def test_float64_extension_rows_match_jax():
    """A float64 tet box with K = 7 candidates a row, no fused variable
    and extension rows in most bins: cold cells as the JAX package
    finds them (the main rows, the extension rows, then
    interpolate_at_icell), linear exactness 1e-14."""
    jnp, jiu = _jax()
    pts, ug, tg = _build_both(*EXT_BOX)
    assert tg.cand_ids.shape[1] == 7 and cand_table.fused_nv(tg) == 0
    assert tg.cand_ext_table is not None
    n_ext = int((tg.cand_count > tg.cand_ids.shape[1]).sum())
    assert n_ext > tg.cand_count.numel() // 2
    r = _queries(pts, 6000)
    tv, tic, tf = tiu.interpolate_scalar_at(tg, torch.from_numpy(r), 0)
    jv, jic, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(r), 0)
    f = tf.numpy()
    assert f.any() and not f.all()
    np.testing.assert_array_equal(f, np.asarray(jf))
    np.testing.assert_array_equal(tic.numpy(), np.asarray(jic))
    assert np.abs(tv.numpy()[f] - (r[f].sum(1) + 1.0)).max() <= 1e-14
    np.testing.assert_allclose(tv.numpy()[f], np.asarray(jv)[f], rtol=0,
                               atol=1e-13)
    tic2, tf2 = tiu.get_cell(tg, torch.from_numpy(r))
    np.testing.assert_array_equal(tic2.numpy(), tic.numpy())
    np.testing.assert_array_equal(tf2.numpy(), f)


@pytest.mark.parametrize("mesh", list(FUSED))
def test_float64_fused_values_match_jax(mesh):
    """Float64 triangle and quad rows with fused values (layouts
    "simplex" and "quad" in float64)."""
    jnp, jiu = _jax()
    cell_type, gen = FUSED[mesh]
    pts, ug, tg = _build_both(cell_type, gen, FUSED_CFG, "walk")
    assert tg.cand_table.dtype == torch.float64
    assert cand_table.fused_nv(tg) >= 2
    assert cand_table.layout(tg, 1, ()).kind == (
        "quad" if cell_type == "quad" else "simplex")
    r = _queries(pts, plane=True)
    tv, tic, tf = tiu.interpolate_at(tg, torch.from_numpy(r), [0, 1])
    jv, jic, jf = jiu.interpolate_at(ug, jnp.asarray(r), [0, 1])
    f = tf.numpy()
    assert f.any() and not f.all()
    np.testing.assert_array_equal(f, np.asarray(jf))
    np.testing.assert_array_equal(tic.numpy(), np.asarray(jic))
    np.testing.assert_allclose(tv.numpy()[f], np.asarray(jv)[f], rtol=0,
                               atol=1e-13)
    assert np.abs(tv.numpy()[f, 0] - (r[f].sum(1) + 1.0)).max() <= 1e-13


# ---------------------------------------------------------------------
# The wrappers' dtype checks (no kernel is built before they pass)


def test_float64_wrappers_check_dtypes():
    """Float64 tables take float64 queries and bin grids; quantized and
    df-plane rows stay float32; other dtypes and mixes raise."""
    _, g = _build(*BRUTE["tetra"])
    r32 = torch.zeros((4, 3), dtype=torch.float32)
    with pytest.raises(TypeError, match="float32 or float64"):
        interp_kernel.interpolate_bruteforce_cuda(g, r32, [0])
    lay = cand_kernel.RowLayout("simplex", 4, 4, 16, 80, ())
    t64 = torch.zeros((2, 81), dtype=torch.float64)
    cand_kernel._check_table(t64, lay)
    cand_kernel._check_table(t64.float(), lay)
    for kind in ("quantized", "qdf"):
        with pytest.raises(TypeError, match="float64 simplex and quad"):
            cand_kernel._check_table(t64, dataclasses.replace(lay, kind=kind))
    with pytest.raises(TypeError, match="float64 simplex and quad"):
        cand_kernel._check_table(t64.half(), lay)
    b64 = torch.zeros(3, dtype=torch.float64)
    r64 = torch.zeros((4, 3), dtype=torch.float64)
    assert cand_kernel._check_bins(r64, b64, b64, (2, 2, 2))[3] == 8
    assert cand_kernel._check_bins(r64, b64.float(), b64.float(),
                                   (2, 2, 2))[3] == 8
    with pytest.raises(ValueError, match="float64 with float64 queries"):
        cand_kernel._check_bins(r32, b64, b64, (2, 2, 2))
    with pytest.raises(TypeError, match="one dtype"):
        walk_kernel._entry(walk_kernel._WALK_ENTRY, "walk kernel", t64, r32)
    with pytest.raises(TypeError, match="one dtype"):
        walk_kernel._entry(walk_kernel._GET_CELL_ENTRY, "get_cell walk",
                           t64.half())


# ---------------------------------------------------------------------
# On the card: each double kernel against its plain version


def _equal(name, got, want):
    """A kernel's outputs torch.equal to its plain version's."""
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, (name, i)
        assert torch.equal(a, b), (name, i, int((a != b).sum()))


def _as_cpu(name, got, want):
    """Outputs on the card against the same call on the CPU: integer and
    boolean outputs identical, float64 ones within 1e-13 (torch's CPU
    and CUDA builds may round an operation of the plain torch around
    the kernels differently)."""
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, (name, i)
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-13,
                                       equal_nan=True, msg=f"{name} {i}")
        else:
            assert torch.equal(a, b), (name, i, int((a != b).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", list(BRUTE))
def test_cuda_float64_bruteforce_equals_plain(cuda, mesh):
    """B1 in double: ids, found and values torch.equal to the plain
    version on the card, and the main path launches it."""
    cell_type, gen = BRUTE[mesh]
    pts, g = _build(cell_type, gen, device=cuda)
    assert g.locate_mode == "bruteforce"
    r = torch.from_numpy(_queries(pts, 20_000, plane=mesh != "tetra")).to(
        cuda)
    _equal("B1", interp_kernel.interpolate_bruteforce_cuda(g, r, [0, 1]),
           interp_kernel.interpolate_bruteforce_plain(g, r, [0, 1]))
    before = interp_kernel.launches
    v, ic, found = tiu.interpolate_at(g, r, [0, 1])
    torch.cuda.synchronize()
    assert interp_kernel.launches > before
    assert v.dtype == torch.float64 and found.any() and not found.all()
    lin = (v[found, 0] - (r[found].sum(1) + 1.0)).abs().max().item()
    assert lin <= 1e-14


def _b2_compare(g, r, var_slots):
    """B2's double kernels against their plain versions on the card: the
    key pass, scan and scatter, probe and unsort on the main table and, where
    the grid has extension rows, the probe with them against
    probe_rows_ext_plain.  Returns the queries that reach them."""
    k = g.cand_ids.shape[1]
    lay = cand_table.layout(g, k, var_slots)
    eps = cand_table.probe_eps(g)
    bins = (g.cand_rmin, g.cand_inv_h, g.cand_shape)
    idx, rq = cand_table.probe_inputs(g, r)
    chunk = cand_table.probe_chunk(g)
    plain = cand_kernel.probe_rows_plain(g.cand_table, idx, rq, lay, eps, k,
                                         chunk)
    order = cand_kernel.bin_order_cuda(
        r, *bins, cand_kernel.out_words(lay, g.cand_table))
    assert order.rec.shape == (r.shape[0], 6)
    assert cand_kernel.order_mismatches(
        order, idx, cand_kernel.order_records_plain(r)) == 0
    for lanes in (1, 2, 4, 32):
        _equal(f"B2 in bin order, {lanes} lanes",
               cand_kernel.cand_rows_binned_cuda(g.cand_table, order, *bins,
                                                 lay, eps, k, lanes),
               plain)
    if g.cand_ext_table is None:
        return 0
    sel = torch.nonzero(plain[1] >= 0).squeeze(1)
    lay_e = cand_table.layout(g, g.cand_ext_ids.shape[1], var_slots)
    ext = (g.cand_ext_table, lay_e)
    want = cand_kernel.probe_rows_ext_plain(g.cand_table, g.cand_ext_table,
                                            idx, rq, lay, lay_e, eps, k, chunk)
    for lanes in (1, 2, 4, 32):
        _equal(f"B2 in bin order with the extension rows, {lanes} lanes",
               cand_kernel.cand_rows_binned_cuda(g.cand_table, order, *bins,
                                                 lay, eps, k, lanes, ext=ext),
               want)
    return int(sel.numel())


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", list(FUSED))
def test_cuda_float64_candidate_rows_equal_plain(cuda, mesh):
    """B2 in double on rows with fused values, and the main path on the
    card gives the CPU's answers through the bin-ordered kernels."""
    cell_type, gen = FUSED[mesh]
    pts, g = _build(cell_type, gen, FUSED_CFG, "walk", cuda)
    r = torch.from_numpy(_queries(pts, 20_000, plane=True)).to(cuda)
    _b2_compare(g, r, (0, 1))
    _, gc = _build(cell_type, gen, FUSED_CFG, "walk")
    before = cand_kernel.binned_launches
    got = tiu.interpolate_at(g, r, [0, 1])
    torch.cuda.synchronize()
    assert cand_kernel.binned_launches > before
    _as_cpu("interpolate_at", got, tiu.interpolate_at(gc, r.cpu(), [0, 1]))


@pytest.mark.cuda
def test_cuda_float64_extension_rows_equal_plain(cuda):
    """The K = 7 float64 box: B2 in bin order with the extension probe,
    then interpolate_at_icell, with the CPU's answers."""
    pts, g = _build(*EXT_BOX, device=cuda)
    r = torch.from_numpy(_queries(pts, 20_000)).to(cuda)
    assert _b2_compare(g, r, ()) > 0
    _, gc = _build(*EXT_BOX)
    before = cand_kernel.ext_launches, cand_kernel.binned_launches
    got = tiu.interpolate_scalar_at(g, r, 0)
    torch.cuda.synchronize()
    assert cand_kernel.ext_launches == before[0] + 1
    assert cand_kernel.binned_launches == before[1]
    _as_cpu("interpolate_scalar_at", got,
            tiu.interpolate_scalar_at(gc, r.cpu(), 0))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["tetra", "triangle"])
def test_cuda_float64_walks_equal_plain(cuda, mesh):
    """Both B3 kernels in double: get_cell's walk stage (cold from the
    seed rows, warm from guesses, two phases) and the explicit walk,
    torch.equal to their plain versions on the card; the public warm
    and cold calls launch them."""
    cell_type, gen = {"tetra": ("tetra", lambda: meshgen.tet_box_mesh(
        8, 8, 8)), "triangle": FUSED["triangle"]}[mesh]
    pts, g = _build(cell_type, gen, NOCAND, "walk", cuda)
    assert g.cand_table is None and g.walk_table.dtype == torch.float64
    plane = mesh != "tetra"
    r = torch.from_numpy(_queries(pts, 20_000, plane=plane)).to(cuda)
    edges = _edge_queries(g.bin_rmin.cpu().numpy(), g.bin_inv_h.cpu().numpy(),
                          g.bin_shape, 1000, 9)
    if plane:
        edges[:, 2] = 0.0
    r = torch.cat([r, torch.from_numpy(edges).to(cuda)])
    p1 = g.config.walk_phase1_steps
    ic, found = walk_kernel.get_cell_walk_plain(g, r, None, 1024, 0)
    _equal("get_cell walk, cold",
           walk_kernel.get_cell_walk_cuda(g, r, None, 1024, 0), (ic, found))
    rw = r + 0.02 * torch.rand(r.shape, generator=torch.Generator(
        device=cuda).manual_seed(4), device=cuda, dtype=r.dtype)
    if plane:
        rw[:, 2] = 0.0
    guess = torch.where(found, ic, -1).to(torch.int32)
    for steps, phase1 in ((1024, p1), (1024, 0), (40, 4)):
        _equal(f"get_cell walk, warm, {steps}/{phase1}",
               walk_kernel.get_cell_walk_cuda(g, rw, guess, steps, phase1),
               walk_kernel.get_cell_walk_plain(g, rw, guess, steps, phase1))
    start = torch.where(found, ic, 0).to(torch.int32)
    r0 = walk_kernel.walk_origin(g.walk_table, start, g.n_faces_per_cell,
                                 g.n_points_per_cell)
    args = locate._walk_args(g, r0, rw, start)
    for threads in (32, 128):
        _equal(f"walk_rows, {threads} threads a block",
               walk_kernel.walk_cuda(*args, threads=threads),
               walk_kernel.walk_rows_plain(*args))
    _, gc = _build(cell_type, gen, NOCAND, "walk")
    before = walk_kernel.get_cell_launches, walk_kernel.launches
    got = [tiu.get_cell(g, rw, guess), tiu.get_cell(g, r),
           tiu.walk(g, r0, rw, start)]
    torch.cuda.synchronize()
    assert walk_kernel.get_cell_launches >= before[0] + 2
    assert walk_kernel.launches > before[1]
    want = [tiu.get_cell(gc, rw.cpu(), guess.cpu()), tiu.get_cell(gc, r.cpu()),
            tiu.walk(gc, r0.cpu(), rw.cpu(), start.cpu())]
    for name, a, b in zip(("warm", "cold", "walk"), got, want):
        _as_cpu(name, a, b)
