"""Kernel E1 (interpolation at known cells, ``ops/icell_kernel.py``) and
its plain version, ``ops/interp.interpolate_at_icell_plain``.

On the CPU the port's plain version runs against the JAX package's
``interpolate_at_icell`` (XLA; no Pallas kernel) on grids both packages
build from the same mesh: triangles, quads and tets of
``utils/meshgen.py``, float32 and float64, both of the plain version's
gather routes (a batch of at least a quarter as many queries as cells
reads a per-call row table, a smaller one the walk rows and the
connectivity), no, one and three variables, a negative slot, and cells
given as -1 (read as cell 0) for queries inside cell 0 (no variables on
the row-table route are held to an empty result: there the JAX
package's reshape of zero data columns divides by zero).  Tolerances:
float32 2e-6 absolute (XLA on the CPU contracts the JAX side's float32
arithmetic into FMAs, torch does not; ``tests/test_torch_warm.py``'s
bound), float64 1e-14 absolute on linear and bilinear data of size <= 5.
A CPU grid takes the plain version and builds and launches nothing.

The ``cuda`` cases (skipped without a card) hold E1 ``torch.equal`` to
the plain version on the same CUDA tensors, for every cell type, both
dtypes and both of the plain version's routes, with one launch a call;
they check its refusals and its clamp of the cells (a negative id reads
cell 0, one of n_cells or more the last cell, where the plain version
raises) and its answer on a grid without walk rows; then on the paths
that reach it: a warm and a cold
``interpolate_at`` on a walk grid, a float64 cold call on a tet box
whose K = 7 rows fuse no variable, and a trace's start field.  Those tests use the port alone,
so that on a machine without jax they run with
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models import cand_table
from interpolate_unstructured_tpu_torch.ops import _kernels, icell_kernel
from interpolate_unstructured_tpu_torch.ops.interp import (
    interpolate_at_icell_plain,
)
from interpolate_unstructured_tpu_torch.utils import meshgen

HOST = tiu.IUConfig(cand_build="host", walk_compact_min_batch=2048)
MESHES = {
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(12, 10)),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(12, 10)),
    "tetra": ("tetra", lambda: meshgen.tet_box_mesh(6, 6, 6)),
}
DTYPES = {"float32": torch.float32, "float64": torch.float64}
TOL = {torch.float32: 2e-6, torch.float64: 1e-14}
# variable slots: none, one, three out of order, a negative one (-1 is
# the last column)
SLOTS = {"v0": (), "v1": (0,), "v3": (2, 0, 1), "neg": (-1, 1)}
N_CELL0 = 7  # queries inside cell 0 given as cell -1


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests:
    on some virtualized hosts the first float32 torch.sqrt a worker
    thread runs in a process is off by ~1e-4 relative (PERF.md §7), and
    the triangle and quad weights take square roots."""
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
    """Linear, bilinear and linear again: three columns."""
    x, y, z = pts.T
    return {"Polynomial": x + y + z + 1.0, "XY": x * y,
            "S": 2.0 * x - y + 0.5}


@functools.lru_cache(maxsize=None)
def _mesh(name):
    return MESHES[name][1]()


def _build(name, dtype, device="cpu", cfg=HOST):
    cell_type = MESHES[name][0]
    pts, cells, nbrs = _mesh(name)
    return tiu.build_grid(pts, cells, nbrs, cell_type, dtype=dtype,
                          point_data=_point_data(pts), locate_mode="walk",
                          config=cfg, device=device)


@functools.lru_cache(maxsize=None)
def _grids(name, dtype):
    """(JAX package grid, port CPU grid) of one mesh and dtype."""
    jnp, jiu = _jax()
    cell_type = MESHES[name][0]
    pts, cells, nbrs = _mesh(name)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jdt,
                        point_data=_point_data(pts), locate_mode="walk",
                        config=jiu.IUConfig(**dataclasses.asdict(HOST)))
    return ug, _build(name, dtype)


def _batch(grid, route):
    """Queries a call: below a quarter of the cells (the walk rows and
    the connectivity), or above it (the per-call row table)."""
    return grid.n_cells // 4 - 1 if route == "small" else 2 * grid.n_cells


def _inputs(grid, b, seed=5):
    """(B, 3) float64 queries and (B,) int64 cells: uniform points of
    the mesh's box located by the port, the last N_CELL0 replaced by
    convex combinations of cell 0's vertices given as cell -1."""
    rng = np.random.default_rng(seed)
    pts = grid.points.double().cpu().numpy()
    lo, hi = pts.min(0), pts.max(0)
    r, ic = [], []
    while sum(len(x) for x in r) < b - N_CELL0:
        q = lo + rng.random((4 * b, 3)) * (hi - lo)
        if grid.ndim == 2:
            q[:, 2] = 0.0
        c, f = tiu.get_cell(grid.to("cpu"), torch.from_numpy(q))
        r.append(q[f.numpy()])
        ic.append(c.numpy()[f.numpy()].astype(np.int64))
    r = np.concatenate(r)[: b - N_CELL0]
    ic = np.concatenate(ic)[: b - N_CELL0]
    v0 = grid.cell_points[0].double().cpu().numpy()  # (npc, 3)
    w = rng.random((N_CELL0, v0.shape[0])) + 0.05
    r0 = (w / w.sum(1, keepdims=True)) @ v0
    return (np.concatenate([r, r0]),
            np.concatenate([ic, np.full(N_CELL0, -1, np.int64)]))


# ---------------------------------------------------------------------
# The plain version against the JAX package, on the CPU


@pytest.mark.parametrize("slots", list(SLOTS))
@pytest.mark.parametrize("route", ["small", "large"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_icell_plain_matches_jax(mesh, dtype, route, slots):
    jnp, jiu = _jax()
    dt = DTYPES[dtype]
    ug, tg = _grids(mesh, dt)
    b = _batch(tg, route)
    assert (b * 4 >= tg.n_cells) == (route == "large")
    r, ic = _inputs(tg, b)
    sl = SLOTS[slots]
    jdt = jnp.float32 if dt == torch.float32 else jnp.float64
    if sl or route == "small":
        jv = np.asarray(jiu.interpolate_at_icell(
            ug, jnp.asarray(r, dtype=jdt), jnp.asarray(sl, dtype=jnp.int32),
            jnp.asarray(ic)))
    else:
        # the JAX package's row-table route cannot reshape zero data
        # columns (reshape(-1, npc, 0) divides by zero): no values
        jv = np.zeros((b, 0), dtype=np.float32 if dt == torch.float32
                      else np.float64)
    tv = interpolate_at_icell_plain(tg, torch.from_numpy(r), sl,
                                    torch.from_numpy(ic))
    assert tv.dtype == dt and tv.shape == (b, len(sl)) == jv.shape
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=TOL[dt])
    if sl and sl[0] == 0:
        rq = torch.from_numpy(r).to(dt).double().numpy()
        lin = np.abs(tv.double().numpy()[:, 0] - (rq.sum(1) + 1.0)).max()
        assert lin <= 4 * TOL[dt]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_icell_cpu_grid_takes_plain(mesh, dtype, monkeypatch):
    """A CPU grid: interpolate_at_icell is the plain version, bit for
    bit, for cells as int32 or int64 tensors or arrays; E1 is neither
    built nor launched, and its wrapper refuses a CPU grid."""
    dt = DTYPES[dtype]
    grid = _build(mesh, dt)
    r, ic = _inputs(grid, 300)
    rt = torch.from_numpy(r)

    def no_build():
        raise AssertionError("the kernel library was built for a CPU grid")

    monkeypatch.setattr(_kernels, "lib", no_build)
    monkeypatch.setattr(icell_kernel, "launches", 0)
    want = interpolate_at_icell_plain(grid, rt, (2, 0), torch.from_numpy(ic))
    for cells in (ic, ic.astype(np.int32), torch.from_numpy(ic),
                  torch.from_numpy(ic.astype(np.int32))):
        got = tiu.interpolate_at_icell(grid, rt, [2, 0], cells)
        assert got.dtype == dt and torch.equal(got, want)
    assert tiu.interpolate_at_icell(grid, rt, [], ic).shape == (300, 0)
    assert icell_kernel.launches == 0
    with pytest.raises(TypeError):
        icell_kernel.interpolate_at_icell_cuda(grid, rt.to(dt), (0,), ic)
    with pytest.raises(IndexError):
        tiu.interpolate_at_icell(grid, rt, [3], ic)


# ---------------------------------------------------------------------
# E1 against the plain version, on the card


def _cuda_grid(mesh, dtype, dev, cfg=HOST):
    return _build(mesh, dtype, dev, cfg)


def _e1(grid, r, slots, ic):
    """E1 through interpolate_at_icell; asserts one launch (none for no
    slots)."""
    icell_kernel.launches = 0
    out = tiu.interpolate_at_icell(grid, r, slots, ic)
    torch.cuda.synchronize()
    assert icell_kernel.launches == (1 if slots else 0)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["small", "large"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cuda_icell_equals_plain(cuda, mesh, dtype, route):
    dt = DTYPES[dtype]
    grid = _cuda_grid(mesh, dt, cuda)
    b = _batch(grid, route)
    r, ic = _inputs(grid, b)
    rt = torch.from_numpy(r).to(cuda, dt)
    for sl in SLOTS.values():
        for cells in (torch.from_numpy(ic).to(cuda),
                      torch.from_numpy(ic).to(cuda, torch.int32), ic):
            got = _e1(grid, rt, sl, cells)
            want = interpolate_at_icell_plain(
                grid, rt, sl, torch.from_numpy(ic).to(cuda))
            assert got.dtype == dt and got.shape == (b, len(sl))
            assert torch.equal(got, want), (sl, type(cells))


@pytest.mark.cuda
def test_cuda_icell_refuses(cuda):
    """Out-of-range slots and a non-contiguous point_data raise, as do
    points, cells or cell_volume that are strided, cells or volumes of
    another dtype, or cells off a 16-byte boundary: nothing is copied; a grid without
    walk rows answers as the plain version; no slots give (B, 0)
    without a launch."""
    grid = _cuda_grid("tetra", torch.float32, cuda)
    r, ic = _inputs(grid, 500)
    rt = torch.from_numpy(r).to(cuda, torch.float32)
    for bad in ([3], [-4]):
        with pytest.raises(IndexError):
            tiu.interpolate_at_icell(grid, rt, bad, ic)
    strided = dataclasses.replace(
        grid, point_data=torch.cat([grid.point_data] * 2, dim=1)[:, ::2])
    assert not strided.point_data.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        tiu.interpolate_at_icell(strided, rt, [0], ic)
    for name, t in (
            ("points", torch.cat([grid.points] * 2, dim=1)[:, ::2]),
            ("cells", grid.cells.long()),
            ("cells", torch.cat([grid.cells] * 2, dim=1)[:, ::2]),
            ("cell_volume", torch.stack([grid.cell_volume] * 2, 1)[:, 0]),
            ("cell_volume", grid.cell_volume.double())):
        with pytest.raises(TypeError, match=name):
            tiu.interpolate_at_icell(dataclasses.replace(grid, **{name: t}),
                                     rt, [0], ic)
    shifted = torch.cat([grid.cells.new_zeros(1), grid.cells.reshape(-1)])
    off = dataclasses.replace(grid, cells=shifted[1:].reshape(-1, 4))
    assert off.cells.is_contiguous() and off.cells.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tiu.interpolate_at_icell(off, rt, [0], ic)
    bare = _e1(dataclasses.replace(grid, walk_table=None), rt, [0, 2], ic)
    assert torch.equal(bare, interpolate_at_icell_plain(
        grid, rt, [0, 2], torch.from_numpy(ic).to(cuda)))
    assert _e1(grid, rt, [], ic).shape == (500, 0)


@pytest.mark.cuda
def test_cuda_icell_clamps_cells(cuda):
    """Cells are not validated: E1 reads cell 0 for a negative id, as
    the plain version does, and the last cell for one of n_cells or
    more, where the plain version raises."""
    grid = _cuda_grid("tetra", torch.float32, cuda)
    r, _ = _inputs(grid, 500)
    rt = torch.from_numpy(r).to(cuda, torch.float32)
    n = grid.n_cells
    for given, read in ((-3, 0), (n, n - 1), (n + 1000, n - 1)):
        got = _e1(grid, rt, [0], torch.full((500,), given, device=cuda))
        want = interpolate_at_icell_plain(
            grid, rt, [0], torch.full((500,), read, device=cuda))
        assert torch.equal(got, want), given


def _paths_grid(cuda, cfg):
    pts, cells, nbrs = meshgen.tet_box_mesh(8, 8, 8)
    return pts, tiu.build_grid(pts, cells, nbrs, "tetra",
                               point_data=_point_data(pts),
                               locate_mode="walk", config=cfg, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("cand", [True, False])
def test_cuda_interpolate_at_reaches_e1(cuda, cand):
    """Warm interpolate_at (and cold, on a grid without candidate
    tables): one E1 launch a call, values torch.equal to the plain
    version at the cells found."""
    cfg = HOST if cand else dataclasses.replace(HOST,
                                                use_candidate_bins=False)
    _, grid = _paths_grid(cuda, cfg)
    rng = np.random.default_rng(8)
    r = torch.from_numpy(0.05 + 0.9 * rng.random((5000, 3))).to(
        cuda, torch.float32)
    ic0, _ = tiu.get_cell(grid, r)
    calls = [("warm", r + 0.01, ic0)]
    if not cand:
        calls.insert(0, ("cold", r, None))
    for label, q, guess in calls:
        icell_kernel.launches = 0
        vals, ic, found = tiu.interpolate_at(grid, q, [1, 0], guess=guess)
        torch.cuda.synchronize()
        assert icell_kernel.launches == 1, label
        assert bool(found.all())
        want = interpolate_at_icell_plain(grid, q, [1, 0], ic)
        assert torch.equal(vals, want), label


@pytest.mark.cuda
def test_cuda_float64_cold_reaches_e1(cuda):
    """A float64 tet box whose K = 7 rows fuse no variable: every cold
    value comes from E1, torch.equal to the plain version."""
    pts, cells, nbrs = meshgen.tet_box_mesh(20, 20, 20)
    grid = tiu.build_grid(pts, cells, nbrs, "tetra", dtype=torch.float64,
                          point_data=_point_data(pts), locate_mode="walk",
                          config=HOST, device=cuda)
    assert grid.cand_ids.shape[1] == 7 and cand_table.fused_nv(grid) == 0
    r = torch.from_numpy(np.random.default_rng(9).random((20000, 3))).to(
        cuda)
    icell_kernel.launches = 0
    vals, ic, found = tiu.interpolate_scalar_at(grid, r, 0)
    torch.cuda.synchronize()
    assert icell_kernel.launches == 1 and bool(found.all())
    want = interpolate_at_icell_plain(grid, r, [0], ic)[:, 0]
    assert torch.equal(vals, want)
    assert float((vals - (r.sum(1) + 1.0)).abs().max()) <= 1e-14


@pytest.mark.cuda
def test_cuda_trace_start_field_from_e1(cuda):
    """A fused float32 trace: the start field is one E1 launch, and the
    first field sample of every line is the plain version's value at
    the start cell."""
    pts, grid = _paths_grid(cuda, dataclasses.replace(
        HOST, use_candidate_bins=False))
    c = grid.points[:, :2] - 0.5
    i_field = []
    for name, v in zip(("vx", "vy", "vz"),
                       (-c[:, 1], c[:, 0], torch.full_like(c[:, 0], 0.25))):
        grid, i = tiu.add_point_data(grid, name, v, fuse=False)
        i_field.append(i)
    y0 = torch.from_numpy(0.3 + 0.4 * np.random.default_rng(3).random(
        (256, 3))).to(cuda, torch.float32)
    icell_kernel.launches = 0
    out = tiu.integrate_along_field(grid, y0, i_field, min_dx=1e-4,
                                    max_dx=0.05, max_steps=32, rtol=1e-3,
                                    atol=1e-3)
    torch.cuda.synchronize()
    assert icell_kernel.launches == 1
    ic0, found0 = tiu.get_cell(grid, y0)
    assert bool(found0.all())
    want = interpolate_at_icell_plain(grid, y0, i_field, ic0)
    assert torch.equal(out.y_field[:, 0], want)
