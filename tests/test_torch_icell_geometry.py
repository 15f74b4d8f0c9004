"""Where kernel E1 reads a cell's geometry: ``grid.points`` through
``grid.cells``, with the volume from ``grid.cell_volume``.

E1 (``csrc/interp_icell.cu``) equals ``interpolate_at_icell_plain`` bit
for bit only if ``grid.points[grid.cells]`` equals ``grid.cell_points``
(of which the walk rows hold copies) bit for bit.  On the CPU these
tests hold that invariant on every route that makes a grid:
``build_grid`` of triangles, quads and tets in float32 and float64,
with and without ``coord_scale_factor``; ``read_grid`` of a .vtu the
port wrote; ``load_grid`` of the port's own checkpoints (a float64 one
also loaded as float32) and of the JAX package's, among them
``tests/data/jax_tet3_checkpoint.binda`` (a 162-tet float32 candidate
grid the JAX package saved; a test checks that it still writes those
bytes); ``grid_from_numpy`` of a JAX package grid; ``Grid.to``.  Then a
CPU function that reads in E1's order (:func:`icell_e1_order`) is held
``torch.equal`` to the plain version and to the JAX package's
``interpolate_at_icell`` within the tolerances of
``tests/test_torch_icell_kernel.py`` (float32 2e-6, float64 1e-14), on
the three cell types, both dtypes, V = 0/1/3, a negative slot and cells
of -1; and the plain version on a grid without walk rows against the
JAX package's (its ``cell_weights`` route).

The ``cuda`` cases (skipped without a card) hold E1 ``torch.equal`` to
the plain version on a grid whose walk rows are NaN, on one without walk
rows, on the JAX package's checkpoint loaded onto the card, and the
invariant across ``Grid.to``.  They use the port alone, so that on a
machine without jax they run with ``python -m pytest --noconftest -m
cuda tests/test_torch_*.py``.
"""

import dataclasses
import filecmp
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models import grid as tgrid
from interpolate_unstructured_tpu_torch.ops import icell_kernel
from interpolate_unstructured_tpu_torch.ops.interp import (
    _weights_from_geometry,
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
SLOTS = {"v0": (), "v1": (0,), "v3": (2, 0, 1), "neg": (-1, 1)}
JAX_CKPT = Path(__file__).parent / "data" / "jax_tet3_checkpoint.binda"


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


def _build(name, dtype, device="cpu", scale=None):
    pts, cells, nbrs = _mesh(name)
    return tiu.build_grid(pts, cells, nbrs, MESHES[name][0], dtype=dtype,
                          point_data=_point_data(pts), locate_mode="walk",
                          coord_scale_factor=scale, config=HOST,
                          device=device)


def assert_gather_is_cell_points(grid):
    """grid.points[grid.cells] is grid.cell_points, bit for bit, and the
    walk rows' geometry segment holds the same values."""
    got = grid.points[grid.cells.long()]
    assert got.dtype == grid.cell_points.dtype
    assert torch.equal(got, grid.cell_points)
    if grid.walk_table is not None:
        nf, npc = grid.n_faces_per_cell, grid.n_points_per_cell
        seg = grid.walk_table[:, nf * 5: nf * 5 + npc * 3]
        assert torch.equal(seg, grid.cell_points.reshape(grid.n_cells, -1))
        assert torch.equal(grid.walk_table[:, nf * 5 + npc * 3],
                           grid.cell_volume)


def icell_e1_order(grid, r, slots, i_cell):
    """``interpolate_at_icell`` read in kernel E1's order, on the CPU:
    the cell clamped at 0, its vertex ids from ``grid.cells``, their
    coordinates from ``grid.points``, the volume from
    ``grid.cell_volume``, the weights of ``ops/interp.py``, and the
    requested columns of ``grid.point_data`` at the vertex ids, summed
    left to right."""
    ic = torch.as_tensor(i_cell).long().clamp_min(0)
    r = torch.as_tensor(r, dtype=grid.dtype)
    vid = grid.cells[ic].long()  # (B, npc)
    w = _weights_from_geometry(grid.cell_type, grid.points[vid],
                               grid.cell_volume[ic], r)
    cols = torch.as_tensor(slots, dtype=torch.long)
    x = grid.point_data[:, cols][vid]  # (B, npc, V)
    acc = w[:, 0, None] * x[:, 0]
    for k in range(1, grid.n_points_per_cell):
        acc = acc + w[:, k, None] * x[:, k]
    return acc


# ---------------------------------------------------------------------
# points[cells] == cell_points on every route that makes a grid


@pytest.mark.parametrize("scale", [None, 2.5])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_build_grid_gather(mesh, dtype, scale):
    grid = _build(mesh, DTYPES[dtype], scale=scale)
    assert_gather_is_cell_points(grid)
    assert grid.to("cpu") is grid


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", ["triangle", "tetra"])
def test_read_grid_gather(tmp_path, mesh, dtype):
    from interpolate_unstructured_tpu_torch.io.vtk import write_vtu

    pts, cells, _ = _mesh(mesh)
    path = tmp_path / f"{mesh}.vtu"
    write_vtu(path, pts, cells, MESHES[mesh][0], point_data=_point_data(pts))
    assert_gather_is_cell_points(tiu.read_grid(
        path, dtype=DTYPES[dtype], locate_mode="walk", config=HOST,
        device="cpu"))


@pytest.mark.parametrize("load_as", [None, torch.float32])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_checkpoint_gather(tmp_path, dtype, load_as):
    grid = _build("tetra", DTYPES[dtype])
    tiu.save_grid(grid, tmp_path / "g.binda")
    loaded = tiu.load_grid(tmp_path / "g.binda", config=HOST, dtype=load_as,
                           device="cpu")
    assert loaded.dtype == (load_as or DTYPES[dtype])
    assert_gather_is_cell_points(loaded)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", ["quad", "tetra"])
def test_jax_checkpoint_gather(tmp_path, mesh, dtype):
    """The JAX package's checkpoint and its grid carried by
    grid_from_numpy."""
    jnp, jiu = _jax()
    pts, cells, nbrs = _mesh(mesh)
    ug = jiu.build_grid(pts, cells, nbrs, MESHES[mesh][0],
                        dtype=jnp.float32 if dtype == "float32"
                        else jnp.float64, point_data=_point_data(pts),
                        locate_mode="walk",
                        config=jiu.IUConfig(**dataclasses.asdict(HOST)))
    jiu.save_grid(ug, tmp_path / "j.binda")
    assert_gather_is_cell_points(tiu.load_grid(
        tmp_path / "j.binda", config=HOST, device="cpu"))
    leaves = {f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
              for f in tgrid.DATA_FIELDS}
    meta = {f: getattr(ug, f) for f in tgrid.META_FIELDS}
    assert_gather_is_cell_points(tiu.grid_from_numpy(leaves, meta, "cpu"))


def _jax_fixture_grid(jnp, jiu):
    """The grid saved as tests/data/jax_tet3_checkpoint.binda."""
    pts, cells, nbrs = meshgen.tet_box_mesh(3, 3, 3)
    return jiu.build_grid(pts, cells, nbrs, "tetra", dtype=jnp.float32,
                          point_data={"Polynomial": pts.sum(1) + 1.0,
                                      "XY": pts[:, 0] * pts[:, 1]},
                          locate_mode="walk",
                          config=jiu.IUConfig(cand_build="host"))


def test_jax_checkpoint_fixture(tmp_path):
    """The committed JAX checkpoint is what the JAX package writes, and
    it loads as a grid whose gather is its cell_points."""
    jnp, jiu = _jax()
    jiu.save_grid(_jax_fixture_grid(jnp, jiu), tmp_path / "j.binda")
    assert filecmp.cmp(tmp_path / "j.binda", JAX_CKPT, shallow=False)
    grid = tiu.load_grid(JAX_CKPT, config=tiu.IUConfig(cand_build="host"),
                         device="cpu")
    assert grid.dtype == torch.float32 and grid.n_cells == 162
    assert_gather_is_cell_points(grid)


# ---------------------------------------------------------------------
# E1's reading order against the plain version and the JAX package


def _inputs(grid, b, seed=5):
    """(B, 3) float64 queries and (B,) int64 cells, the last seven
    inside cell 0 given as -1 (tests/test_torch_icell_kernel.py)."""
    from test_torch_icell_kernel import _inputs as inputs

    return inputs(grid, b, seed)


@functools.lru_cache(maxsize=None)
def _grids(name, dtype):
    """(JAX package grid, port CPU grid) of one mesh and dtype."""
    from test_torch_icell_kernel import _grids as grids

    return grids(name, dtype)


@pytest.mark.parametrize("slots", list(SLOTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_e1_order_matches_plain_and_jax(mesh, dtype, slots):
    jnp, jiu = _jax()
    dt = DTYPES[dtype]
    ug, tg = _grids(mesh, dt)
    sl = SLOTS[slots]
    for b in (tg.n_cells // 4 - 1, 2 * tg.n_cells):  # both plain routes
        r, ic = _inputs(tg, b)
        rt, ict = torch.from_numpy(r), torch.from_numpy(ic)
        got = icell_e1_order(tg, rt, sl, ict)
        assert got.dtype == dt and got.shape == (b, len(sl))
        assert torch.equal(got, interpolate_at_icell_plain(tg, rt, sl, ict))
        if sl:
            jv = np.asarray(jiu.interpolate_at_icell(
                ug, jnp.asarray(r, dtype=jnp.float32 if dt == torch.float32
                                else jnp.float64),
                jnp.asarray(sl, dtype=jnp.int32), jnp.asarray(ic)))
            np.testing.assert_allclose(got.numpy(), jv, rtol=0, atol=TOL[dt])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_plain_without_walk_rows(mesh, dtype):
    """A grid without walk rows: the plain version reads cell_points and
    cell_volume (the JAX package's cell_weights route) on a small batch,
    the values of the full grid, and the JAX package's within TOL."""
    jnp, jiu = _jax()
    dt = DTYPES[dtype]
    ug, tg = _grids(mesh, dt)
    bare = dataclasses.replace(tg, walk_table=None)
    ug_bare = dataclasses.replace(ug, walk_table=None)
    sl = (2, 0)
    for b in (tg.n_cells // 4 - 1, 2 * tg.n_cells):
        r, ic = _inputs(tg, b)
        rt, ict = torch.from_numpy(r), torch.from_numpy(ic)
        got = interpolate_at_icell_plain(bare, rt, sl, ict)
        assert torch.equal(got, interpolate_at_icell_plain(tg, rt, sl, ict))
        assert torch.equal(got, tiu.interpolate_at_icell(bare, rt, sl, ict))
        jv = np.asarray(jiu.interpolate_at_icell(
            ug_bare, jnp.asarray(r, dtype=jnp.float32 if dt == torch.float32
                                 else jnp.float64),
            jnp.asarray(sl, dtype=jnp.int32), jnp.asarray(ic)))
        np.testing.assert_allclose(got.numpy(), jv, rtol=0, atol=TOL[dt])


# ---------------------------------------------------------------------
# E1 on the card reads no walk row


def _e1_against_plain(grid, want_grid, inputs, slots=(2, 0)):
    """E1 on ``grid`` torch.equal to the plain version on ``want_grid``
    (one launch) at ``inputs``, queries and cells from :func:`_inputs`."""
    r, ic = inputs
    rt = torch.from_numpy(r).to(grid.device, grid.dtype)
    ict = torch.from_numpy(ic).to(grid.device)
    icell_kernel.launches = 0
    got = tiu.interpolate_at_icell(grid, rt, slots, ict)
    torch.cuda.synchronize()
    assert icell_kernel.launches == 1
    assert torch.equal(got, interpolate_at_icell_plain(want_grid, rt, slots,
                                                       ict))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cuda_icell_reads_no_walk_row(cuda, mesh, dtype):
    grid = _build(mesh, DTYPES[dtype], cuda)
    nan = dataclasses.replace(grid, walk_table=torch.full_like(
        grid.walk_table, float("nan")))
    small, large = (_inputs(grid, b) for b in (grid.n_cells // 4 - 1,
                                               2 * grid.n_cells))
    bare = dataclasses.replace(grid, walk_table=None)
    for inputs in (small, large):
        _e1_against_plain(nan, grid, inputs)
        _e1_against_plain(bare, grid, inputs)
        _e1_against_plain(bare, bare, inputs)


@pytest.mark.cuda
def test_cuda_icell_jax_checkpoint(cuda):
    """The JAX package's checkpoint loaded onto the card."""
    grid = tiu.load_grid(JAX_CKPT, config=tiu.IUConfig(cand_build="host"),
                         device=cuda)
    assert_gather_is_cell_points(grid)
    _e1_against_plain(grid, grid, _inputs(grid, 500), slots=(1, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_grid_to_gather(cuda, dtype):
    """Grid.to in both directions keeps the gather, and E1 on the moved
    grid gives the plain version's values on the grid it came from."""
    host = _build("tetra", DTYPES[dtype])
    dev = host.to(cuda)
    assert_gather_is_cell_points(dev)
    assert_gather_is_cell_points(dev.to("cpu"))
    r, ic = _inputs(host, 2000)
    _e1_against_plain(dev, dev, (r, ic))
    got = tiu.interpolate_at_icell(dev, torch.from_numpy(r).to(cuda),
                                   (0, 1), torch.from_numpy(ic))
    assert torch.equal(got.cpu(), interpolate_at_icell_plain(
        host, torch.from_numpy(r), (0, 1), torch.from_numpy(ic)))
