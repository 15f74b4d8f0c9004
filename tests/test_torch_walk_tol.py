"""The walk tolerances a grid holds (``Grid.walk_tol``).

``(nudge, eps_arrive)`` depend only on the grid's dtype and extent, so
the grid computes them once as it is made and every walk reads the held
Python floats instead of reading ``rmin`` / ``rmax`` back from the
device.  Held, they equal ``utils/config.walk_tolerances(dtype, rmin,
rmax)`` bit for bit, in float32 and float64, on every route that makes
a grid: ``build_grid``, ``load_grid`` of the port's own checkpoint and
of the JAX package's (``tests/data/jax_tet3_checkpoint.binda``),
``grid_from_numpy``, and every ``dataclasses.replace`` (the
data-registry edits, ``prepare_accurate``, a device move, a plain
replace).  And the walks read them: on a grid whose extent is poisoned
with NaN after it was made, the walk-grid ``get_cell`` (cold and warm),
``walk`` and both tracer paths give the original grid's answers bit for
bit.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models import grid as tgrid
from interpolate_unstructured_tpu_torch.ops import locate
from interpolate_unstructured_tpu_torch.utils import meshgen
from interpolate_unstructured_tpu_torch.utils.config import walk_tolerances

JAX_CKPT = Path(__file__).parent / "data" / "jax_tet3_checkpoint.binda"
DTYPES = {"float32": torch.float32, "float64": torch.float64}
TRACE_KW = dict(min_dx=1e-3, max_dx=0.05, max_steps=24, rtol=1e-3,
                atol=1e-3)


def _mesh():
    """A 4^3 tet box moved off the unit cube, so both ends of the extent
    count, with a linear field and a helix."""
    pts, cells, nbrs = meshgen.tet_box_mesh(4, 4, 4)
    pts = pts * 2.5 - 0.75
    pd = {"a": pts[:, 0] + 2 * pts[:, 1] - pts[:, 2],
          "hx": -(pts[:, 1] - 0.5), "hy": pts[:, 0] - 0.5,
          "hz": 0.25 + 0 * pts[:, 0]}
    return pts, cells, nbrs, pd


def _build(dtype, **kw):
    pts, cells, nbrs, pd = _mesh()
    kw.setdefault("locate_mode", "walk")
    return tiu.build_grid(pts, cells, nbrs, "tetra", point_data=pd,
                          dtype=dtype, device="cpu", **kw)


def _carried(dtype):
    """The grid's state carried over as host arrays."""
    g = _build(dtype)
    leaves = {f: None if getattr(g, f) is None
              else getattr(g, f).numpy() for f in tgrid.DATA_FIELDS}
    return tiu.grid_from_numpy(
        leaves, {f: getattr(g, f) for f in tgrid.META_FIELDS}, "cpu")


def _saved(dtype, tmp_path):
    fn = tmp_path / "grid.binda"
    tiu.save_grid(_build(dtype), fn)
    return tiu.load_grid(fn, device="cpu")


def _replaced(edit):
    """A grid built, then edited by ``edit`` (a replace)."""
    return lambda dtype, tmp_path: edit(_build(dtype))


ROUTES = {
    "build_grid": lambda dtype, tmp_path: _build(dtype),
    "build_grid.candidates": lambda dtype, tmp_path: _build(
        dtype, config=tiu.IUConfig(cand_build="host")),
    "build_grid.bruteforce": lambda dtype, tmp_path: _build(
        dtype, locate_mode="bruteforce"),
    "load_grid.port": _saved,
    "load_grid.jax": lambda dtype, tmp_path: tiu.load_grid(
        JAX_CKPT, dtype=dtype, device="cpu"),
    "grid_from_numpy": lambda dtype, tmp_path: _carried(dtype),
    "replace.add_point_data": _replaced(
        lambda g: tiu.add_point_data(g, "b", np.arange(g.n_points) * 0.5,
                                     fuse=False)[0]),
    "replace.add_cell_data": _replaced(
        lambda g: tiu.add_cell_data(g, "c", np.ones(g.n_cells))[0]),
    "replace.add_icell_data": _replaced(
        lambda g: tiu.add_icell_data(g, "m", np.zeros(g.n_cells,
                                                      np.int32))[0]),
    "replace.set_point_data": _replaced(
        lambda g: tiu.set_point_data(g, 0, np.zeros(g.n_points))),
    "replace.to_same_device": _replaced(lambda g: g.to("cpu")),
    "replace.recomputed": _replaced(
        lambda g: dataclasses.replace(g)),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_held_tolerances_match_walk_tolerances(route, dtype, tmp_path):
    g = ROUTES[route](DTYPES[dtype], tmp_path)
    assert g.dtype == DTYPES[dtype]
    want = walk_tolerances(g.dtype, g.rmin, g.rmax)
    assert all(type(t) is float for t in g.walk_tol)
    assert g.walk_tol == want
    np_dtype = np.dtype(dtype)
    assert all(float(np_dtype.type(t)) == t for t in g.walk_tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prepare_accurate_carries_the_tolerances(dtype):
    g = _build(DTYPES[dtype], config=tiu.IUConfig(cand_build="host"))
    acc = tiu.prepare_accurate(g, build_df=dtype == "float32")
    assert acc.walk_tol == g.walk_tol == walk_tolerances(
        acc.dtype, acc.rmin, acc.rmax)


def _poisoned(g):
    """A copy of ``g`` whose extent is overwritten with NaN after it was
    made, its tolerances kept: a walk that read the extent would walk
    with NaN tolerances."""
    g = dataclasses.replace(g)
    nan = torch.full_like(g.rmin, float("nan"))
    object.__setattr__(g, "rmin", nan)
    object.__setattr__(g, "rmax", nan.clone())
    return g


def _walk_calls(g):
    gen = torch.Generator().manual_seed(5)
    r = torch.rand(300, 3, generator=gen, dtype=torch.float64) * 2.5 - 0.75
    r1 = r + 0.2 * (torch.rand(300, 3, generator=gen,
                               dtype=torch.float64) - 0.5)
    y0 = 0.3 + 0.4 * torch.rand(16, 3, generator=gen, dtype=torch.float64)
    fields = (1, 2, 3)
    table = tiu.build_trace_table(g, fields)

    def walk(grid):
        ic0, _ = tiu.get_cell(grid, r)
        return locate.walk(grid, r, r1, ic0.clamp_min(0))

    def trace(grid):
        return tuple(tiu.integrate_along_field(grid, y0, fields,
                                               trace_table=table, **TRACE_KW))

    return {
        "get_cell.cold": lambda grid: tiu.get_cell(grid, r),
        "get_cell.warm": lambda grid: tiu.get_cell(
            grid, r1, torch.arange(300, dtype=torch.int32) % grid.n_cells),
        "walk": walk,
        "trace": trace,
    }


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("call", ["get_cell.cold", "get_cell.warm", "walk",
                                  "trace"])
def test_walks_read_the_held_tolerances(call, dtype):
    """Float32 traces take the fused path (B4's plain version), float64
    ones the generic loop with its walks."""
    g = _build(DTYPES[dtype],
               config=tiu.IUConfig(use_candidate_bins=False))
    f = _walk_calls(g)[call]
    want, got = f(g), f(_poisoned(g))
    for a, b in zip(want, got, strict=True):
        if a is not None:
            assert torch.equal(a, b)
