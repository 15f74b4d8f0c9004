"""The kernels' FMA form of the df32 product against the plain versions.

The CUDA kernels (``csrc/df32.cuh``) take a float32 product's rounding
error from one exact fused multiply-add, ``e = fma(a, b, -p)``; the
plain versions (``ops/df32.py``) keep the JAX package's Dekker split
product.  What the FMA returns is ``f32(f64(a) * f64(b) - f64(p))``: the
float64 product of two float32 values is exact, so is its difference from
``p``, and the one rounding to float32 is the FMA's.  These CPU tests hold
the plain Dekker form against that float64-exact form:

(a) ``two_prod`` alone, on 1M random pairs with exponents from 2^-60 to
    2^60: the same bits wherever no partial product of the split
    underflows below 2^-126 (where one does, the split loses bits, and
    the test shows that the two forms differ only there), and on 1M pairs
    of the test meshes' acc-table hi words;
(b) ``interp_acc_plain`` (kernel B5's plain version) with ``two_prod``
    replaced by the float64-exact form, monkeypatched inside the test:
    ``torch.equal`` to the unpatched version for triangle, quad and
    tetra meshes at coordinate scales 1, 1e-6 and 1e3;
(c) the same for ``cand_rows_df_plain`` (B2-df's plain version) on the
    7x7x7 tet box.
"""

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models import cand_table
from interpolate_unstructured_tpu_torch.ops import (
    acc_kernel,
    cand_kernel,
    df32,
    interp_acc,
)
from interpolate_unstructured_tpu_torch.utils import meshgen

HOST = tiu.IUConfig(cand_build="host")
MESHES = {
    "triangle": lambda: meshgen.triangle_rect_mesh(12, 10),
    "quad": lambda: meshgen.quad_rect_mesh(12, 10),
    "tetra": lambda: meshgen.tet_box_mesh(7, 7, 7),
}
SCALES = (1.0, 1e-6, 1e3)
TINY = 2.0 ** -126  # least normal float32


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests: on
    some virtualized hosts the first float32 torch.sqrt a worker thread
    runs in a process is off by ~1e-4 relative (PERF.md §7), and the df32
    triangle and quad weights take square roots."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


def fma_two_prod(a, b):
    """The kernels' two_prod on the CPU: p = fl(a * b), e = the exact
    error rounded once to float32, as ``__fmaf_rn(a, b, -p)`` gives it."""
    p = a * b
    return p, (a.double() * b.double() - p.double()).to(torch.float32)


def _split_underflows(a, b):
    """Pairs where a partial product of Dekker's 12/12-bit split is
    nonzero and below 2^-126 in magnitude."""
    ah, al = df32._split(a)
    bh, bl = df32._split(b)
    out = torch.zeros_like(a, dtype=torch.bool)
    for x, y in ((ah, bh), (ah, bl), (al, bh), (al, bl)):
        m = (x.double() * y.double()).abs()
        out |= (m > 0) & (m < TINY)
    return out


def _grid(cell_type, scale, build_df=False):
    """A float32 grid of the mesh at ``scale``, nonlinear float64 data in
    two variables, prepared for accurate mode."""
    pts, cells, nbrs = MESHES[cell_type]()
    p64 = np.asarray(pts, np.float64) * scale
    rng = np.random.default_rng(9)
    data = {
        "D0": np.sin(3 * p64[:, 0] / scale) * p64[:, 1]
        + rng.random(len(p64)) * 1e-3,
        "D1": np.cos(2 * p64[:, 1] / scale) + p64[:, 0] * 7.0,
    }
    g = tiu.build_grid(pts, cells, nbrs, cell_type, point_data=data,
                       dtype=torch.float32, locate_mode="walk",
                       coord_scale_factor=scale, config=HOST, device="cpu")
    return interp_acc.prepare_accurate(g, build_df=build_df), p64, cells


_GRIDS = {}


def _grid_cached(cell_type, scale, build_df=False):
    key = (cell_type, scale, build_df)
    if key not in _GRIDS:
        _GRIDS[key] = _grid(cell_type, scale, build_df)
    return _GRIDS[key]


def _inside(p64, cells, n, seed):
    """(cells (n,) int32, float64 queries (n, 3)): a random convex
    combination of the vertices of a random cell each."""
    rng = np.random.default_rng(seed)
    ic = rng.integers(0, len(cells), n)
    w = rng.random((n, cells.shape[1])) + 0.05
    w /= w.sum(1, keepdims=True)
    r = np.einsum("nk,nkd->nd", w, p64[cells[ic]])
    return torch.from_numpy(ic.astype(np.int32)), torch.from_numpy(r)


def _with_fma(monkeypatch):
    """Replace df32.two_prod by the FMA form; return its call counter."""
    calls = [0]

    def counted(a, b):
        calls[0] += 1
        return fma_two_prod(a, b)

    monkeypatch.setattr(df32, "two_prod", counted)
    return calls


def _pairs_by_exponent(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, (2, n)) * rng.choice([-1.0, 1.0], (2, n))
    return (mant * np.exp2(rng.integers(lo, hi + 1, (2, n)))).astype(
        np.float32)


def _pairs_of_hi_words(n, seed):
    words = []
    for cell_type in MESHES:
        for scale in SCALES:
            g, _, _ = _grid_cached(cell_type, scale)
            npc = g.n_points_per_cell
            t = g.acc_table
            hi_cols = list(range(npc * 3)) + [
                npc * 6 + j for j in range(npc * g.n_point_data)]
            words.append(t[:, hi_cols].reshape(-1).numpy())
    words = np.concatenate(words)
    words = words[words != 0]
    rng = np.random.default_rng(seed)
    return words[rng.integers(0, len(words), (2, n))]


@pytest.mark.parametrize("pairs", ["exponents 2^-60..2^60", "acc hi words"])
def test_dekker_two_prod_equals_fma_form(pairs):
    n = 1_000_000
    a, b = (torch.from_numpy(x) for x in (
        _pairs_by_exponent(n, -60, 60, 3) if pairs.startswith("exp")
        else _pairs_of_hi_words(n, 4)))
    p, e = df32.two_prod(a, b)
    pf, ef = fma_two_prod(a, b)
    assert torch.equal(p, pf)
    under = _split_underflows(a, b)
    differ = e != ef
    assert not bool((differ & ~under).any())
    if pairs.startswith("exp"):
        # the range reaches products near 2^-120, where the split
        # underflows; most pairs are far from it
        assert 0 < int(under.sum()) < n // 20
    else:
        assert not bool(under.any())
    assert bool((ef != 0).any())


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("cell_type", list(MESHES))
def test_interp_acc_plain_equals_fma_form(monkeypatch, cell_type, scale):
    g, p64, cells = _grid_cached(cell_type, scale)
    ic, r64 = _inside(p64, cells, 20_000, 5)
    r_hi, r_lo = df32.split_queries(r64)
    assert bool((r_lo != 0).any())
    args = (g.acc_table, ic, r_hi, r_lo, g.cell_type, g.n_points_per_cell,
            g.n_point_data, (1, 0))
    want = acc_kernel.interp_acc_plain(*args)
    calls = _with_fma(monkeypatch)
    got = acc_kernel.interp_acc_plain(*args)
    assert calls[0] > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(want[0]).all() and (want[1] != 0).any())


def test_cand_rows_df_plain_equals_fma_form(monkeypatch):
    g, p64, _ = _grid_cached("tetra", 1.0, build_df=True)
    assert g.cand_df_table is not None
    rng = np.random.default_rng(6)
    r64 = torch.from_numpy(0.02 + 0.96 * rng.random((20_000, 3)))
    r64[-1000:, 0] += 1.1  # misses outside the box
    lay = cand_table.df_layout(g, (0,))
    bins = (g.cand_rmin, g.cand_inv_h, g.cand_shape)
    eps = cand_table.probe_eps(g)
    args = (g.cand_df_table, r64, None, *bins, lay, eps, lay.k, 8192)
    want = cand_kernel.cand_rows_df_plain(*args)
    calls = _with_fma(monkeypatch)
    got = cand_kernel.cand_rows_df_plain(*args)
    assert calls[0] > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((want[1] == -2).any()) and not bool((want[1] == -2).all())
