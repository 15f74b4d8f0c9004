"""The port's Grid API against the JAX package's: ``n_cell_data``,
``n_icell_data``, ``cell_centers()`` and the ``UGrid`` name.

``cell_centers()`` is bit for bit the JAX package's on the CPU in both
dtypes and every cell type: the vertices summed left to right, times
the reciprocal of their count (XLA on the CPU computes ``jnp.mean``'s
division by 3 as that product, one ulp away from a division on some
triangles).
"""

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.utils import meshgen


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests:
    on some virtualized hosts a worker thread's first float32
    torch.sqrt in a process is off by ~1e-4 relative."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


def _mesh(cell_type):
    """A mesh of ``cell_type`` with its vertices moved by up to 1e-3, so
    the centroids are not round numbers."""
    pts, cells, nbrs = {
        "triangle": lambda: meshgen.triangle_rect_mesh(9, 8),
        "quad": lambda: meshgen.quad_rect_mesh(9, 8),
        "tetra": lambda: meshgen.tet_box_mesh(5, 4, 3),
    }[cell_type]()
    pts = pts + np.random.default_rng(1).random(pts.shape) * 1e-3
    if cell_type != "tetra":
        pts[:, 2] = 0.0
    return pts, cells, nbrs


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("cell_type", ["triangle", "quad", "tetra"])
def test_grid_api_matches_jax(cell_type, dtype):
    """The data counts after adding point, cell and icell variables,
    and the cell centers bit for bit, on the same mesh."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu

    pts, cells, nbrs = _mesh(cell_type)
    n = len(cells)
    grids = [
        jiu.build_grid(pts, cells, nbrs, cell_type,
                       point_data={"p": pts.sum(1)},
                       dtype=getattr(jnp, dtype)),
        tiu.build_grid(pts, cells, nbrs, cell_type,
                       point_data={"p": pts.sum(1)},
                       dtype=getattr(torch, dtype), device="cpu"),
    ]
    for i, pkg in enumerate((jiu, tiu)):
        g = grids[i]
        assert (g.n_point_data, g.n_cell_data, g.n_icell_data) == (1, 0, 0)
        g, _ = pkg.add_cell_data(g, "c0", np.arange(n, dtype=np.float64))
        g, _ = pkg.add_cell_data(g, "c1")
        g, _ = pkg.add_icell_data(g, "mat", np.arange(n) % 3)
        grids[i] = g
    ug, tg = grids
    assert (tg.n_point_data, tg.n_cell_data, tg.n_icell_data) == (
        ug.n_point_data, ug.n_cell_data, ug.n_icell_data) == (1, 2, 1)
    want = np.asarray(ug.cell_centers())
    got = tg.cell_centers()
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ugrid_is_the_grid_class():
    """UGrid is a second name for Grid, exported beside it."""
    assert tiu.UGrid is tiu.Grid
    assert {"Grid", "UGrid"} <= set(tiu.__all__)
    pts, cells, nbrs = _mesh("tetra")
    g = tiu.build_grid(pts, cells, nbrs, "tetra", device="cpu")
    assert isinstance(g, tiu.UGrid)
    c = g.cell_centers()
    assert torch.equal(c, tiu.Grid.cell_centers(g))
    np.testing.assert_allclose(c.numpy(), pts[cells].mean(axis=1), rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
def test_cuda_cell_centers_match_cpu():
    """On the card, the same additions and product give the CPU's
    bits, in both dtypes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell_type in ("triangle", "tetra"):
        pts, cells, nbrs = _mesh(cell_type)
        for dtype in (torch.float32, torch.float64):
            cpu = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=dtype,
                                 device="cpu")
            assert torch.equal(cpu.to("cuda").cell_centers().cpu(),
                               cpu.cell_centers())
