"""Kernel B1 (brute-force locate + interpolate) against the JAX package.

The JAX package's Pallas kernel runs in interpret mode
(``interpolate_bruteforce_pallas(..., interpret=True)``) on a float32
grid; the same grid is carried into the port with ``grid_from_numpy``
and the port's plain version runs on the same queries.  Cell ids and
found masks must be identical and values agree to 1e-6 absolute.  The
CUDA kernel is held against the plain version where a card exists, bit
for bit (``torch.equal`` on ids, found masks and values; queries with an
inf or NaN coordinate on ids and found masks); those tests use the port
alone, so that on a machine without jax they run with
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.utils import meshgen
from interpolate_unstructured_tpu_torch.models.grid import (
    DATA_FIELDS,
    META_FIELDS,
)
from interpolate_unstructured_tpu_torch.ops import interp_kernel

MESHES = {
    "triangle": lambda: meshgen.triangle_rect_mesh(4, 3),
    "quad": lambda: meshgen.quad_rect_mesh(5, 4),
    "tetra": lambda: meshgen.tet_box_mesh(3, 3, 3),
}


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests.

    On some virtualized x86 hosts the first float32 torch.sqrt that a worker
    thread runs in a process returns values off by ~1e-4 relative for
    that thread's chunk; every later call is exact.  The plain versions
    under test call torch.sqrt (triangle and quad weights), so the
    first, discarded call is made here."""
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
    from interpolate_unstructured_tpu.ops import pallas_interp

    return jnp, jiu, pallas_interp


def carry(ug, device="cpu"):
    """The JAX grid's state as a port grid (bit-identical tables)."""
    leaves = {
        f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
        for f in DATA_FIELDS
    }
    return tiu.grid_from_numpy(
        leaves, {f: getattr(ug, f) for f in META_FIELDS}, device
    )


def _point_data(pts):
    return {"Polynomial": pts.sum(1) + 1.0, "XY": pts[:, 0] * pts[:, 1]}


def _queries(pts, n):
    rng = np.random.default_rng(11)
    lo, hi = pts.min(0), pts.max(0)
    span = np.where(hi > lo, hi - lo, 0.0)
    # inside the box plus a 10% margin around it: misses included
    return (lo - 0.1 * span + rng.random((n, 3)) * 1.2 * span).astype(
        np.float32
    )


def _jax_grid_and_queries(cell_type, n=2000):
    jnp, jiu, _ = _jax()
    pts, cells, nbrs = MESHES[cell_type]()
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jnp.float32,
                        point_data=_point_data(pts))
    assert ug.locate_mode == "bruteforce"
    return ug, _queries(pts, n)


@pytest.mark.parametrize("n_vars", [1, 2])
@pytest.mark.parametrize("cell_type", list(MESHES))
def test_plain_matches_pallas_interpret(cell_type, n_vars):
    jnp, _, pallas_interp = _jax()
    ug, r = _jax_grid_and_queries(cell_type)
    iv = list(range(n_vars))
    jv, jic, jf = pallas_interp.interpolate_bruteforce_pallas(
        ug, jnp.asarray(r), jnp.asarray(iv), interpret=True
    )
    tv, tic, tf = interp_kernel.interpolate_bruteforce_plain(
        carry(ug), torch.from_numpy(r), iv
    )
    jf = np.asarray(jf)
    assert 0 < jf.sum() < len(r)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tic.numpy(), np.asarray(jic))
    assert tv.shape == (len(r), n_vars) and tic.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


def _port_grid_and_queries(cell_type, n, device="cpu"):
    pts, cells, nbrs = MESHES[cell_type]()
    g = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                       point_data=_point_data(pts), device=device)
    assert g.locate_mode == "bruteforce"
    return g, torch.from_numpy(_queries(pts, n)).to(device)


def test_wrapper_takes_plain_version_on_cpu():
    g, r = _port_grid_and_queries("tetra", 256)
    before = interp_kernel.launches
    out = interp_kernel.interpolate_bruteforce(g, r, [0])
    ref = interp_kernel.interpolate_bruteforce_plain(g, r, [0])
    assert interp_kernel.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_type", list(MESHES))
def test_cuda_kernel_matches_plain(cuda, cell_type):
    g, rq = _port_grid_and_queries(cell_type, 50_000, cuda)
    before = interp_kernel.launches
    kv, kic, kf = interp_kernel.interpolate_bruteforce(g, rq, [0, 1])
    torch.cuda.synchronize()
    assert interp_kernel.launches == before + 1
    pv, pic, pf = interp_kernel.interpolate_bruteforce_plain(g, rq, [0, 1])
    assert torch.equal(kf, pf) and torch.equal(kic, pic)
    assert torch.equal(kv, pv)
    with pytest.raises(TypeError):
        interp_kernel.interpolate_bruteforce(g, rq.double(), [0])


def _assert_kernel_equals_plain(g, rq, i_vars, **config):
    kv, kic, kf = interp_kernel.interpolate_bruteforce_cuda(g, rq, i_vars,
                                                            **config)
    pv, pic, pf = interp_kernel.interpolate_bruteforce_plain(g, rq, i_vars)
    assert torch.equal(kf, pf) and torch.equal(kic, pic)
    assert torch.equal(kv, pv)
    return kf


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 50_001])
@pytest.mark.parametrize("cell_type", list(MESHES))
def test_cuda_batch_sizes(cuda, cell_type, n):
    """Batches that are no multiple of a block's queries (the kernel's
    queries a thread times its threads), and one query."""
    g, rq = _port_grid_and_queries(cell_type, n, cuda)
    _assert_kernel_equals_plain(g, rq, [1, 0])


def _single_tet():
    pts, cells, _ = meshgen.tet_box_mesh(1, 1, 1)
    return pts[cells[0]], np.arange(4, dtype=cells.dtype)[None], \
        np.full((1, 4), -1, dtype=cells.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["one tet", "1024 quads", "3072 tets"])
def test_cuda_cell_counts(cuda, mesh):
    """One cell; a plane table that fills the 64 KB a block stages
    (1024 quads); and a grid above it (3072 tets, a config with a larger
    ``bruteforce_max_cells``), which the kernel takes in tiles.  The
    wrapper's configuration and others of the sweep's (queries a thread,
    threads a block)."""
    cell_type, (pts, cells, nbrs), cfg = {
        "one tet": ("tetra", _single_tet(), tiu.IUConfig()),
        "1024 quads": ("quad", meshgen.quad_rect_mesh(32, 32),
                       tiu.IUConfig()),
        "3072 tets": ("tetra", meshgen.tet_box_mesh(8, 8, 8),
                      tiu.IUConfig(bruteforce_max_cells=4096)),
    }[mesh]
    g = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                       point_data=_point_data(pts), config=cfg, device=cuda)
    assert g.locate_mode == "bruteforce"
    rq = torch.from_numpy(_queries(pts, 20_000)).to(cuda)
    kf = _assert_kernel_equals_plain(g, rq, [0, 1])
    assert 0 < int(kf.sum()) < rq.shape[0]
    for q, threads in ((1, 128), (2, 256), (4, 512)):
        _assert_kernel_equals_plain(g, rq, [1], q=q, threads=threads)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_type", list(MESHES))
def test_cuda_nonfinite_queries(cuda, cell_type):
    """Queries with an inf or NaN coordinate among finite ones: ids and
    found masks as the plain version's (amin and argmax propagate NaN),
    the finite queries bit for bit."""
    g, rq = _port_grid_and_queries(cell_type, 4096, cuda)
    bad = torch.tensor([float("inf"), float("-inf"), float("nan")],
                       device=cuda)
    for i in range(24):
        rq[97 * i + 5, i % 3] = bad[i % 3]
    kv, kic, kf = interp_kernel.interpolate_bruteforce_cuda(g, rq, [0])
    pv, pic, pf = interp_kernel.interpolate_bruteforce_plain(g, rq, [0])
    assert torch.equal(kf, pf) and torch.equal(kic, pic)
    fin = torch.isfinite(rq).all(1)
    assert torch.equal(kv[fin], pv[fin])
