"""Kernel B3 (the neighbor walk) against the JAX package.

The JAX package's ``locate.walk`` runs both ways it can on the CPU: its
XLA round body, and the Pallas round kernel in interpret mode
(``pallas_walk.supported`` patched, as ``tests/test_pallas_walk.py``
does).  Its float32 walk rows are carried into the port with
``grid_from_numpy``, and the port's ``locate.walk`` (which runs
``walk_kernel.walk_plain`` on CPU tensors) walks the same 1500 lanes:
targets inside, outside and equal to the start (degenerate).

Tolerances: final cell, status and step count identical on every lane
except near-ties, where the final position lies within 4 eps_inside of a
face of either final cell (XLA contracts the JAX side's float32 products
and sums into FMAs, torch rounds each operation, so a ray through an
edge may leave by the other face); final positions within 4e-6, the
tolerance of the JAX package's own kernel-versus-XLA test.

With an icell mask (``i_icell_mask``, the tracer's region) the port's
walk is held to the JAX walk's XLA body, over the walk rows and over the
tracer's trace rows (``table=``).

The CUDA kernel is held against the plain version where a card exists,
with and without a mask; those tests use the port alone.
"""

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models.grid import (
    DATA_FIELDS,
    META_FIELDS,
)
from interpolate_unstructured_tpu_torch.ops import locate, walk_kernel
from interpolate_unstructured_tpu_torch.utils import meshgen

MESHES = {
    "tetra": ("tetra", lambda: meshgen.tet_box_mesh(5, 5, 5)),
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(7, 6)),
}
N_LANES = 1500


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests.

    On some virtualized x86 hosts the first float32 torch.sqrt that a
    worker thread runs in a process returns values off by ~1e-4 relative
    for that thread's chunk; every later call is exact.  ``walk`` takes
    the walk length with torch.sqrt, so the first, discarded call is made
    here."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lanes(grid_cell_points, lo, hi, cell_type, n_cells, seed=11):
    """(ic0, r0, r1): start cells, their centers, and targets inside,
    outside (the box grown by 20% a side) and degenerate (r1 == r0)."""
    rng = np.random.default_rng(seed)
    ic0 = rng.integers(0, n_cells, N_LANES).astype(np.int32)
    r0 = grid_cell_points[ic0].mean(axis=1)
    r1 = lo - 0.2 * (hi - lo) + rng.random((N_LANES, 3)) * 1.4 * (hi - lo)
    r1[: N_LANES // 8] = r0[: N_LANES // 8]
    if cell_type == "triangle":
        r1[:, 2] = 0.0
    return ic0, r0.astype(np.float32), r1.astype(np.float32)


def _near_face(grid, r, ic, band):
    """Whether each position lies within ``band`` of a face plane of its
    cell (a cell of -1 or less never qualifies)."""
    ok = ic >= 0
    c = ic.clamp_min(0).long()
    n = grid.face_normals[c]
    m = grid.face_offsets[c] - (
        (n[..., 0] * r[:, 0, None] + n[..., 1] * r[:, 1, None])
        + n[..., 2] * r[:, 2, None]
    )
    return ok & (m.abs().amin(dim=1) <= band)


def _check_walks(grid, jout, tout):
    """Port walk == JAX walk except near-ties (see the module docstring)."""
    jic, jrp, jsteps, jst = (torch.from_numpy(np.array(x)) for x in jout)
    tic, trp, tsteps, tst = tout
    same = (jic == tic) & (jst == tst) & (jsteps == tsteps)
    differ = torch.nonzero(~same).squeeze(1)
    assert differ.numel() <= 0.01 * N_LANES
    if differ.numel():
        band = 4 * grid.config.eps_inside
        near = _near_face(grid, jrp[differ], jic[differ], band) | _near_face(
            grid, trp[differ], tic[differ], band
        )
        assert bool(near.all()), differ[~near]
    np.testing.assert_allclose(trp[same].numpy(), jrp[same].numpy(),
                               rtol=0, atol=4e-6)
    return tst


@pytest.mark.parametrize("path", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_walk_plain_matches_jax(monkeypatch, mesh, path):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu
    from interpolate_unstructured_tpu.ops import locate as jlocate
    from interpolate_unstructured_tpu.ops import pallas_walk

    cell_type, gen = MESHES[mesh]
    pts, cells, nbrs = gen()
    ug = jiu.build_grid(pts, cells, nbrs, cell_type,
                        point_data={"Polynomial": pts.sum(1) + 1.0},
                        locate_mode="walk", dtype=jnp.float32)
    tg = tiu.grid_from_numpy(
        {f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
         for f in DATA_FIELDS},
        {f: getattr(ug, f) for f in META_FIELDS}, "cpu",
    )
    assert torch.equal(tg.walk_table, torch.from_numpy(np.array(ug.walk_table)))
    ic0, r0, r1 = _lanes(np.asarray(ug.cell_points), np.asarray(ug.rmin),
                         np.asarray(ug.rmax), cell_type, ug.n_cells)

    if path == "pallas-interpret":
        monkeypatch.setattr(pallas_walk, "supported", lambda *a: True)
    jout = jax.jit(lambda g, a, b, c: jlocate.walk(g, a, b, c))(
        ug, jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(ic0)
    )
    before = walk_kernel.launches
    tout = locate.walk(tg, torch.from_numpy(r0), torch.from_numpy(r1),
                       torch.from_numpy(ic0))
    assert walk_kernel.launches == before  # CPU tensors: the plain version
    status = _check_walks(tg, jout, tout)
    # every kind of ending is exercised
    for code in (tiu.STATUS_ARRIVED, tiu.STATUS_BOUNDARY):
        assert (status == code).any()
    assert (tout[2][: N_LANES // 8] == 0).all()  # degenerate lanes
    assert (tout[2] > 1).any()


def test_walk_step_cap_matches_jax():
    """Lanes still walking at a small step cap end with STATUS_STEP_CAP
    and the position and cell of their last round, on both sides."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu
    from interpolate_unstructured_tpu.ops import locate as jlocate

    pts, cells, nbrs = meshgen.tet_box_mesh(5, 5, 5)
    ug = jiu.build_grid(pts, cells, nbrs, "tetra", locate_mode="walk",
                        dtype=jnp.float32)
    tg = tiu.grid_from_numpy(
        {f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
         for f in DATA_FIELDS},
        {f: getattr(ug, f) for f in META_FIELDS}, "cpu",
    )
    ic0, r0, r1 = _lanes(np.asarray(ug.cell_points), np.asarray(ug.rmin),
                         np.asarray(ug.rmax), "tetra", ug.n_cells, seed=12)
    jout = jlocate.walk(ug, jnp.asarray(r0), jnp.asarray(r1),
                        jnp.asarray(ic0), max_steps=3)
    tout = locate.walk(tg, r0, r1, ic0, max_steps=3)
    status = _check_walks(tg, jout, tout)
    assert (status == tiu.STATUS_STEP_CAP).any()
    assert int(tout[2].max()) == 3


def _bands(cell_points, n_bands=3):
    """Mask values: bands of cell centers along x (material regions)."""
    cx = cell_points.mean(axis=1)[:, 0]
    lo, hi = cx.min(), cx.max()
    return np.minimum((cx - lo) / (hi - lo) * n_bands, n_bands - 1).astype(
        np.int32) * 7


@pytest.mark.parametrize("table", ["walk", "trace"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_walk_mask_matches_jax(mesh, table):
    """With ``i_icell_mask``, a hop into a cell of another mask value stops
    on the face with STATUS_MASK_CHANGED, in the cell entered — the JAX
    walk's XLA body (the Pallas kernel takes no mask).  ``table=`` walks
    the tracer's rows instead of the walk rows."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu
    from interpolate_unstructured_tpu.ops import locate as jlocate

    cell_type, gen = MESHES[mesh]
    pts, cells, nbrs = gen()
    cp = pts[cells]
    ug = jiu.build_grid(pts, cells, nbrs, cell_type,
                        point_data={"vx": pts[:, 0], "vy": pts[:, 1]},
                        icell_data={"one": np.ones(len(cells)),
                                    "band": _bands(cp)},
                        locate_mode="walk", dtype=jnp.float32)
    tg = tiu.grid_from_numpy(
        {f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
         for f in DATA_FIELDS},
        {f: getattr(ug, f) for f in META_FIELDS}, "cpu",
    )
    ic0, r0, r1 = _lanes(np.asarray(ug.cell_points), np.asarray(ug.rmin),
                         np.asarray(ug.rmax), cell_type, ug.n_cells, seed=13)
    jtab = ttab = None
    if table == "trace":
        jtab = jiu.build_trace_table(ug, jnp.asarray([0, 1]))
        ttab = tiu.build_trace_table(tg, [0, 1])
    jout = jlocate.walk(ug, jnp.asarray(r0), jnp.asarray(r1),
                        jnp.asarray(ic0), i_icell_mask=1, table=jtab)
    tout = locate.walk(tg, torch.from_numpy(r0), torch.from_numpy(r1),
                       torch.from_numpy(ic0), i_icell_mask=1, table=ttab)
    status = _check_walks(tg, jout, tout)
    for code in (tiu.STATUS_ARRIVED, tiu.STATUS_BOUNDARY,
                 tiu.STATUS_MASK_CHANGED):
        assert (status == code).any()
    band = tg.icell_data[:, 1]
    changed = status == tiu.STATUS_MASK_CHANGED
    ic1 = tout[0][changed].long()
    assert (band[ic1] != band[torch.from_numpy(ic0)[changed].long()]).all()
    # a mask that never changes walks exactly as no mask
    plain = locate.walk(tg, r0, r1, ic0, table=ttab)
    same = locate.walk(tg, r0, r1, ic0, i_icell_mask=0, table=ttab)
    for a, b in zip(plain, same):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cuda_walk_matches_plain(cuda, mesh):
    cell_type, gen = MESHES[mesh]
    pts, cells, nbrs = gen()
    g = tiu.build_grid(pts, cells, nbrs, cell_type, locate_mode="walk",
                       dtype=torch.float32, device=cuda)
    ic0, r0, r1 = _lanes(g.cell_points.cpu().numpy(), g.rmin.cpu().numpy(),
                         g.rmax.cpu().numpy(), cell_type, g.n_cells)
    args = locate._walk_args(g, torch.from_numpy(r0).to(cuda),
                             torch.from_numpy(r1).to(cuda),
                             torch.from_numpy(ic0).to(cuda))
    before = walk_kernel.launches
    kout = walk_kernel.walk_rows(*args)
    torch.cuda.synchronize()
    assert walk_kernel.launches == before + 1
    pout = walk_kernel.walk_plain(*args)
    for k, p in zip(kout, pout):
        assert torch.equal(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cuda_masked_walk_matches_plain(cuda, mesh):
    """B3 with a mask column against the masked plain version, bit for
    bit; a mask that never changes gives the unmasked kernel's walks."""
    cell_type, gen = MESHES[mesh]
    pts, cells, nbrs = gen()
    g = tiu.build_grid(pts, cells, nbrs, cell_type, locate_mode="walk",
                       dtype=torch.float32, device=cuda,
                       icell_data={"band": _bands(pts[cells])})
    ic0, r0, r1 = _lanes(g.cell_points.cpu().numpy(), g.rmin.cpu().numpy(),
                         g.rmax.cpu().numpy(), cell_type, g.n_cells)
    args = locate._walk_args(g, torch.from_numpy(r0).to(cuda),
                             torch.from_numpy(r1).to(cuda),
                             torch.from_numpy(ic0).to(cuda))
    mask = g.icell_data[:, 0].contiguous()
    kout = walk_kernel.walk_rows(*args, mask)
    pout = walk_kernel.walk_plain(*args, mask)
    for k, p in zip(kout, pout):
        assert torch.equal(k, p)
    assert (kout[3] == tiu.STATUS_MASK_CHANGED).any()
    flat = torch.zeros_like(mask)
    for k, p in zip(walk_kernel.walk_rows(*args, flat),
                    walk_kernel.walk_rows(*args)):
        assert torch.equal(k, p)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_walk_tolerances_match_jax(dtype):
    """(nudge, eps_arrive) are the JAX package's values bit for bit, from
    numpy arrays and from tensors alike."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from interpolate_unstructured_tpu.utils.config import (
        walk_tolerances as jax_walk_tolerances,
    )
    from interpolate_unstructured_tpu_torch.utils.config import (
        walk_tolerances,
    )

    for lo, hi in (([0, 0, 0], [1, 1, 1]), ([-0.3, 0.1, 0], [0.7, 2.3, 0.1]),
                   ([-12.7, 3, 1], [5, 1e3 / 7, 2])):
        rmin = np.asarray(lo, dtype)
        rmax = np.asarray(hi, dtype)
        want = [float(x) for x in jax_walk_tolerances(
            jnp.dtype(dtype), jnp.asarray(rmin), jnp.asarray(rmax))]
        assert list(walk_tolerances(np.dtype(dtype), rmin, rmax)) == want
        tdt = getattr(torch, dtype)
        assert list(walk_tolerances(tdt, torch.from_numpy(rmin),
                                    torch.from_numpy(rmax))) == want
