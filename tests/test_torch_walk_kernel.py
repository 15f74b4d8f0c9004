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


def _cuda_walk_setup(cuda, mesh, dtype, table, n):
    """(args of walk_rows on the card, mask column): ``n`` walks of the
    module's lanes (repeated to size) on a grid of ``dtype`` with a band
    mask, over the walk rows or the tracer's trace rows."""
    cell_type, gen = MESHES[mesh]
    pts, cells, nbrs = gen()
    g = tiu.build_grid(pts, cells, nbrs, cell_type, locate_mode="walk",
                       dtype=getattr(torch, dtype), device=cuda,
                       point_data={"vx": pts[:, 0], "vy": pts[:, 1]},
                       icell_data={"band": _bands(pts[cells])},
                       config=tiu.IUConfig(use_candidate_bins=False))
    ic0, r0, r1 = _lanes(g.cell_points.cpu().numpy(), g.rmin.cpu().numpy(),
                         g.rmax.cpu().numpy(), cell_type, g.n_cells)
    reps = -(-n // N_LANES)
    ic0, r0, r1 = (np.concatenate([x] * reps)[:n] for x in (ic0, r0, r1))
    tab = None if table == "walk" else tiu.build_trace_table(g, [0, 1])
    args = locate._walk_args(g, torch.from_numpy(r0).to(cuda),
                             torch.from_numpy(r1).to(cuda),
                             torch.from_numpy(ic0).to(cuda), table=tab)
    return args, g.icell_data[:, 0].to(torch.int32).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 100_000])
@pytest.mark.parametrize("table", ["walk", "trace"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cuda_walk_matches_plain(cuda, mesh, dtype, table, n):
    """B3's explicit walk (the direction computed in the kernel) against
    walk_direction + walk_plain, bit for bit, at the block size walk_rows
    picks and at others; one launch."""
    args, _ = _cuda_walk_setup(cuda, mesh, dtype, table, n)
    u, total, active = walk_kernel.walk_direction(args[1], args[2], args[7])
    pout = walk_kernel.walk_plain(args[0], args[1], u, total, active,
                                  *args[3:7], *args[8:])
    before = walk_kernel.launches
    kout = walk_kernel.walk_rows(*args)
    torch.cuda.synchronize()
    assert walk_kernel.launches == before + 1
    for k, p in zip(kout, pout):
        assert torch.equal(k, p)
    for threads in (32, 128, 256):
        for k, p in zip(walk_kernel.walk_cuda(*args, threads=threads), pout):
            assert torch.equal(k, p), threads
    assert (pout[2] > 1).any() and (pout[3] == tiu.STATUS_BOUNDARY).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cuda_masked_walk_matches_plain(cuda, mesh, dtype):
    """B3 with a mask column against the masked plain version, bit for
    bit, at two block sizes, on the walk rows and the trace rows; a mask
    that never changes gives the unmasked kernel's walks."""
    for table in ("walk", "trace"):
        args, mask = _cuda_walk_setup(cuda, mesh, dtype, table, 20_000)
        pout = walk_kernel.walk_rows_plain(*args, mask)
        for threads in (32, 128):
            kout = walk_kernel.walk_cuda(*args, mask, threads=threads)
            for k, p in zip(kout, pout):
                assert torch.equal(k, p), (table, threads)
        assert (pout[3] == tiu.STATUS_MASK_CHANGED).any()
        flat = torch.zeros_like(mask)
        for k, p in zip(walk_kernel.walk_rows(*args, flat),
                        walk_kernel.walk_rows(*args)):
            assert torch.equal(k, p)


def _profiled_walk(cuda):
    """The torch ops and the device kernels that the profiler records for
    one ``locate.walk`` on the card (after a warm-up call)."""
    from torch.autograd import DeviceType

    args, _ = _cuda_walk_setup(cuda, "tetra", "float32", "walk", 1024)
    g_r0, g_r1, g_ic = args[1], args[2], args[3]
    pts, cells, nbrs = MESHES["tetra"][1]()
    g = tiu.build_grid(pts, cells, nbrs, "tetra", locate_mode="walk",
                       dtype=torch.float32, device=cuda,
                       config=tiu.IUConfig(use_candidate_bins=False))
    locate.walk(g, g_r0, g_r1, g_ic)
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        locate.walk(g, g_r0, g_r1, g_ic)
        torch.cuda.synchronize()
    # the port's own spans (iu.*) are profiler ranges, which the profiler
    # also lays on the device's timeline
    kernels = {e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", "iu."))}
    return {"ops": sorted({e.key for e in prof.key_averages()}),
            "kernels": sorted(kernels)}


_PROFILED_WALK = """
import json, sys
import torch
sys.path[:0] = sys.argv[1:]
import test_torch_walk_kernel as t
print(json.dumps(t._profiled_walk(torch.device("cuda"))))
"""


@pytest.mark.cuda
def test_cuda_walk_builds_no_direction(cuda):
    """locate.walk on the card launches B3 and no torch op to build the
    direction: the kernel computes it itself (the walk tolerances still
    read the grid's extent back, as get_cell's do).

    The profiled call runs in a process of its own: on an H100 with
    PyTorch 2.11, after a full run of the card's tests in one process,
    most profiler sessions there keep their runtime records
    (``cudaLaunchKernel``) but lose every device record, kernels and
    copies alike, while a fresh process keeps them all."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    res = subprocess.run(
        [sys.executable, "-c", _PROFILED_WALK, str(here.parent), str(here)],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    math = {"aten::sub", "aten::mul", "aten::add", "aten::div",
            "aten::sqrt", "aten::where", "aten::lt", "aten::bitwise_not"}
    keys = set(out["ops"])
    assert not keys & math, keys & math
    kernels = set(out["kernels"])
    assert kernels and all("walk" in k for k in kernels), kernels


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


# get_cell's walk stage (walk_kernel.get_cell_walk): the plain version
# against the JAX package's get_cell on walk grids without candidate
# tables, carried into the port bit for bit (refined seed tables
# included); the CUDA kernel against the plain version, bit for bit.
GC_MESHES = {
    "tetra": ("tetra", lambda: meshgen.tet_box_mesh(6, 6, 6)),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(16, 14)),
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(16, 14)),
}
GC_N = 3000


def _gc_config(seeds, phases):
    """Walk-grid config: bin or kd-tree seeds; "two" phases lowers
    walk_compact_min_batch below the batch so that get_cell splits."""
    return tiu.IUConfig(
        cand_build="host", use_candidate_bins=False, seed_mode=seeds,
        walk_compact_min_batch=64 if phases == "two" else 1 << 16,
    )


def _gc_queries(pts, cell_type, n=GC_N, seed=21, grow=0.1):
    """Uniform in the mesh's box grown by ``grow`` a side (off-domain
    queries included); 2D meshes stay in their plane."""
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(0), pts.max(0)
    r = lo - grow * (hi - lo) + rng.random((n, 3)) * (1 + 2 * grow) * (hi - lo)
    if cell_type != "tetra":
        r[:, 2] = 0.0
    return r.astype(np.float32)


def _gc_guesses(ic, n_cells, seed=22):
    """Cells as guesses, some negative and some past the last cell."""
    g = torch.as_tensor(ic).cpu().numpy().astype(np.int32)
    rng = np.random.default_rng(seed)
    g[rng.random(len(g)) < 0.1] = -1
    g[rng.random(len(g)) < 0.05] = n_cells + 7
    return g


def _gc_start(tg, r, guess, seeds):
    """The start cells get_cell hands the walk stage: None (bin_pack
    seeds), the guesses (the stage reseeds out-of-range ones from the
    bin table), or kd-tree seeds where no guess is in range."""
    if seeds == "bins":
        return None if guess is None else guess
    kd = locate.kd_seed(tg, r)
    if guess is None:
        return kd
    return torch.where((guess >= 0) & (guess < tg.n_cells), guess, kd)


def _check_located(tg, r, jic, jf, tic, tf):
    """Found masks identical; not-found codes identical; cell ids
    identical except near-ties, where both cells contain the point
    (XLA contracts the JAX side's float32 arithmetic into FMAs)."""
    jic = torch.from_numpy(np.array(jic))
    jf = torch.from_numpy(np.array(jf))
    assert torch.equal(tf, jf)
    differ = torch.nonzero(jic != tic).squeeze(1)
    assert differ.numel() <= 0.01 * len(tic)
    if differ.numel():
        rr = torch.as_tensor(r)[differ]
        assert bool(tf[differ].all())
        assert bool(tiu.point_is_inside_cell(tg, rr, jic[differ]).all())
        assert bool(tiu.point_is_inside_cell(tg, rr, tic[differ]).all())


@pytest.mark.parametrize("phases", ["one", "two"])
@pytest.mark.parametrize("seeds", ["bins", "kdtree"])
@pytest.mark.parametrize("mesh", list(GC_MESHES))
def test_get_cell_walk_plain_matches_jax(monkeypatch, mesh, seeds, phases):
    """Cold (bin-seeded from bin_pack, or kd-seeded) and warm (guesses
    with some -1 and some >= n_cells) queries, inside and off the
    domain, in one phase or split in two."""
    pytest.importorskip("jax")
    import dataclasses

    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu

    cell_type, gen = GC_MESHES[mesh]
    pts, cells, nbrs = gen()
    cfg = _gc_config(seeds, phases)
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, locate_mode="walk",
                        dtype=jnp.float32,
                        config=jiu.IUConfig(**dataclasses.asdict(cfg)))
    tg = tiu.grid_from_numpy(
        {f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
         for f in DATA_FIELDS},
        {f: getattr(ug, f) for f in META_FIELDS}, "cpu",
    )
    assert (tg.kd_node_points is not None) == (seeds == "kdtree")
    resumes = []
    real = walk_kernel._resume_plain

    def spy(grid, r_p, r1, ic, max_steps):
        resumes.append(r_p.shape[0])
        return real(grid, r_p, r1, ic, max_steps)

    monkeypatch.setattr(walk_kernel, "_resume_plain", spy)
    max_steps = tg.config.max_walk_steps
    p1 = tg.config.walk_phase1_steps if phases == "two" else 0

    r = _gc_queries(pts, cell_type)
    jic, jf = jiu.get_cell(ug, jnp.asarray(r))
    rt = torch.from_numpy(r)
    tic, tf = walk_kernel.get_cell_walk_plain(
        tg, rt, _gc_start(tg, rt, None, seeds), max_steps, p1)
    _check_located(tg, r, jic, jf, tic, tf)
    assert 0 < int(tf.sum()) < GC_N
    assert (tic[~tf] < 0).all()

    rw = r + (0.03 * np.random.default_rng(23).random(r.shape)).astype(
        np.float32)
    if cell_type != "tetra":
        rw[:, 2] = 0.0
    g = _gc_guesses(tic, tg.n_cells)
    jic2, jf2 = jiu.get_cell(ug, jnp.asarray(rw), jnp.asarray(g))
    rwt, gt = torch.from_numpy(rw), torch.from_numpy(g)
    tic2, tf2 = walk_kernel.get_cell_walk_plain(
        tg, rwt, _gc_start(tg, rwt, gt, seeds), max_steps, p1)
    _check_located(tg, rw, jic2, jf2, tic2, tf2)
    assert (tic2[~tf2] < 0).all() and not bool(tf2.all())
    # the public entry takes the same stage
    assert all(torch.equal(a, b) for a, b in zip(
        tiu.get_cell(tg, rwt, gt), (tic2, tf2)))
    assert bool(resumes) == (phases == "two")


@pytest.mark.parametrize("mesh", list(GC_MESHES))
def test_walk_origin_unchanged_and_matches_jax(mesh):
    """The walk origin divides by a tensor: on the CPU it equals the
    division by the Python int it replaced, bit for bit.  Against the
    JAX package's _walk_origin it is exact on tets and quads (npc = 4)
    and within one ulp on triangles, where XLA multiplies the vertex
    sum by the rounded 1/3 and the port divides by 3."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu
    from interpolate_unstructured_tpu.ops import locate as jlocate

    cell_type, gen = GC_MESHES[mesh]
    pts, cells, nbrs = gen()
    ug = jiu.build_grid(pts * np.pi, cells, nbrs, cell_type,
                        locate_mode="walk", dtype=jnp.float32)
    tg = tiu.grid_from_numpy(
        {f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
         for f in DATA_FIELDS},
        {f: getattr(ug, f) for f in META_FIELDS}, "cpu",
    )
    starts = torch.arange(tg.n_cells, dtype=torch.int32)
    nf, npc = tg.n_faces_per_cell, tg.n_points_per_cell
    got = walk_kernel.walk_origin(tg.walk_table, starts, nf, npc)
    cp = tg.walk_table[:, nf * 5: nf * 5 + npc * 3].reshape(-1, npc, 3)
    acc = cp[:, 0]
    for k in range(1, npc):
        acc = acc + cp[:, k]
    assert torch.equal(got, acc / npc)
    want = np.asarray(jlocate._walk_origin(ug, jnp.asarray(starts.numpy())))
    if npc == 4:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        ulps = np.abs(got.numpy() - want) / np.spacing(np.abs(want))
        assert ulps.max() <= 1.0


def test_get_cell_walk_wrapper_checks():
    """The CUDA wrapper refuses a wrong dtype, device or row stride before
    it reaches the kernel."""
    pts, cells, nbrs = meshgen.tet_box_mesh(3, 3, 3)
    g = tiu.build_grid(pts, cells, nbrs, "tetra", locate_mode="walk",
                       dtype=torch.float32, device="cpu",
                       config=tiu.IUConfig(use_candidate_bins=False))
    r = torch.full((5, 3), 0.5)
    with pytest.raises(TypeError):
        walk_kernel.get_cell_walk_cuda(g, r.double(), None, 10, 0)
    with pytest.raises(ValueError):
        walk_kernel.get_cell_walk_cuda(g, torch.empty((5, 3), device="meta"),
                                       None, 10, 0)
    with pytest.raises(ValueError):
        walk_kernel.get_cell_walk_cuda(g, r, torch.zeros(5, dtype=torch.int64),
                                       10, 0)
    import dataclasses

    narrow = dataclasses.replace(g, walk_table=g.walk_table[:, :126])
    with pytest.raises(ValueError):
        walk_kernel.get_cell_walk_cuda(narrow, r, None, 10, 0)


def test_walk_wrapper_checks():
    """The explicit walk's CUDA wrapper refuses a wrong dtype, device, row
    stride or block size before it reaches the kernel."""
    pts, cells, nbrs = meshgen.tet_box_mesh(3, 3, 3)
    g = tiu.build_grid(pts, cells, nbrs, "tetra", locate_mode="walk",
                       dtype=torch.float32, device="cpu",
                       config=tiu.IUConfig(use_candidate_bins=False))
    r = torch.full((5, 3), 0.5)
    ic0 = torch.zeros(5, dtype=torch.int32)
    args = list(locate._walk_args(g, r, r + 0.1, ic0))
    with pytest.raises(TypeError):  # a float64 target beside float32 rows
        walk_kernel.walk_cuda(*args[:2], args[2].double(), *args[3:])
    with pytest.raises(TypeError):
        walk_kernel.walk_cuda(*args[:3], args[3].long(), *args[4:])
    with pytest.raises(ValueError):
        walk_kernel.walk_cuda(*args[:2], args[2][:4], *args[3:])
    with pytest.raises(ValueError):  # rows that are not 16-byte words
        walk_kernel.walk_cuda(g.walk_table[:, :126].contiguous(), *args[1:])
    with pytest.raises(ValueError):
        walk_kernel.walk_cuda(*args, threads=48)
    with pytest.raises(ValueError):
        walk_kernel.walk_cuda(*args, threads=512)


def _gc_batches(g, cell_type):
    """Skewed CUDA batches of the walk stage: uniform with off-domain
    queries, every query in one seed bin, one query per seed bin (the bin
    centers), a batch that is not a multiple of the block, and the empty
    batch."""
    pts = g.points.cpu().numpy()
    uniform = _gc_queries(pts, cell_type, n=20_000, seed=24, grow=0.2)
    lo, hi = pts.min(0), pts.max(0)
    one = np.repeat(lo + 0.37 * (hi - lo), 5000, axis=0).reshape(-1, 3)
    one = one + 1e-5 * np.random.default_rng(25).random(one.shape)
    nb = g.bin_shape
    inv_h = g.bin_inv_h.cpu().numpy()
    h = np.divide(1.0, inv_h, out=np.zeros(3), where=inv_h > 0)
    axes = [g.bin_rmin.cpu().numpy()[d] + (np.arange(nb[d]) + 0.5) * h[d]
            for d in range(3)]
    per_bin = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    ragged = uniform[:1037]
    out = {"uniform": uniform, "one_bin": one, "one_per_bin": per_bin,
           "ragged": ragged, "empty": uniform[:0]}
    for k, v in out.items():
        v = v.astype(np.float32)
        if cell_type != "tetra":
            v[:, 2] = pts[0, 2]
        out[k] = torch.from_numpy(v).to(g.walk_table.device)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("seeds", ["bins", "kdtree"])
@pytest.mark.parametrize("mesh", list(GC_MESHES))
def test_cuda_get_cell_walk_matches_plain(cuda, mesh, seeds):
    """The kernel's (ic, found) are torch.equal to the plain version's on
    every batch, cold and warm (mixed guesses), in one phase and in two
    (also with a step cap that leaves walks unfinished)."""
    cell_type, gen = GC_MESHES[mesh]
    pts, cells, nbrs = gen()
    g = tiu.build_grid(pts, cells, nbrs, cell_type, locate_mode="walk",
                       dtype=torch.float32, device=cuda,
                       config=_gc_config(seeds, "two"))
    for name, r in _gc_batches(g, cell_type).items():
        ic_p, _ = walk_kernel.get_cell_walk_plain(
            g, r, _gc_start(g, r, None, seeds), 1024, 0)
        guess = torch.from_numpy(_gc_guesses(ic_p, g.n_cells)).to(cuda)
        for gs in (None, guess):
            start = _gc_start(g, r, gs, seeds)
            for max_steps, p1 in ((1024, 0), (1024, 2), (5, 2), (3, 0)):
                before = walk_kernel.get_cell_launches
                k = walk_kernel.get_cell_walk(g, r, start, max_steps, p1)
                torch.cuda.synchronize()
                assert walk_kernel.get_cell_launches == before + (
                    1 if len(r) else 0)
                p = walk_kernel.get_cell_walk_plain(g, r, start, max_steps, p1)
                assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]), (
                    name, gs is None, max_steps, p1)
        if name == "uniform":
            assert not bool(k[1].all()) and (k[0] < 0).any()


@pytest.mark.cuda
def test_cuda_get_cell_walk_on_the_main_path(cuda):
    """get_cell on a walk grid, cold and warm, launches the walk stage
    and not the explicit walk; on a candidate grid whose rows do not
    cover every bin (the 10,368-tet box), the residual walks do too, and
    the answers equal the CPU's."""
    pts, cells, nbrs = meshgen.tet_box_mesh(8, 8, 8)
    g = tiu.build_grid(pts, cells, nbrs, "tetra", locate_mode="walk",
                       dtype=torch.float32, device=cuda,
                       config=tiu.IUConfig(use_candidate_bins=False))
    r = torch.from_numpy(_gc_queries(pts, "tetra", n=100_000)).to(cuda)
    for guess in (None, torch.zeros(len(r), dtype=torch.int32, device=cuda)):
        b0, w0 = walk_kernel.get_cell_launches, walk_kernel.launches
        tiu.get_cell(g, r, guess)
        assert walk_kernel.get_cell_launches == b0 + 1
        assert walk_kernel.launches == w0
    pts, cells, nbrs = meshgen.tet_box_mesh(12, 12, 12)
    cfg = tiu.IUConfig(cand_build="host", cand_bins_per_cell=0.3,
                       cand_ext_max_k=2, cand_cover_row_bytes=0)
    grids = [tiu.build_grid(pts, cells, nbrs, "tetra", dtype=torch.float32,
                            point_data={"P": pts.sum(1)}, config=cfg,
                            device=d) for d in ("cpu", cuda)]
    assert not grids[1].cand_ext_covers
    r = torch.from_numpy(_gc_queries(pts, "tetra", n=50_000))
    b0 = walk_kernel.get_cell_launches
    _, gic, gf = tiu.interpolate_scalar_at(grids[1], r.to(cuda), 0)
    assert walk_kernel.get_cell_launches > b0
    _, cic, cf = tiu.interpolate_scalar_at(grids[0], r, 0)
    assert torch.equal(gic.cpu(), cic) and torch.equal(gf.cpu(), cf)


def test_edge_walk_plain_matches_jax():
    """Walks from cell centers of the 7x7x7 box out through the midpoint
    of one of the cell's edges, where the two faces that meet there tie:
    the plain walk against the JAX package's.  Final cells and statuses
    identical on every walk; where the edge lies on the boundary, one
    side may leave the domain by one face and the other hop once more
    into the other face's cell first (XLA's FMA-contracted distances
    break the tie the other way), so the step counts may differ there,
    by one, or by two at a corner of the box, on walks that left the
    domain; final positions within 4e-6.
    Some first rounds tie exactly."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu
    from interpolate_unstructured_tpu.ops import locate as jlocate

    pts, cells, nbrs = meshgen.tet_box_mesh(7, 7, 7)
    ug = jiu.build_grid(pts, cells, nbrs, "tetra", locate_mode="walk",
                        dtype=jnp.float32)
    tg = tiu.grid_from_numpy(
        {f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
         for f in DATA_FIELDS},
        {f: getattr(ug, f) for f in META_FIELDS}, "cpu",
    )
    cp = np.asarray(ug.cell_points, np.float64)
    rng = np.random.default_rng(43)
    ic0 = rng.integers(0, ug.n_cells, N_LANES).astype(np.int32)
    edges = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)])
    e = edges[rng.integers(0, 6, N_LANES)]
    c = cp[ic0].mean(axis=1)
    mid = 0.5 * (cp[ic0, e[:, 0]] + cp[ic0, e[:, 1]])
    r0 = c.astype(np.float32)
    r1 = (c + 1.5 * (mid - c)).astype(np.float32)
    jout = jlocate.walk(ug, jnp.asarray(r0), jnp.asarray(r1),
                        jnp.asarray(ic0))
    tout = locate.walk(tg, r0, r1, ic0)
    jic, jrp, jsteps, jst = (torch.from_numpy(np.array(x)) for x in jout)
    assert torch.equal(tout[0], jic) and torch.equal(tout[3], jst)
    hop = tout[2] != jsteps
    assert bool((jst[hop] == tiu.STATUS_BOUNDARY).all())
    assert bool(((tout[2] - jsteps)[hop].abs() <= 2).all())
    assert int(hop.sum()) <= 0.02 * N_LANES
    np.testing.assert_allclose(tout[1].numpy(), jrp.numpy(), rtol=0,
                               atol=4e-6)
    assert (jst == tiu.STATUS_ARRIVED).any()
    # the first round's two best faces tie exactly on some walks
    args = locate._walk_args(tg, r0, r1, ic0)
    u, _, _ = walk_kernel.walk_direction(args[1], args[2], args[7])
    g = tg.walk_table[torch.from_numpy(ic0).long(), :20]
    pdn = torch.stack([(g[:, 3 * f] * u[:, 0] + g[:, 3 * f + 1] * u[:, 1])
                       + g[:, 3 * f + 2] * u[:, 2] for f in range(4)], 1)
    rpn = torch.stack([(g[:, 3 * f] * args[1][:, 0]
                        + g[:, 3 * f + 1] * args[1][:, 1])
                       + g[:, 3 * f + 2] * args[1][:, 2] for f in range(4)],
                      1)
    dist = torch.where(pdn > 0, (g[:, 12:16] - rpn) / pdn, args[6])
    best = torch.sort(dist, dim=1).values
    assert bool((best[:, 0] == best[:, 1]).any())
