"""The port's cold interpolation path against the JAX package's.

Both packages build their grids natively from the same mesh
(``cand_build="host"``) and answer the same queries through
``interpolate_at`` / ``interpolate_scalar_at``: brute-force grids (B1)
and candidate-row grids (B2, including one whose overflow bins spill
into an extension table), points outside the mesh, scalar and array
fill values, and float64 on the CPU.

Tolerances: float32 found masks and cell ids identical, values within
2e-6 where found; float64 linear exactness 1e-14 on brute-force grids
(the repo's invariant) and agreement with the JAX package to 1e-13.
"""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.utils import meshgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = tiu.IUConfig(cand_build="host")
EXT = dataclasses.replace(
    HOST, cand_bins_per_cell=0.3, cand_ext_max_k=256, cand_cover_row_bytes=0
)
BRUTE = {
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(2, 2)),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(8, 8)),
    "tetra": ("tetra", lambda: meshgen.tet_box_mesh(5, 5, 5)),
}
WALK = {
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(24, 24), HOST),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(24, 24), HOST),
    "tetra": ("tetra", lambda: meshgen.tet_box_mesh(8, 8, 8), HOST),
    "tetra-extension": (
        "tetra", lambda: meshgen.tet_box_mesh(12, 12, 12), EXT,
    ),
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
    """The JAX package and jax.numpy (the reference side)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu

    return jnp, jiu


def _point_data(pts):
    return {"Polynomial": pts.sum(1) + 1.0, "XY": pts[:, 0] * pts[:, 1]}


def _queries(pts, n=4000, seed=3):
    """Uniform in the mesh's box grown by 10% on each side (2D meshes
    stay in their plane): a share of the queries lies outside."""
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(0), pts.max(0)
    span = hi - lo
    return lo - 0.1 * span + rng.random((n, 3)) * 1.2 * span


def _build_both(cell_type, mesh, dtype, cfg=HOST, locate_mode="auto",
                device="cpu"):
    jnp, jiu = _jax()
    pts, cells, nbrs = mesh()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jdt,
                        point_data=_point_data(pts), locate_mode=locate_mode,
                        config=jiu.IUConfig(**dataclasses.asdict(cfg)))
    tg = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=dtype,
                        point_data=_point_data(pts), locate_mode=locate_mode,
                        config=cfg, device=device)
    assert tg.locate_mode == ug.locate_mode
    return pts, ug, tg


@pytest.mark.parametrize("mesh", list(BRUTE))
def test_bruteforce_interpolate_at_matches_jax(mesh):
    jnp, jiu = _jax()
    cell_type, gen = BRUTE[mesh]
    pts, ug, tg = _build_both(cell_type, gen, torch.float32)
    assert tg.locate_mode == "bruteforce"
    r = _queries(pts).astype(np.float32)
    jv, jic, jf = jiu.interpolate_at(ug, jnp.asarray(r), [0, 1],
                                     fill_value=-3.0)
    tv, tic, tf = tiu.interpolate_at(tg, torch.from_numpy(r), [0, 1],
                                     fill_value=-3.0)
    jf = np.asarray(jf)
    assert 0 < jf.sum() < len(r)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tic.numpy(), np.asarray(jic))
    assert tv.shape == (len(r), 2) and tv.dtype == torch.float32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=2e-6)
    assert (tv.numpy()[~jf] == -3.0).all() and (tic.numpy()[~jf] == -1).all()


@pytest.mark.parametrize("mesh", list(WALK))
def test_candidate_interpolate_scalar_at_matches_jax(mesh):
    jnp, jiu = _jax()
    cell_type, gen, cfg = WALK[mesh]
    pts, ug, tg = _build_both(cell_type, gen, torch.float32, cfg, "walk")
    assert tg.cand_table is not None
    assert (tg.cand_ext_table is not None) == (mesh == "tetra-extension")
    r = _queries(pts).astype(np.float32)
    if cell_type != "tetra":
        r[:, 2] = 0.0
    jv, jic, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(r), 0)
    tv, tic, tf = tiu.interpolate_scalar_at(tg, torch.from_numpy(r), 0)
    jf = np.asarray(jf)
    assert 0 < jf.sum() < len(r)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tic.numpy(), np.asarray(jic))
    np.testing.assert_allclose(tv.numpy()[jf], np.asarray(jv)[jf], rtol=0,
                               atol=2e-6)
    assert np.isnan(tv.numpy()[~jf]).all()
    # linear exactness of the fused value planes / premultiplied data
    lin = np.abs(tv.numpy()[jf] - (r[jf].astype(np.float64).sum(1) + 1.0))
    assert lin.max() <= 2e-6


@pytest.mark.parametrize("grid_kind", ["bruteforce", "walk"])
def test_array_fill_value_matches_jax(grid_kind):
    jnp, jiu = _jax()
    if grid_kind == "bruteforce":
        pts, ug, tg = _build_both("tetra", BRUTE["tetra"][1], torch.float32)
    else:
        pts, ug, tg = _build_both("tetra", WALK["tetra"][1], torch.float32,
                                  HOST, "walk")
    r = _queries(pts, 2000).astype(np.float32)
    prev = np.random.default_rng(4).random(len(r)).astype(np.float32)
    jv, _, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(r), 0,
                                          fill_value=jnp.asarray(prev))
    tv, _, tf = tiu.interpolate_scalar_at(tg, torch.from_numpy(r), 0,
                                          fill_value=prev)
    jf = np.asarray(jf)
    assert (~jf).any()
    np.testing.assert_array_equal(tv.numpy()[~jf], prev[~jf])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=2e-6)
    # (B, V) array fill through interpolate_at
    prev2 = np.random.default_rng(5).random((len(r), 1)).astype(np.float32)
    tv2, _, _ = tiu.interpolate_at(tg, torch.from_numpy(r), [0],
                                   fill_value=prev2)
    np.testing.assert_array_equal(tv2.numpy()[~jf, 0], prev2[~jf, 0])


@pytest.mark.parametrize("mesh", list(BRUTE))
def test_float64_bruteforce_linear_exactness(mesh):
    jnp, jiu = _jax()
    cell_type, gen = BRUTE[mesh]
    pts, ug, tg = _build_both(cell_type, gen, torch.float64)
    r = _queries(pts)
    tv, tic, tf = tiu.interpolate_scalar_at(tg, torch.from_numpy(r), 0)
    jv, jic, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(r), 0)
    f = tf.numpy()
    assert f.any() and (f == np.asarray(jf)).all()
    np.testing.assert_array_equal(tic.numpy(), np.asarray(jic))
    assert np.abs(tv.numpy()[f] - (r[f].sum(1) + 1.0)).max() <= 1e-14
    np.testing.assert_allclose(tv.numpy()[f], np.asarray(jv)[f], rtol=0,
                               atol=1e-13)


def test_float64_candidate_rows_match_jax():
    jnp, jiu = _jax()
    pts, ug, tg = _build_both("triangle", WALK["triangle"][1],
                              torch.float64, HOST, "walk")
    assert tg.cand_table.dtype == torch.float64 and tg.cand_nv >= 1
    r = _queries(pts)
    r[:, 2] = 0.0
    tv, tic, tf = tiu.interpolate_scalar_at(tg, torch.from_numpy(r), 0)
    jv, jic, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(r), 0)
    f = tf.numpy()
    assert f.any() and (f == np.asarray(jf)).all()
    np.testing.assert_array_equal(tic.numpy(), np.asarray(jic))
    np.testing.assert_allclose(tv.numpy()[f], np.asarray(jv)[f], rtol=0,
                               atol=1e-13)
    assert np.abs(tv.numpy()[f] - (r[f].sum(1) + 1.0)).max() <= 1e-13


def test_later_slices_raise():
    """The three walk-grid calls that raised NotImplementedError until the
    warm-path slice — a warm guess, an unfused variable, and a grid whose
    extension rows do not cover every bin (the residual walk) — now
    answer as the JAX package does."""
    jnp, jiu = _jax()
    r = _queries(meshgen.tet_box_mesh(8, 8, 8)[0], 2000).astype(np.float32)
    pts, ug, tg = _build_both("tetra", WALK["tetra"][1], torch.float32,
                              HOST, "walk")
    guess = np.zeros(len(r), np.int32)
    jv, jic, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(r), 0,
                                            guess=jnp.asarray(guess))
    tv, tic, tf = tiu.interpolate_scalar_at(tg, r, 0,
                                            guess=torch.from_numpy(guess))
    outs = [(jv, jic, jf, tv, tic, tf, r)]

    qpts, ug, tg = _build_both("quad", WALK["quad"][1], torch.float32, HOST,
                               "walk")
    assert tg.cand_nv == 1 < tg.n_point_data  # the second variable is unfused
    rq = _queries(qpts, 2000).astype(np.float32)
    rq[:, 2] = 0.0
    jv, jic, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(rq), 1)
    outs.append((jv, jic, jf, *tiu.interpolate_scalar_at(tg, rq, 1), rq))

    partial = dataclasses.replace(HOST, cand_bins_per_cell=0.3,
                                  cand_ext_max_k=2, cand_cover_row_bytes=0)
    pts, ug, tg = _build_both("tetra", WALK["tetra"][1], torch.float32,
                              partial, "walk")
    assert not tg.cand_ext_covers
    jv, jic, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(r), 0)
    outs.append((jv, jic, jf, *tiu.interpolate_scalar_at(tg, r, 0), r))

    for jv, jic, jf, tv, tic, tf, rr in outs:
        jf = np.asarray(jf)
        assert 0 < jf.sum() < len(rr)
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_array_equal(tic.numpy(), np.asarray(jic))
        np.testing.assert_allclose(tv.numpy()[jf], np.asarray(jv)[jf],
                                   rtol=0, atol=2e-6)


def test_build_grid_defaults_to_cuda():
    """Without ``device=``, build_grid puts the grid on the card; a
    process without one gets an error, not a grid on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    pts, cells, nbrs = meshgen.tet_box_mesh(2, 2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiu.build_grid(pts, cells, nbrs, "tetra", dtype=torch.float32)


def test_port_imports_no_jax():
    code = (
        "import sys, interpolate_unstructured_tpu_torch as t; "
        "from interpolate_unstructured_tpu_torch.ops import "
        "cand_build, cand_build_kernel, cand_kernel, interp_kernel, kdtree, "
        "locate, walk_kernel, _kernels; "
        "from interpolate_unstructured_tpu_torch.io import binda, cgns, "
        "checkpoint, convert, exodus, fem, msh, simple_formats, vtk, "
        "vtk_legacy, vtu, xdmf; "
        "from interpolate_unstructured_tpu_torch.utils import validate; "
        "from interpolate_unstructured_tpu_torch import read_grid, write_vtk, "
        "save_grid, load_grid, write_trace_vtk, validate_grid; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert 'interpolate_unstructured_tpu' not in sys.modules"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["tetra", "quad"])
def test_cuda_slice_matches_cpu(cuda, mesh):
    for cell_type, gen, cfg, mode in (
        (*BRUTE[mesh], HOST, "auto"),
        (*WALK[mesh], "walk"),
    ):
        pts, cells, nbrs = gen()
        grids = [
            tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                           point_data=_point_data(pts), locate_mode=mode,
                           config=cfg, device=d)
            for d in ("cpu", cuda)
        ]
        r = _queries(pts, 20_000).astype(np.float32)
        if cell_type != "tetra":
            r[:, 2] = 0.0
        cv, cic, cf = tiu.interpolate_scalar_at(grids[0], r, 0, fill_value=0.0)
        gv, gic, gf = tiu.interpolate_scalar_at(grids[1], r, 0, fill_value=0.0)
        assert torch.equal(gf.cpu(), cf) and torch.equal(gic.cpu(), cic)
        assert (gv.cpu() - cv).abs().max().item() <= 2e-6
        assert not math.isnan(gv.sum().item())


@pytest.mark.cuda
def test_cuda_rejects_float64(cuda):
    """Float64 grids on the card (the name is from when the card refused
    them): the brute-force grid launches B1's double kernel, the
    candidate grid B2's, and both answer as the CPU does (ids and found
    identical, values within 1e-13)."""
    from interpolate_unstructured_tpu_torch.ops import (
        cand_kernel,
        interp_kernel,
    )

    for cell_type, gen, mode, counter in (
        ("tetra", BRUTE["tetra"][1], "auto", (interp_kernel, "launches")),
        ("triangle", WALK["triangle"][1], "walk",
         (cand_kernel, "binned_launches")),
    ):
        pts, cells, nbrs = gen()
        r = _queries(pts, 2000)
        if cell_type != "tetra":
            r[:, 2] = 0.0
        out = []
        for dev in ("cpu", cuda):
            g = tiu.build_grid(pts, cells, nbrs, cell_type,
                               dtype=torch.float64,
                               point_data=_point_data(pts), locate_mode=mode,
                               config=HOST, device=dev)
            before = getattr(*counter)
            out.append(tiu.interpolate_scalar_at(g, r, 0, fill_value=0.0))
            torch.cuda.synchronize()
            assert (getattr(*counter) > before) == (dev == cuda)
        (cv, cic, cf), (gv, gic, gf) = out
        assert gv.dtype == torch.float64 and cf.any() and not cf.all()
        assert torch.equal(gf.cpu(), cf) and torch.equal(gic.cpu(), cic)
        assert (gv.cpu() - cv).abs().max().item() <= 1e-13
