"""The port against the independent serial C++ oracle.

``native/serial_oracle.cc`` reimplements the reference algorithm
(nearest-point seed, neighbor walk, simplex and quad weights, the RK23
tracer) with no code shared with either package.  The port builds it
through its own binding, ``utils/serial_oracle.py``:

* the port's binding and the JAX package's give the same outputs bit
  for bit on the same inputs (cold, warm with guesses, traces with
  extra variables, an icell mask, reverse and axisymmetric), and the
  port's binding takes torch tensors as it takes numpy arrays;
* the port's walk, brute-force and candidate paths in float64 agree
  with it as ``tests/test_serial_oracle.py`` holds the JAX package:
  identical found masks on mixed inside/outside batches, values at
  1e-12 on smooth nonlinear data (the jittered quads too, where that
  file allows the JAX package 1e-11), cell ids equal up to shared-face
  ties;
* the port's ``integrate_along_field`` in float64 follows its traces
  at 1e-9 by that file's rules for the end of a trace
  (``tests/test_torch_trace.py``'s ``_compare_traces``).

Only the binding parity needs jax; every other test runs on the port
alone and skips only where ``g++`` is missing.
"""

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.trace import BM_NOT_REACHED
from interpolate_unstructured_tpu_torch.utils import meshgen, serial_oracle
from test_torch_trace import _compare_traces

@pytest.fixture(autouse=True, scope="module")
def _oracle_built():
    """Build the oracle (once a process) when the first test runs, not
    when the module is imported; skip without a C++ toolchain."""
    if not serial_oracle.available():
        pytest.skip("no C++ toolchain for the serial oracle")


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests:
    on some virtualized hosts a worker thread's first float32
    torch.sqrt in a process is off by ~1e-4 relative."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


def _nonlinear(pts):
    pts = np.asarray(pts, np.float64)
    return np.sin(3.0 * pts[:, 0]) * pts[:, 1] + np.cos(2.0 * pts[:, 2])


def _mixed_queries(rng, n, lo, hi):
    """~80% interior, ~20% outside the domain box."""
    span = hi - lo
    q = lo - 0.25 * span + rng.random((n, 3)) * 1.5 * span
    q[: int(0.8 * n)] = lo + 0.05 * span + rng.random(
        (int(0.8 * n), 3)) * 0.9 * span
    return q


def _jittered(mesh, seed, amount):
    """A quad mesh with its interior vertices moved in the plane, so the
    quads are not parallelograms (the boundary stays rectangular)."""
    pts, cells, nbrs = mesh
    pts = np.asarray(pts, np.float64).copy()
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    inner = ((pts[:, 0] > lo[0] + 1e-9) & (pts[:, 0] < hi[0] - 1e-9)
             & (pts[:, 1] > lo[1] + 1e-9) & (pts[:, 1] < hi[1] - 1e-9))
    pts[inner, :2] += (rng.random((inner.sum(), 2)) - 0.5) * amount
    return pts, cells, nbrs, rng


# ---------------------------------------------------------------------
# The two bindings


def _jax_oracle():
    pytest.importorskip("jax")
    from interpolate_unstructured_tpu.utils import serial_oracle as jso

    if not jso.available():
        pytest.skip("the JAX package's oracle did not build")
    return jso


def _query_case(name):
    """(points, cells, neighbors, data, queries, kwargs) of a query case."""
    rng = np.random.default_rng(5)
    if name == "quad":
        pts, cells, nbrs, rng = _jittered(meshgen.quad_rect_mesh(6, 5), 8,
                                          0.08)
    elif name == "triangle":
        pts, cells, nbrs = meshgen.triangle_rect_mesh(6, 5)
    else:
        pts, cells, nbrs = meshgen.tet_box_mesh(5, 5, 5)
    q = _mixed_queries(rng, 1500, pts.min(axis=0), pts.max(axis=0))
    kw = {}
    if name in ("quad", "triangle"):
        q[:, 2] = 0.0
    if name == "quad":
        kw["cell_type"] = "quad"
    if name == "tet_warm":
        kw["guesses"] = rng.integers(-1, len(cells), len(q)).astype(np.int32)
    return pts, cells, nbrs, _nonlinear(pts), q, kw


@pytest.mark.parametrize("name", ["tet_cold", "tet_warm", "triangle", "quad"])
def test_query_matches_jax_binding(name):
    """serial_query: the port's binding (torch tensors in) and the JAX
    package's (numpy in) give the same values, cells and found masks bit
    for bit."""
    jso = _jax_oracle()
    pts, cells, nbrs, data, q, kw = _query_case(name)
    want = jso.serial_query(pts, cells, nbrs, data, q, **kw)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = serial_oracle.serial_query(
        torch.from_numpy(pts), torch.from_numpy(cells), torch.from_numpy(nbrs),
        torch.from_numpy(data), torch.from_numpy(q), **tkw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert 0.5 < want[2].mean() < 0.95


def _trace_case(name):
    """(points, cells, neighbors, field, y0, kwargs) of a trace case."""
    kw = dict(min_dx=1e-6, max_dx=0.05, max_steps=120, rtol=1e-8, atol=1e-8)
    if name == "tet":
        pts, cells, nbrs = meshgen.tet_box_mesh(5, 5, 5)
        fld = np.stack([-(pts[:, 1] - 0.5), pts[:, 0] - 0.5,
                        np.full(len(pts), 0.25)], axis=1)
        return pts, cells, nbrs, fld, np.array([[0.8, 0.5, 0.1],
                                                [0.5, 0.3, 0.5]]), kw
    pts, cells, nbrs = meshgen.triangle_rect_mesh(8, 7)
    fld = np.stack([-pts[:, 1], pts[:, 0]], axis=1)
    y0 = np.array([[1.5, 0.0], [0.5, 0.5], [1.0, 0.25]])
    if name == "nvar_reverse":
        y0 = np.concatenate([y0, np.zeros((3, 1))], axis=1)
        kw.update(nvar=1, reverse=True)
    elif name == "icell_mask":
        centers = pts[cells].mean(axis=1)
        fld = np.stack([np.ones(len(pts)), np.zeros(len(pts))], axis=1)
        kw.update(icell_mask=np.where(centers[:, 0] < 1.0, 0, 7), mask_value=0)
    elif name == "axisymmetric":
        fld = np.stack([np.full(len(pts), -0.05), np.ones(len(pts))], axis=1)
        y0 = np.array([[0.05, 0.1], [0.8, 0.2]])
        kw.update(axisymmetric=True)
    return pts, cells, nbrs, fld, y0, kw


@pytest.mark.parametrize("name", ["tet", "nvar_reverse", "icell_mask",
                                  "axisymmetric"])
def test_trace_matches_jax_binding(name):
    """serial_trace: both bindings give the same curves, field samples,
    step counts and boundary codes bit for bit."""
    jso = _jax_oracle()
    pts, cells, nbrs, fld, y0, kw = _trace_case(name)
    want = jso.serial_trace(pts, cells, nbrs, fld, y0, **kw)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = serial_oracle.serial_trace(
        torch.from_numpy(pts), torch.from_numpy(cells), torch.from_numpy(nbrs),
        torch.from_numpy(fld), torch.from_numpy(y0), **tkw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_binding_takes_tensors_of_any_dtype_and_layout():
    """Tensors (float32 points, int64 connectivity, a non-contiguous
    query view) are copied to the host as float64 and int32: the same
    outputs as the numpy arrays they hold."""
    pts, cells, nbrs, data, q, _ = _query_case("tet_cold")
    pts32 = pts.astype(np.float32)
    want = serial_oracle.serial_query(pts32.astype(np.float64), cells, nbrs,
                                      data, q)
    qt = torch.from_numpy(np.asfortranarray(q))
    assert not qt.is_contiguous()
    got = serial_oracle.serial_query(
        torch.from_numpy(pts32), torch.from_numpy(cells.astype(np.int64)),
        torch.from_numpy(nbrs.astype(np.int64)),
        torch.from_numpy(data.astype(np.float32)), qt)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    assert isinstance(got[0], np.ndarray)


@pytest.mark.cuda
def test_cuda_tensors_are_copied_to_the_host():
    """CUDA tensors go through the host copy, never to ctypes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pts, cells, nbrs, data, q, kw = _query_case("tet_warm")
    want = serial_oracle.serial_query(pts, cells, nbrs, data, q, **kw)
    dev = torch.device("cuda")
    got = serial_oracle.serial_query(
        *(torch.from_numpy(a).to(dev) for a in (pts, cells, nbrs, data, q)),
        guesses=torch.from_numpy(kw["guesses"]).to(dev))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------
# The port's query paths in float64


def _port_vs_oracle(pts, cells, nbrs, cell_type, q, mode, guess=None):
    """The port's float64 interpolate_scalar_at against serial_query on
    the same mesh, nonlinear data and queries: identical found masks,
    values within 1e-12; returns (port found, port cells, oracle
    cells)."""
    data = _nonlinear(pts)
    kw = {} if mode is None else {"locate_mode": mode}
    grid = tiu.build_grid(pts, cells, nbrs, cell_type, point_data={"D": data},
                          dtype=torch.float64, device="cpu", **kw)
    want_mode = {"walk": "walk", "bruteforce": "bruteforce"}.get(mode)
    if want_mode:
        assert grid.locate_mode == want_mode
    else:
        assert grid.cand_table is not None
    g = None if guess is None else torch.from_numpy(guess)
    v, ic, f = tiu.interpolate_scalar_at(grid, torch.from_numpy(q), 0,
                                         guess=g, fill_value=0.0)
    v_o, ic_o, f_o = serial_oracle.serial_query(
        pts, cells, nbrs, data, q, guesses=guess,
        cell_type="quad" if cell_type == "quad" else None)
    f = f.numpy()
    np.testing.assert_array_equal(f, f_o)
    np.testing.assert_allclose(v.numpy()[f], v_o[f], rtol=0, atol=1e-12)
    return f, ic.numpy(), ic_o


@pytest.mark.parametrize("mode", ["walk", "bruteforce"])
@pytest.mark.parametrize("cell_type", ["triangle", "tetra"])
def test_paths_match_oracle(cell_type, mode):
    """Walk and brute-force grids of triangles and tets, mixed inside
    and outside queries; cell ids agree but for shared-face ties."""
    if cell_type == "triangle":
        pts, cells, nbrs = meshgen.triangle_rect_mesh(6, 5)
    else:
        pts, cells, nbrs = meshgen.tet_box_mesh(5, 5, 5)
    rng = np.random.default_rng(42)
    q = _mixed_queries(rng, 3000, pts.min(axis=0), pts.max(axis=0))
    if cell_type == "triangle":
        q[:, 2] = 0.0
    f, ic, ic_o = _port_vs_oracle(pts, cells, nbrs, cell_type, q, mode)
    assert 0.5 < f.mean() < 0.95
    assert (f & (ic != ic_o)).mean() < 0.02


def test_candidate_path_matches_oracle():
    """The candidate-row path (a 7x7x7 tet box of 2,058 cells: "auto"
    builds candidate tables) and the serial walk share no code."""
    pts, cells, nbrs = meshgen.tet_box_mesh(7, 7, 7)
    rng = np.random.default_rng(3)
    q = _mixed_queries(rng, 3000, pts.min(axis=0), pts.max(axis=0))
    f, ic, ic_o = _port_vs_oracle(pts, cells, nbrs, "tetra", q, None)
    assert (f & (ic != ic_o)).mean() < 0.02


def test_warm_matches_oracle():
    """Guess-seeded walks (the reference warm protocol): the port's
    cold cells as both sides' guesses for moved points."""
    pts, cells, nbrs = meshgen.tet_box_mesh(5, 5, 5)
    grid = tiu.build_grid(pts, cells, nbrs, "tetra",
                          point_data={"D": _nonlinear(pts)},
                          dtype=torch.float64, locate_mode="walk",
                          device="cpu")
    rng = np.random.default_rng(7)
    q0 = 0.05 + rng.random((2000, 3)) * 0.9
    _, ic, f = tiu.interpolate_scalar_at(grid, torch.from_numpy(q0), 0)
    assert bool(f.all())
    q1 = np.clip(q0 + 0.02 * (rng.random((2000, 3)) - 0.5), 0.02, 0.98)
    f, _, _ = _port_vs_oracle(pts, cells, nbrs, "tetra", q1, "walk",
                              guess=ic.numpy())
    assert f.all()


def test_quads_match_oracle():
    """The inverse-bilinear quad weights on a jittered quad mesh, so the
    quadratic's root choice and the maxloc branch both matter (the
    port's quad values agree to ~5e-15 here)."""
    pts, cells, nbrs, rng = _jittered(meshgen.quad_rect_mesh(6, 5), 8, 0.08)
    q = _mixed_queries(rng, 3000, pts.min(axis=0), pts.max(axis=0))
    q[:, 2] = 0.0
    f, _, _ = _port_vs_oracle(pts, cells, nbrs, "quad", q, "walk")
    assert 0.5 < f.mean() < 0.95


# ---------------------------------------------------------------------
# The port's tracer in float64


def _oracle_trace_case(name):
    """(mesh, cell type, field columns, y0, trace kwargs, icell mask) of
    ``tests/test_serial_oracle.py``'s trace cases."""
    kw = dict(min_dx=1e-6, max_dx=0.05, max_steps=400, rtol=1e-8, atol=1e-8)
    mask = None
    if name == "tet_helix":
        pts, cells, nbrs = meshgen.tet_box_mesh(6, 6, 6)
        fld = [-(pts[:, 1] - 0.5), pts[:, 0] - 0.5, np.full(len(pts), 0.25)]
        y0 = np.array([[0.8, 0.5, 0.1], [0.5, 0.3, 0.5], [0.25, 0.25, 0.05]])
        kw["max_dx"] = 0.04
        return (pts, cells, nbrs), "tetra", fld, y0, kw, mask
    if name == "quad":
        pts, cells, nbrs, _ = _jittered(meshgen.quad_rect_mesh(8, 7), 11, 0.06)
        # strictly interior seeds: a start exactly on an edge is an
        # epsilon tie (the port's inside test tolerates -1e-10)
        return ((pts, cells, nbrs), "quad", [-pts[:, 1], pts[:, 0]],
                np.array([[1.5, 0.05], [0.5, 0.5], [1.2, 0.3]]), kw, mask)
    pts, cells, nbrs = meshgen.triangle_rect_mesh(8, 7)
    n = len(pts)
    if name == "circle":
        fld = [-pts[:, 1], pts[:, 0]]
        y0 = np.array([[1.5, 0.0], [0.5, 0.5], [1.0, 0.25], [1.9, 1.9]])
    elif name == "mask":
        fld = [np.ones(n), np.zeros(n)]
        y0 = np.array([[0.25, 0.5], [1.5, 0.5], [0.6, 1.1]])
        mask = "x < 1"
    elif name == "buffer_fill":  # orbits about (1, 1) that never exit
        fld = [-(pts[:, 1] - 1.0), pts[:, 0] - 1.0]
        y0 = np.array([[1.5, 1.0], [1.0, 0.6]])
        kw["max_steps"] = 40
    else:  # axisymmetric
        fld = [np.full(n, -0.05), np.ones(n)]
        y0 = np.array([[0.05, 0.1], [0.8, 0.2]])
        kw["axisymmetric"] = True
    return (pts, cells, nbrs), "triangle", fld, y0, kw, mask


@pytest.mark.parametrize("name", ["circle", "tet_helix", "mask", "quad",
                                  "buffer_fill", "axisymmetric"])
def test_trace_matches_oracle(name):
    """integrate_along_field on float64 walk grids against serial_trace:
    the quarter circle, the helix in the tet box (3D face crossings and
    the shrink loop in z), a material interface of an icell mask, the
    jittered quads, a closed orbit that fills the buffer, and the
    axisymmetric radius clamp."""
    (pts, cells, nbrs), cell_type, fld, y0, kw, mask = _oracle_trace_case(name)
    names = ("vx", "vy", "vz")[:len(fld)]
    grid = tiu.build_grid(pts, cells, nbrs, cell_type,
                          point_data=dict(zip(names, fld)),
                          dtype=torch.float64, locate_mode="walk",
                          device="cpu")
    i_field = tuple(range(len(fld)))
    tkw, okw = dict(kw), dict(kw)
    if mask is not None:
        centers = grid.cell_centers().numpy()
        mat = np.where(centers[:, 0] < 1.0, 0, 7).astype(np.int32)
        grid, i_mat = tiu.add_icell_data(grid, "material", mat)
        tkw.update(i_icell_mask=i_mat, mask_value=0)
        okw.update(icell_mask=mat, mask_value=0)
    res = tiu.integrate_along_field(grid, torch.from_numpy(y0), i_field,
                                    **tkw)
    out = serial_oracle.serial_trace(
        pts, cells, nbrs, np.stack(fld, axis=1), y0,
        cell_type="quad" if cell_type == "quad" else None, **okw)
    if name == "buffer_fill":
        # full buffers: no termination tail to excuse
        assert (res.n_steps.numpy() == kw["max_steps"] + 1).all()
        np.testing.assert_array_equal(res.n_steps.numpy(), out[2])
        assert (res.boundary_material.numpy() == BM_NOT_REACHED).all()
        np.testing.assert_array_equal(res.boundary_material.numpy(), out[3])
        np.testing.assert_allclose(res.y.numpy(), out[0], rtol=0, atol=1e-9)
        np.testing.assert_allclose(res.y_field.numpy(), out[1], rtol=0,
                                   atol=1e-9)
        return
    _compare_traces(res, *out)
    if name == "mask":
        assert int(res.boundary_material[0]) == 7
        assert int(res.n_steps[1]) == 1


@pytest.mark.parametrize("package", ["port", "jax"])
def test_trace_tail_at_coarse_min_dx(package):
    """At ``chip_smoke.py``'s trace settings (min_dx 1e-4, rtol = atol =
    1e-3) both packages end some helix lines one step after the oracle:
    after a failed walk they cap the next step at 0.75 dx, the oracle
    takes (1 - 1e-8) of the distance to the wall.  The curves before the
    tail still agree at 1e-9, and the final states within 2 min_dx, the
    smoke's oracle-phase rules."""
    kw = dict(min_dx=1e-4, max_dx=0.05, max_steps=256, rtol=1e-3, atol=1e-3)
    pts, cells, nbrs = meshgen.tet_box_mesh(8, 8, 8)
    fld = np.stack([-(pts[:, 1] - 0.5), pts[:, 0] - 0.5,
                    np.full(len(pts), 0.25)], axis=1)
    y0 = 0.3 + 0.4 * np.random.default_rng(3).random((64, 3))
    pd = {"vx": fld[:, 0], "vy": fld[:, 1], "vz": fld[:, 2]}
    if package == "port":
        grid = tiu.build_grid(pts, cells, nbrs, "tetra", point_data=pd,
                              dtype=torch.float64, locate_mode="walk",
                              device="cpu")
        res = tiu.integrate_along_field(grid, torch.from_numpy(y0),
                                        (0, 1, 2), **kw)
    else:
        pytest.importorskip("jax")
        import jax.numpy as jnp

        import interpolate_unstructured_tpu as jiu
        from interpolate_unstructured_tpu.trace import integrate_along_field

        grid = jiu.build_grid(pts, cells, nbrs, "tetra", point_data=pd,
                              dtype=jnp.float64, locate_mode="walk")
        jres = integrate_along_field(grid, jnp.asarray(y0), (0, 1, 2), **kw)
        res = tiu.TraceResult(*(torch.from_numpy(np.array(a))
                                for a in jres))
    out = serial_oracle.serial_trace(pts, cells, nbrs, fld, y0, **kw)
    longer = res.n_steps.numpy().astype(int) - out[2]
    assert set(np.unique(longer)) <= {0, 1} and (longer == 1).any()
    _compare_traces(res, *out, final_atol=2 * kw["min_dx"])
