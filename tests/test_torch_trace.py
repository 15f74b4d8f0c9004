"""The port's field-line tracer against the JAX package.

The meshes of ``tests/test_pallas_trace.py``: ``meshgen`` 9x8 triangles
and quads with the circular field (-y, x), and the 6x6x6 tet box with a
helical field.  The JAX package builds each float32 grid, which reaches
the port through ``grid_from_numpy`` (the same tables, bit for bit), and
both packages trace the same seeds:

* the fused path (kernel B4): the JAX package's Pallas kernel in
  interpret mode (``pallas_trace.supported`` patched, as
  ``tests/test_pallas_trace.py`` does) against the port, whose float32
  traces without a mask or extra variables take B4's plain version on
  the CPU;
* the generic path (walks of kernel B3 on the trace table, then the
  interpolation in torch): the JAX package's XLA path against the port's
  (``trace_kernel.supported`` patched to False where the case would
  otherwise take the fused path).

Tolerance: ``n_steps`` and ``boundary_material`` identical; ``y`` and
``y_field`` within 5e-5, the JAX package's own fused-path tolerance
(``tests/test_pallas_trace.py:74``): XLA on the CPU contracts the JAX
side's float32 products and sums into FMAs and torch rounds each
operation, so the curves agree to float32 rounding accumulated over the
steps.  Float64 traces are held against the independent serial C++
oracle at 1e-9, with ``tests/test_serial_oracle.py``'s rules for the
end of a trace.
"""

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models.grid import (
    DATA_FIELDS,
    META_FIELDS,
)
from interpolate_unstructured_tpu_torch.ops import trace_kernel, walk_kernel
from interpolate_unstructured_tpu_torch.utils import meshgen

TRACE_KW = dict(min_dx=1e-4, max_dx=0.1, max_steps=60, rtol=1e-3, atol=1e-3)
TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests.

    On some virtualized x86 hosts the first float32 torch.sqrt that a
    worker thread runs in a process returns values off by ~1e-4 relative
    for that thread's chunk; every later call is exact.  The tracer
    calls torch.sqrt on every iteration, so the first, discarded call is
    made here."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu

    return jnp, jiu


def _port(ug, device="cpu"):
    """The JAX package's grid carried into the port, table for table."""
    return tiu.grid_from_numpy(
        {f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
         for f in DATA_FIELDS},
        {f: getattr(ug, f) for f in META_FIELDS}, device,
    )


def _field_2d(p):
    return -p[:, 1], p[:, 0]  # circles around the origin


def _field_3d(p):
    # rotation in (x, y) around the box center + lift
    return 0.5 - p[:, 1], p[:, 0] - 0.5, np.full(len(p), 0.3)


def _grid(cell_type, dtype="float32", field=None, **kw):
    """(JAX grid, i_field) of a test mesh with its traced field."""
    jnp, jiu = _jax()
    if cell_type == "tetra":
        pts, cells, nbrs = meshgen.tet_box_mesh(6, 6, 6)
    elif cell_type == "triangle":
        pts, cells, nbrs = meshgen.triangle_rect_mesh(9, 8)
    else:
        pts, cells, nbrs = meshgen.quad_rect_mesh(9, 8)
    ug = jiu.build_grid(pts, cells, nbrs, cell_type,
                        dtype=getattr(jnp, dtype), **kw)
    p = np.asarray(ug.points, np.float64)
    if field is None:
        field = _field_3d if cell_type == "tetra" else _field_2d
    i_field = []
    for name, values in zip(("vx", "vy", "vz"), field(p)):
        ug, i = jiu.add_point_data(ug, name, values)
        i_field.append(i)
    return ug, tuple(i_field)


Y0 = {
    # interior circles, near-boundary exits and one start outside
    "2d": np.array([[1.5, 0.0], [0.5, 0.5], [1.0, 0.25], [1.9, 1.9],
                    [-5.0, -5.0]]),
    "3d": np.array([[0.3, 0.5, 0.1], [0.5, 0.2, 0.5], [0.9, 0.9, 0.05],
                    [0.05, 0.05, 0.9], [2.0, 0.5, 0.5]]),
}


def _trace_jax(ug, y0, i_field, monkeypatch=None, fused=False, **kw):
    jnp, _ = _jax()
    from interpolate_unstructured_tpu.ops import pallas_trace
    from interpolate_unstructured_tpu.trace import integrate_along_field

    if fused:
        monkeypatch.setattr(pallas_trace, "supported", lambda *a: True)
    res = integrate_along_field(ug, jnp.asarray(y0, ug.dtype), i_field, **kw)
    if fused:
        monkeypatch.undo()
    return res


def _trace_port(tg, y0, i_field, monkeypatch=None, generic=False, **kw):
    if generic:
        monkeypatch.setattr(trace_kernel, "supported", lambda *a: False)
    res = tiu.integrate_along_field(tg, torch.as_tensor(y0), i_field, **kw)
    if generic:
        monkeypatch.undo()
    return res


def _assert_parity(rj, rt, max_steps, tol=TOL):
    n_j = np.asarray(rj.n_steps)
    np.testing.assert_array_equal(rt.n_steps.numpy(), n_j)
    np.testing.assert_array_equal(rt.boundary_material.numpy(),
                                  np.asarray(rj.boundary_material))
    assert rt.y.shape == rj.y.shape and rt.y_field.shape == rj.y_field.shape
    for b in range(len(n_j)):
        m = min(int(n_j[b]), max_steps)
        np.testing.assert_allclose(rt.y[b, :m].numpy(), np.asarray(rj.y[b, :m]),
                                   rtol=0, atol=tol, err_msg=f"trajectory {b}")
        np.testing.assert_allclose(
            rt.y_field[b, :m].numpy(), np.asarray(rj.y_field[b, :m]),
            rtol=0, atol=tol, err_msg=f"field samples {b}",
        )


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("cell_type", ["triangle", "quad", "tetra"])
def test_build_trace_table_matches_jax(cell_type, dtype):
    jnp, jiu = _jax()
    ug, i_field = _grid(cell_type, dtype)
    tg = _port(ug)
    jt = np.asarray(jiu.build_trace_table(ug, jnp.asarray(i_field)))
    tt = tiu.build_trace_table(tg, i_field)
    assert tt.dtype == getattr(torch, dtype) and tt.is_contiguous()
    assert tt.shape == jt.shape == (ug.n_cells, 64)
    np.testing.assert_array_equal(tt.numpy(), jt)


@pytest.mark.parametrize("case", ["triangle", "quad", "tetra", "reverse"])
def test_fused_trace_matches_jax(monkeypatch, case):
    cell_type = "triangle" if case == "reverse" else case
    ug, i_field = _grid(cell_type)
    tg = _port(ug)
    y0 = Y0["3d" if cell_type == "tetra" else "2d"]
    kw = dict(TRACE_KW, reverse=case == "reverse")
    assert trace_kernel.supported(tg, None, 0)
    rj = _trace_jax(ug, y0, i_field, monkeypatch, fused=True, **kw)
    rt = _trace_port(tg, y0, i_field, **kw)
    _assert_parity(rj, rt, TRACE_KW["max_steps"])
    # invalid start: one point, physical-boundary code
    assert int(rt.n_steps[-1]) == 1 and int(rt.boundary_material[-1]) == -1
    # the fused rounds ran, and the JAX package counts them the same way
    assert int(rt.n_rounds) == int(rj.n_rounds) > 0
    if case == "triangle":
        # the quarter circle from (1.5, 0) lands on (0, 1.5)
        n = int(rt.n_steps[0])
        np.testing.assert_allclose(rt.y[0, n - 1].numpy(), [0.0, 1.5],
                                   atol=2e-2)


@pytest.mark.parametrize("case", ["triangle", "quad", "tetra", "axisymmetric"])
def test_generic_trace_matches_jax(monkeypatch, case):
    """B3 walks on the trace table + torch interpolation, against the
    JAX package's XLA path; axisymmetric on a field pushing towards the
    axis (both paths of the port)."""
    kw = dict(TRACE_KW)
    if case == "axisymmetric":
        ug, i_field = _grid("triangle", field=lambda p: (
            np.full(len(p), -0.05), np.ones(len(p))))
        y0 = np.array([[0.05, 0.1], [0.8, 0.2], [1e-3, 1.5]])
        kw["axisymmetric"] = True
    else:
        ug, i_field = _grid(case)
        y0 = Y0["3d" if case == "tetra" else "2d"]
    tg = _port(ug)
    rj = _trace_jax(ug, y0, i_field, **kw)
    rt = _trace_port(tg, y0, i_field, monkeypatch, generic=True, **kw)
    _assert_parity(rj, rt, TRACE_KW["max_steps"])
    assert int(rt.n_rounds) == 0
    if case == "axisymmetric":
        for b, n in enumerate(rt.n_steps.tolist()):
            assert float(rt.y[b, :n, 0].min()) >= np.float32(1e-12)
        rf = _trace_port(tg, y0, i_field, **kw)  # the fused path
        _assert_parity(rj, rf, TRACE_KW["max_steps"])


def test_mask_region_matches_jax():
    """Integration restricted to material 0 stops at the interface and
    reports the entered cell's value; a start in material 7 stops at
    once with code 7."""
    jnp, jiu = _jax()
    ug, i_field = _grid("triangle", field=lambda p: (
        np.ones(len(p)), np.zeros(len(p))))
    centers = np.asarray(ug.cell_points).mean(axis=1)
    mat = np.where(centers[:, 0] < 1.0, 0, 7).astype(np.int32)
    ug, i_mat = jiu.add_icell_data(ug, "material", mat)
    tg = _port(ug)
    y0 = np.array([[0.25, 0.5], [1.5, 0.5], [0.6, 1.1], [-5.0, -5.0]])
    kw = dict(TRACE_KW, i_icell_mask=i_mat, mask_value=0)
    assert not trace_kernel.supported(tg, i_mat, 0)
    rj = _trace_jax(ug, y0, i_field, **kw)
    rt = _trace_port(tg, y0, i_field, **kw)
    _assert_parity(rj, rt, TRACE_KW["max_steps"])
    np.testing.assert_array_equal(rt.boundary_material.numpy(), [7, 7, 7, -1])
    n = int(rt.n_steps[0])
    assert 1 < n <= TRACE_KW["max_steps"]
    assert float(rt.y[0, n - 1, 0]) < 1.0 + 1e-4
    assert int(rt.n_steps[1]) == 1


def test_extra_variable_matches_jax():
    """nvar = 1 with sub_int: the arc length along the quarter circle."""
    jnp, _ = _jax()
    ug, i_field = _grid("triangle")
    tg = _port(ug)
    y0 = np.array([[1.5, 0.0, -0.75 * np.pi], [0.5, 0.5, 0.0],
                   [-5.0, -5.0, 1.0]])
    rj = _trace_jax(ug, y0, i_field, nvar=1,
                    sub_int=lambda f, y: jnp.ones(1, dtype=y.dtype), **TRACE_KW)
    rt = _trace_port(tg, y0, i_field, nvar=1,
                     sub_int=lambda f, y: y.new_ones(1), **TRACE_KW)
    _assert_parity(rj, rt, TRACE_KW["max_steps"])
    n = int(rt.n_steps[0])
    # quarter circle: exits at (0, 1.5) with arc length 0.75 pi
    assert abs(float(rt.y[0, n - 1, 2])) < 2e-2
    assert rt.y.shape == (3, TRACE_KW["max_steps"], 3)


@pytest.mark.parametrize("path", ["fused", "generic"])
def test_zero_field_and_step_cap_match_jax(monkeypatch, path):
    """A zero field steps in place until the buffer fills
    (BM_NOT_REACHED); a walk cap of 2 at min_dx = 0.5 ends as
    BM_STEP_CAP, never as a boundary."""
    jnp, jiu = _jax()
    from interpolate_unstructured_tpu.trace import BM_STEP_CAP

    pts, cells, nbrs = meshgen.triangle_rect_mesh(6, 5)
    zero = np.zeros(len(pts))
    ug = jiu.build_grid(pts, cells, nbrs, "triangle", dtype=jnp.float32,
                        point_data={"vx": zero, "vy": zero},
                        locate_mode="walk")
    kw = dict(min_dx=1e-5, max_dx=0.1, max_steps=10, rtol=1e-3, atol=1e-3)
    y0 = np.array([[1.0, 1.0], [0.3, 0.7]])
    rj = _trace_jax(ug, y0, (0, 1), **kw)
    rt = _trace_port(_port(ug), y0, (0, 1), monkeypatch,
                     generic=path == "generic", **kw)
    _assert_parity(rj, rt, kw["max_steps"])
    assert (rt.boundary_material == tiu.trace.BM_NOT_REACHED).all()
    assert (rt.n_steps == 11).all() and (rt.n_iterations <= 60).all()
    assert bool(torch.isfinite(rt.y).all())

    pts, cells, nbrs = meshgen.triangle_rect_mesh(16, 16)
    ug = jiu.build_grid(pts, cells, nbrs, "triangle", dtype=jnp.float32,
                        point_data={"vx": np.ones(len(pts)),
                                    "vy": np.zeros(len(pts))},
                        locate_mode="walk",
                        config=jiu.IUConfig(trace_walk_max_steps=2))
    kw = dict(min_dx=0.5, max_dx=0.5, max_steps=50, rtol=1e-3, atol=1e-3)
    y0 = np.array([[0.2, 1.0]])
    rj = _trace_jax(ug, y0, (0, 1), **kw)
    rt = _trace_port(_port(ug), y0, (0, 1), monkeypatch,
                     generic=path == "generic", **kw)
    _assert_parity(rj, rt, kw["max_steps"])
    assert int(rt.boundary_material[0]) == BM_STEP_CAP == tiu.trace.BM_STEP_CAP


@pytest.mark.parametrize("path", ["fused", "generic"])
def test_prebuilt_table_matches_inline(monkeypatch, path):
    """trace_table= with a prebuilt table gives exactly the inline
    result, and both match the JAX package."""
    ug, i_field = _grid("triangle")
    tg = _port(ug)
    y0 = np.array([[1.5, 0.0], [0.5, 0.5], [1.0, 1.9]])
    generic = path == "generic"
    ref = _trace_port(tg, y0, i_field, monkeypatch, generic, **TRACE_KW)
    got = _trace_port(tg, y0, i_field, monkeypatch, generic,
                      trace_table=tiu.build_trace_table(tg, i_field),
                      **TRACE_KW)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    rj = _trace_jax(ug, y0, i_field, monkeypatch, fused=not generic,
                    **TRACE_KW)
    _assert_parity(rj, got, TRACE_KW["max_steps"])


def test_trace_arguments_are_checked():
    ug, i_field = _grid("triangle")
    tg = _port(ug)
    y0 = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="max_dx"):
        tiu.integrate_along_field(tg, y0, i_field, min_dx=1.0, max_dx=0.5,
                                  max_steps=4, rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="together"):
        tiu.integrate_along_field(tg, y0, i_field, i_icell_mask=0,
                                  **TRACE_KW)
    with pytest.raises(ValueError, match="2D"):
        tiu.integrate_along_field(tg, y0, (0, 1, 0), **TRACE_KW)
    with pytest.raises(ValueError, match="shape"):
        tiu.integrate_along_field(tg, torch.zeros((2, 3)), i_field,
                                  **TRACE_KW)


# ---------------------------------------------------------------------
# Float64 against the independent serial C++ oracle


def _compare_traces(res, oy, oyf, ons, obm, atol=1e-9, final_atol=1e-6):
    """Trajectory agreement, tolerant only at the termination tail
    (tests/test_serial_oracle.py:222-268): identical boundary codes,
    step counts within 8 (a flipped arrived/exited walk at the wall
    costs one shrink-retry step), curves within ``atol`` up to two
    points before the shorter end, final states within
    ``final_atol`` (the shrink loop ends within ~min_dx of the wall)."""
    n_t = res.n_steps.numpy()
    np.testing.assert_array_equal(res.boundary_material.numpy(), obm)
    assert np.abs(n_t.astype(int) - ons.astype(int)).max() <= 8
    y, yf = res.y.numpy(), res.y_field.numpy()
    max_steps = y.shape[1]
    for t in range(y.shape[0]):
        nt = min(int(n_t[t]), max_steps)
        no = min(int(ons[t]), max_steps)
        common = max(min(nt, no) - 2, 0)
        np.testing.assert_allclose(y[t, :common], oy[t, :common], rtol=0,
                                   atol=atol, err_msg=f"trajectory {t}")
        np.testing.assert_allclose(yf[t, :common], oyf[t, :common], rtol=0,
                                   atol=atol, err_msg=f"field samples {t}")
        np.testing.assert_allclose(y[t, nt - 1], oy[t, no - 1], rtol=0,
                                   atol=final_atol,
                                   err_msg=f"trajectory {t} final state")


def _serial_oracle():
    pytest.importorskip("jax")
    from interpolate_unstructured_tpu.utils import serial_oracle

    if not serial_oracle.available():
        pytest.skip("no C++ toolchain for the serial oracle")
    return serial_oracle


def _oracle_kw(**over):
    kw = dict(min_dx=1e-6, max_dx=0.05, max_steps=400, rtol=1e-8, atol=1e-8)
    kw.update(over)
    return kw


def test_float64_quarter_circle_matches_serial_oracle():
    """Quarter-circle protocol (test_trace_field.f90:41-64) with the arc
    length as an extra variable, both directions."""
    oracle = _serial_oracle()
    pts, cells, nbrs = meshgen.triangle_rect_mesh(8, 7)
    vx, vy = -pts[:, 1], pts[:, 0]
    tg = tiu.build_grid(pts, cells, nbrs, "triangle",
                        point_data={"vx": vx, "vy": vy}, dtype=torch.float64,
                        locate_mode="walk", device="cpu")
    y0 = np.array([[1.5, 0.0, -0.75 * np.pi], [0.5, 0.5, 0.0],
                   [1.0, 0.25, 1.0], [1.9, 1.9, 0.0]])
    kw = _oracle_kw()
    for reverse in (False, True):
        res = tiu.integrate_along_field(
            tg, torch.from_numpy(y0), (0, 1), nvar=1,
            sub_int=lambda f, y: y.new_ones(1), reverse=reverse, **kw)
        oy, oyf, ons, obm = oracle.serial_trace(
            pts, cells, nbrs, np.stack([vx, vy], axis=1), y0, nvar=1,
            reverse=reverse, **kw)
        _compare_traces(res, oy, oyf, ons, obm)


def test_float64_helix_matches_serial_oracle():
    """3D helix on the tet box: tetra weights, 3D face crossings and the
    boundary shrink loop in z."""
    oracle = _serial_oracle()
    pts, cells, nbrs = meshgen.tet_box_mesh(6, 6, 6)
    fld = np.stack([-(pts[:, 1] - 0.5), pts[:, 0] - 0.5,
                    np.full(len(pts), 0.25)], axis=1)
    tg = tiu.build_grid(pts, cells, nbrs, "tetra",
                        point_data={"vx": fld[:, 0], "vy": fld[:, 1],
                                    "vz": fld[:, 2]},
                        dtype=torch.float64, locate_mode="walk", device="cpu")
    y0 = np.array([[0.8, 0.5, 0.1], [0.5, 0.3, 0.5], [0.25, 0.25, 0.05]])
    kw = _oracle_kw(max_dx=0.04)
    res = tiu.integrate_along_field(tg, torch.from_numpy(y0), (0, 1, 2), **kw)
    oy, oyf, ons, obm = oracle.serial_trace(pts, cells, nbrs, fld, y0, **kw)
    _compare_traces(res, oy, oyf, ons, obm)


# ---------------------------------------------------------------------
# On the card


def _assert_close_runs(ra, rb, max_steps):
    """Two runs of the port (CPU and card): same step counts and codes,
    curves within TOL (the start cells come from other kernels and the
    step control's pow may round differently on the two devices)."""
    np.testing.assert_array_equal(ra.n_steps.cpu().numpy(),
                                  rb.n_steps.cpu().numpy())
    np.testing.assert_array_equal(ra.boundary_material.cpu().numpy(),
                                  rb.boundary_material.cpu().numpy())
    for b in range(ra.y.shape[0]):
        m = min(int(ra.n_steps[b]), max_steps)
        np.testing.assert_allclose(ra.y[b, :m].cpu().numpy(),
                                   rb.y[b, :m].cpu().numpy(), rtol=0, atol=TOL)


@pytest.mark.cuda
def test_cuda_trace_launches_b4_and_rejects_float64(cuda):
    """float32 without a mask runs B4 on the card and gives the CPU's
    answers; float64 (which the card once refused, hence the name) takes
    the generic path, B3's double walks and no B4, with the CPU's
    answers."""
    pts, cells, nbrs = meshgen.tet_box_mesh(6, 6, 6)
    fld = _field_3d(pts)
    pd = {"vx": fld[0], "vy": fld[1], "vz": fld[2]}
    y0 = torch.from_numpy(Y0["3d"])
    out = []
    for dev in ("cpu", cuda):
        g = tiu.build_grid(pts, cells, nbrs, "tetra", point_data=pd,
                           dtype=torch.float32, device=dev)
        before = trace_kernel.launches
        out.append(tiu.integrate_along_field(g, y0, (0, 1, 2), **TRACE_KW))
        torch.cuda.synchronize()
        assert (trace_kernel.launches > before) == (dev == cuda)
    _assert_close_runs(*out, TRACE_KW["max_steps"])
    out = []
    for dev in ("cpu", cuda):
        g64 = tiu.build_grid(pts, cells, nbrs, "tetra", point_data=pd,
                             dtype=torch.float64, device=dev)
        before = trace_kernel.launches, walk_kernel.launches
        out.append(tiu.integrate_along_field(g64, y0, (0, 1, 2), **TRACE_KW))
        torch.cuda.synchronize()
        assert trace_kernel.launches == before[0]
        assert (walk_kernel.launches > before[1]) == (dev == cuda)
    assert out[1].y.dtype == torch.float64
    _assert_close_runs(*out, TRACE_KW["max_steps"])


@pytest.mark.cuda
def test_cuda_masked_trace_runs_b3(cuda):
    """The generic path on the card: masked walks of B3 on the trace
    table, with the CPU's answers."""
    pts, cells, nbrs = meshgen.triangle_rect_mesh(9, 8)
    centers = pts[cells].mean(axis=1)
    pd = {"vx": np.ones(len(pts)), "vy": np.zeros(len(pts))}
    icd = {"material": np.where(centers[:, 0] < 1.0, 0, 7)}
    y0 = torch.tensor([[0.25, 0.5], [1.5, 0.5], [0.6, 1.1]])
    kw = dict(TRACE_KW, i_icell_mask=0, mask_value=0)
    out = []
    for dev in ("cpu", cuda):
        g = tiu.build_grid(pts, cells, nbrs, "triangle", point_data=pd,
                           icell_data=icd, dtype=torch.float32,
                           locate_mode="walk", device=dev)
        before = walk_kernel.launches
        out.append(tiu.integrate_along_field(g, y0, (0, 1), **kw))
        assert (walk_kernel.launches > before) == (dev == cuda)
    _assert_close_runs(*out, TRACE_KW["max_steps"])
    assert out[1].boundary_material.tolist() == [7, 7, 7]
