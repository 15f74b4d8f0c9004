"""The check that decides ``correct`` fails what it must: the control
(the reference in the precision below the configuration's, in the
program's place) and a run whose timed path is broken underneath, each
at a size a test can hold, with the chip's look skipped; and the
reference agrees with the port's CPU path."""

import time
import types

import pytest
import torch

from conftest import shrink
from iubench import harness

import interpolate_unstructured_tpu_torch as real_tiu

QUERY_CELLS = ["tet998k_f32.cold", "tet998k_f64_walk.particles"]
TRACE_CELLS = ["tet998k_f32.fieldlines"]


def run(workload, tiu=real_tiu, control=None, seed=21):
    spec = shrink(harness.find_spec(workload))
    # seconds=0: the window makes MIN_CALLS calls, whatever the CPU's speed
    return harness.run_cell(spec, seed, 0, False, "cpu",
                            time.perf_counter(), tiu, control=control)


def failing(checks):
    return [k for k, c in checks.items()
            if c["value"] is None or c["value"] > c["limit"]]


@pytest.mark.parametrize("workload", QUERY_CELLS + TRACE_CELLS)
def test_program_passes_and_control_fails(workload):
    out = run(workload, control=True)
    assert out["correct"], out["checks"]
    assert failing(out["control_checks"]), out["control_checks"]


class Faulty(types.SimpleNamespace):
    """The port's module with one entry broken underneath the harness."""


def broken(fault, entry):
    """``entry`` with ``fault``: "unchanged" (each call returns the first
    call's answers), "half" (the second half of the batch left out),
    "altered" (one answer changed where it is produced)."""
    first = {}

    def wrapped(grid, r, *args, **kw):
        out = entry(grid, r, *args, **kw)
        if fault == "unchanged":
            return first.setdefault("out", out)
        if isinstance(out, tuple) and hasattr(out, "y"):  # a trace
            y, n = out.y.clone(), out.n_steps.clone()
            code = out.boundary_material.clone()
            half = y.shape[0] // 2
            if fault == "half":
                y[half:, 1:] = 0
                n[half:] = 1
                code[half:] = -2
            else:
                y[0, 1, 0] += 1e-2
            return out._replace(y=y, n_steps=n, boundary_material=code)
        vals, ic, found = (t.clone() for t in out)
        half = vals.shape[0] // 2
        if fault == "half":
            vals[half:] = 0
            ic[half:] = -1
            found[half:] = False
        else:
            vals[3] += 1e-2
        return vals, ic, found

    return wrapped


ENTRY = {"tet998k_f32.cold": "interpolate_scalar_at",
         "tet998k_f64_walk.particles": "interpolate_at",
         "tet998k_f32.fieldlines": "integrate_along_field"}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", QUERY_CELLS + TRACE_CELLS)
def test_broken_timed_path_is_not_correct(workload, fault):
    name = ENTRY[workload]
    tiu = Faulty(**{k: getattr(real_tiu, k) for k in real_tiu.__all__})
    setattr(tiu, name, broken(fault, getattr(real_tiu, name)))
    out = run(workload, tiu)
    assert not out["correct"], (fault, out["checks"])


def test_reference_agrees_with_the_port_on_the_cpu():
    """Cells, found flags and values of the port's CPU path against the
    reference, on a 6^3-cube box with nonlinear data, float64."""
    from iubench import fields, mesh
    from iubench.meshes.tet_box import tet_box
    from iubench.reference.locate import RefMesh

    points, cells = tet_box(6)
    nb = mesh.face_neighbors(cells, "tetra")
    data = fields.smooth_field(points, 1, "phi")
    grid = real_tiu.build_grid(points, cells, nb, "tetra",
                               point_data={"phi": data},
                               dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(1)
    q = torch.rand(4000, 3, generator=g, dtype=torch.float64) * 1.2 - 0.1
    vals, ic, found = real_tiu.interpolate_scalar_at(grid, q, 0)
    ref = RefMesh(points, cells)
    rc, inside = ref.locate(q)
    clear = inside.abs() > 1e-12
    assert torch.equal(found[clear], (inside >= 0)[clear])
    assert float(ref.depth(q[found], ic[found].long()).max()) < 1e-12
    want = ref.interpolate(q[found], rc[found], torch.as_tensor(data)[:, None])
    assert float((vals[found] - want[:, 0]).abs().max()) < 1e-13


def test_reference_tracer_agrees_with_the_port_in_float64():
    """The reference tracer against the port's float64 (generic) trace
    on the CPU: codes and step counts identical, curves within 1e-12."""
    from iubench import fields, mesh, traces
    from iubench.meshes.tet_box import tet_box
    from iubench.reference import tracer
    from iubench.reference.locate import RefMesh

    points, cells = tet_box(6)
    nb = mesh.face_neighbors(cells, "tetra")
    h = fields.helix(points)
    grid = real_tiu.build_grid(
        points, cells, nb, "tetra",
        point_data={"bx": h[:, 0], "by": h[:, 1], "bz": h[:, 2]},
        dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(2)
    y0 = 0.3 + 0.4 * torch.rand(24, 3, generator=g, dtype=torch.float64)
    kw = dict(min_dx=1e-4, max_dx=0.05, max_steps=64, rtol=1e-3, atol=1e-3)
    res = real_tiu.integrate_along_field(grid, y0, (0, 1, 2), **kw)
    hull = tracer.hull_planes(points, cells, nb, torch.float64, "cpu")
    y, yf, ns, code = tracer.trace(RefMesh(points, cells), hull,
                                   torch.as_tensor(h), y0, shrink_eps=1e-8,
                                   **kw)
    got = {"y": res.y, "y_field": res.y_field, "n_steps": res.n_steps,
           "code": res.boundary_material}
    want = {"y": y, "y_field": yf, "n_steps": ns, "code": code}
    codes, steps, curve, final = traces.compare(got, want, kw["max_steps"])
    assert (codes, steps) == (0, 0)
    assert curve < 1e-12 and final < 1e-12
