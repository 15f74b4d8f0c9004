"""The benchmark's meshes: generators found by name, faces matched for
triangles, quads and tets as the port matches them, and the plain locate
reference on triangles.  On tets the general forms are held bit for bit
to their frozen tet-only forms (``tet_only.py``)."""

import copy

import numpy as np
import pytest
import torch

import tet_only
from iubench import fields, harness, mesh
from iubench.meshes import tet_box
from iubench.reference.locate import RefMesh

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.io.convert import get_cell_neighbors
from interpolate_unstructured_tpu_torch.utils import meshgen


def tri_mesh(nx=9, ny=7, jitter=0.2, seed=0):
    """A flat triangle mesh on [0, 2]^2 (z = 0) with its interior points
    moved by up to ``jitter`` of a cell side, so no two cells are alike."""
    points, cells, _ = meshgen.triangle_rect_mesh(nx, ny)
    rng = np.random.default_rng(seed)
    h = np.array([2.0 / nx, 2.0 / ny])
    inner = ((points[:, 0] > 0) & (points[:, 0] < 2)
             & (points[:, 1] > 0) & (points[:, 1] < 2))
    points = points.copy()
    points[inner, :2] += jitter * h * rng.uniform(-1, 1, (inner.sum(), 2))
    return points, cells


def test_tet_box_is_the_frozen_box():
    points, cells = tet_box.make({"generator": "tet_box",
                                  "cubes_per_side": 55})
    want_p, want_c = tet_only.tet_box(55)
    assert torch.equal(torch.as_tensor(points), torch.as_tensor(want_p))
    assert torch.equal(torch.as_tensor(cells), torch.as_tensor(want_c))
    assert torch.equal(torch.as_tensor(mesh.face_neighbors(cells, "tetra")),
                       torch.as_tensor(tet_only.face_neighbors(want_c)))


MESHES = {
    "triangle": tri_mesh,
    "quad": lambda: meshgen.quad_rect_mesh(8, 5)[:2],
    "tetra": lambda: tet_box.tet_box(4),
}


@pytest.mark.parametrize("cell_type", list(MESHES))
def test_face_neighbors_match_the_port(cell_type):
    points, cells = MESHES[cell_type]()
    # the cells in another order, so that faces meet in every order
    cells = cells[np.random.default_rng(1).permutation(len(cells))]
    got = mesh.face_neighbors(cells, cell_type)
    want = get_cell_neighbors(cells, points, mesh.POINTS_PER_FACE[cell_type])
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got >= 0).any() and (got < 0).any()


@pytest.mark.parametrize("fault", ["name", "cell_type"])
def test_a_bad_generator_raises(fault):
    spec = harness.find_spec("tet998k_f32.cold")
    spec.config = copy.deepcopy(spec.config)
    if fault == "name":
        spec.config["mesh"]["generator"] = "no_such_mesh"
        match = "unknown mesh generator"
    else:
        spec.config["cell_type"] = "triangle"
        match = "makes tetra cells"
    cell = harness.Cell(spec, 1, torch.device("cpu"), tiu)
    with pytest.raises(ValueError, match=match):
        harness.make_mesh(cell)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_reference_on_tets_is_the_frozen_reference(dtype):
    points, cells = tet_box.tet_box(6)
    new = RefMesh(points, cells, dtype)
    old = tet_only.RefMesh(points, cells, dtype)
    for name in ("a", "b", "inv_height", "rmin", "inv_h", "table"):
        assert torch.equal(getattr(new, name), getattr(old, name)), name
    g = torch.Generator().manual_seed(3)
    q = torch.rand(5000, 3, generator=g, dtype=torch.float64) * 1.2 - 0.1
    data = torch.as_tensor(np.stack([fields.smooth_field(points, 3, k)
                                     for k in ("u", "v")], 1))
    cell, inside = new.locate(q)
    want_cell, want_inside = old.locate(q)
    assert torch.equal(cell, want_cell) and torch.equal(inside, want_inside)
    assert torch.equal(new.lam(q, cell), old.lam(q, cell))
    assert torch.equal(new.depth(q, cell), old.depth(q, cell))
    assert torch.equal(new.interpolate(q, cell, data),
                       old.interpolate(q, cell, data))


def test_reference_on_triangles_returns_linear_data():
    points, cells = tri_mesh()
    ref = RefMesh(points, cells)
    assert ref.table.dim() == 2 and len(ref.shape) == 2
    g = torch.Generator().manual_seed(4)
    q = torch.rand(20000, 3, generator=g, dtype=torch.float64)
    q[:, :2] *= 2.0
    cell, inside = ref.locate(q)
    assert bool((inside >= 0).all())
    p = torch.as_tensor(points)
    data = torch.stack([1.5 + 2.0 * p[:, 0] - 3.0 * p[:, 1],
                        -0.25 * p[:, 0] + 0.5 * p[:, 1]], 1)
    want = torch.stack([1.5 + 2.0 * q[:, 0] - 3.0 * q[:, 1],
                        -0.25 * q[:, 0] + 0.5 * q[:, 1]], 1)
    got = ref.interpolate(q, cell, data)
    assert float((got - want).abs().max()) < 1e-13
    # z is ignored
    q0 = q.clone()
    q0[:, 2] = 0
    assert torch.equal(ref.locate(q0)[0], cell)
    assert torch.equal(ref.interpolate(q0, cell, data), got)


def test_reference_depth_on_triangles():
    """0 inside a triangle; beyond one edge, the distance to it."""
    points, cells = tri_mesh()
    ref = RefMesh(points, cells)
    g = torch.Generator().manual_seed(5)
    c = torch.randint(0, len(cells), (500,), generator=g)
    v = torch.as_tensor(points)[torch.as_tensor(cells)[c]]  # (B, 3, 3)
    w = torch.rand(500, 3, generator=g, dtype=torch.float64) + 0.05
    w = w / w.sum(1, keepdim=True)
    inner = (w[:, :, None] * v).sum(1)
    assert float(ref.depth(inner, c).max()) == 0.0
    # beyond the edge (v0, v1), straight out from a point inside it
    e = v[:, 1] - v[:, 0]
    out = torch.stack([e[:, 1], -e[:, 0], torch.zeros(500,
                                                      dtype=e.dtype)], 1)
    out = out / out.norm(dim=1, keepdim=True)
    out = torch.where(((v[:, 2] - v[:, 0]) * out).sum(1, keepdim=True) > 0,
                      -out, out)
    d = 1e-3 * torch.rand(500, generator=g, dtype=torch.float64) + 1e-4
    t = 0.3 + 0.4 * torch.rand(500, 1, generator=g, dtype=torch.float64)
    beyond = v[:, 0] + t * e + d[:, None] * out
    beyond[:, 2] = 0.7  # off the plane: ignored
    assert torch.allclose(ref.depth(beyond, c), d, rtol=1e-9, atol=0)


def test_reference_on_triangles_agrees_with_the_port():
    """Found flags, cells and values of the port's CPU path against the
    reference on a small triangle grid in float64, up to the tie band."""
    points, cells = tri_mesh()
    nb = mesh.face_neighbors(cells, "triangle")
    data = fields.smooth_field(points, 6, "phi")
    grid = tiu.build_grid(points, cells, nb, "triangle",
                          point_data={"phi": data}, dtype=torch.float64,
                          device="cpu")
    g = torch.Generator().manual_seed(6)
    q = torch.rand(8000, 3, generator=g, dtype=torch.float64) * 2.4 - 0.2
    q[:, 2] = 0
    vals, ic, found = tiu.interpolate_scalar_at(grid, q, 0)
    ref = RefMesh(points, cells)
    rc, inside = ref.locate(q)
    clear = inside.abs() > 1e-10
    assert bool(found.any()) and bool((~found).any())
    assert torch.equal(found[clear], (inside >= 0)[clear])
    assert float(ref.depth(q[found], ic[found].long()).max()) < 1e-12
    want = ref.interpolate(q[found], rc[found], torch.as_tensor(data)[:, None])
    assert float((vals[found] - want[:, 0]).abs().max()) < 1e-13
