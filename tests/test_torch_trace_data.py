"""The grid's data-mutation API against the JAX package's.

Both packages build the same float32 grid natively (``cand_build="host"``)
and apply the same sequence of ``reserve_*``, ``add_*`` and
``set_point_data`` calls; the registries (names, columns, reserved
capacity) must come out identical.  On a candidate grid whose rows can
fuse more variables (the 8x8x8 tet box, one variable to start with),
``add_point_data(fuse=True)`` repacks the rows with the new variable in
both packages, and the tables are compared as ``tests/test_torch_build.py``
compares them (ids, counts and padding identical, float columns to the
float32 rounding of the two packers); ``fuse=False`` leaves the rows
as they were; ``set_point_data`` of a fused column repacks with the
pinned variable count.
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import interpolate_unstructured_tpu as jiu  # noqa: E402
import interpolate_unstructured_tpu_torch as tiu  # noqa: E402
from interpolate_unstructured_tpu.utils import meshgen  # noqa: E402
from test_torch_build import _compare_rows  # noqa: E402

HOST = jiu.IUConfig(cand_build="host")


def _build_both(pts, cells, nbrs, cell_type, **kw):
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jnp.float32,
                        config=HOST, **kw)
    tg = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                        config=tiu.IUConfig(**dataclasses.asdict(HOST)),
                        device="cpu", **kw)
    return ug, tg


def _same_registries(ug, tg):
    for fam in ("point", "cell", "icell"):
        names = f"{fam}_data_names"
        assert getattr(tg, names) == getattr(ug, names), fam
        t = getattr(tg, f"{fam}_data")
        j = np.asarray(getattr(ug, f"{fam}_data"))
        assert t.dtype == (torch.int32 if fam == "icell" else torch.float32)
        np.testing.assert_array_equal(t.numpy(), j, err_msg=fam)
    # the accurate-mode residual registry follows the point data
    np.testing.assert_array_equal(tg.point_data_lo.numpy(),
                                  np.asarray(ug.point_data_lo))


def _apply(mod, g, pts, n_cells):
    """The same mutations through either package's API; returns the grid
    and the indices the adders returned."""
    idx = []
    g = mod.reserve_point_data_storage(g, 2)
    g = mod.reserve_icell_data_storage(g, 1)
    for name, v in (("a", pts[:, 0]), ("b", None), ("c", pts[:, 1] * 2.0)):
        g, i = mod.add_point_data(g, name, v, fuse=False)
        idx.append(i)
    g = mod.set_point_data(g, idx[1], np.sin(pts[:, 2] + 1.0))
    g = mod.set_point_data(g, -1, 3.25)  # a scalar, python-style index
    g, i = mod.add_cell_data(g, "half", np.arange(n_cells) * 0.5)
    idx.append(i)
    g = mod.reserve_cell_data_storage(g, 3)
    g, i = mod.add_cell_data(g, "zero")
    idx.append(i)
    for name, v in (("mat", np.arange(n_cells) % 3), ("id", np.arange(n_cells))):
        g, i = mod.add_icell_data(g, name, v)
        idx.append(i)
    return g, idx


def test_mutations_give_the_jax_registries():
    pts, cells, nbrs = meshgen.triangle_rect_mesh(6, 5)
    ug, tg = _build_both(pts, cells, nbrs, "triangle",
                         point_data={"P": pts.sum(1)})
    tg0 = tg
    ug, jidx = _apply(jiu, ug, pts, len(cells))
    tg, tidx = _apply(tiu, tg, pts, len(cells))
    assert tidx == jidx == [1, 2, 3, 0, 1, 0, 1]
    _same_registries(ug, tg)
    # reserved capacity: point data filled two reserved columns, then
    # grew by one; the cell-data reserve kept two spare columns
    assert tg.point_data.shape[1] == 4 and tg.cell_data.shape[1] == 4
    assert tiu.get_point_data_index(tg, "c") == 3
    # the original grid is left as it was
    assert tg0.n_point_data == 1 and tg0.point_data.shape == (len(pts), 1)
    with pytest.raises(ValueError, match="live point-data"):
        tiu.set_point_data(tg, 4, 0.0)


def test_unfused_variable_interpolates_as_jax():
    """A variable added with fuse=False is read by the generic
    interpolation route, as in the JAX package."""
    pts, cells, nbrs = meshgen.tet_box_mesh(5, 5, 5)
    ug, tg = _build_both(pts, cells, nbrs, "tetra", locate_mode="walk",
                         point_data={"P": pts.sum(1)})
    ug, _ = jiu.add_point_data(ug, "Q", pts[:, 0] - pts[:, 2], fuse=False)
    tg, iq = tiu.add_point_data(tg, "Q", pts[:, 0] - pts[:, 2], fuse=False)
    r = np.random.default_rng(8).random((500, 3)).astype(np.float32)
    jv, _, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(r), iq)
    tv, _, tf = tiu.interpolate_scalar_at(tg, torch.from_numpy(r), iq)
    assert torch.equal(tf, torch.from_numpy(np.array(jf)))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=2e-6)


def test_fuse_repacks_the_candidate_rows_as_jax():
    pts, cells, nbrs = meshgen.tet_box_mesh(8, 8, 8)
    ug, tg = _build_both(pts, cells, nbrs, "tetra", locate_mode="walk",
                         point_data={"P": pts.sum(1) + 1.0})
    assert tg.cand_nv == ug.cand_nv == 1
    xy = pts[:, 0] * pts[:, 1]

    # fuse=False: the rows stay as they were
    tg_nf, _ = tiu.add_point_data(tg, "XY", xy, fuse=False)
    assert tg_nf.cand_table is tg.cand_table and tg_nf.cand_nv == 1

    # fuse=True: both packages repack with the new variable fused
    ug2, _ = jiu.add_point_data(ug, "XY", xy)
    tg2, _ = tiu.add_point_data(tg, "XY", xy)
    assert tg2.cand_nv == ug2.cand_nv == 2
    k = ug2.cand_ids.shape[1]
    _compare_rows(np.asarray(ug2.cand_table), tg2.cand_table.numpy(), ug2, k,
                  True, 2)
    np.testing.assert_allclose(tg2.cand_qeps, ug2.cand_qeps, rtol=1e-6)

    # set_point_data of a fused column repacks at the pinned count; of an
    # unfused one leaves the rows alone
    new = np.cos(pts[:, 2])
    ug3 = jiu.set_point_data(ug2, 1, new)
    tg3 = tiu.set_point_data(tg2, 1, new)
    assert tg3.cand_nv == ug3.cand_nv == 2
    _compare_rows(np.asarray(ug3.cand_table), tg3.cand_table.numpy(), ug3, k,
                  True, 2)
    tg4 = tiu.set_point_data(tg_nf, 1, new)
    assert tg4.cand_table is tg.cand_table and tg4.cand_nv == 1

    # the repacked rows answer queries with the new values
    r = np.random.default_rng(9).random((500, 3)).astype(np.float32)
    tv, _, tf = tiu.interpolate_scalar_at(tg3, torch.from_numpy(r), 1)
    assert bool(tf.all())
    np.testing.assert_allclose(tv.numpy(), np.cos(r[:, 2]), rtol=0, atol=0.05)


def test_accurate_mode_registries_raise():
    """The mutation API keeps the accurate-mode registries in step
    (tests/test_torch_acc.py holds them to the JAX package's); what
    raises is an accurate call on a grid without its acc table."""
    pts, cells, nbrs = meshgen.triangle_rect_mesh(3, 3)
    tg = tiu.build_grid(pts, cells, nbrs, "triangle", device="cpu",
                        point_data={"P": pts.sum(1)})
    assert tg.point_data_lo.shape == tg.point_data.shape
    tg2, iq = tiu.add_point_data(tg, "Q", pts[:, 0] / 3.0)
    assert tg2.point_data_lo.shape == (len(pts), 2) and tg2.acc_table is None
    np.testing.assert_array_equal(
        tg2.point_data_lo[:, iq].numpy(),
        (pts[:, 0] / 3.0 - (pts[:, 0] / 3.0).astype(np.float32)).astype(
            np.float32))
    tg3 = tiu.set_point_data(tiu.prepare_accurate(tg2), 0, 1.0)
    assert not tg3.point_data_lo[:, 0].any()
    assert (tg3.acc_table[:, 18:21] == 1.0).all()
    r = torch.tensor([[0.5, 0.5, 0.0]], dtype=torch.float64)
    with pytest.raises(ValueError, match="prepare_accurate"):
        tiu.interpolate_at_acc(tg2, r, (0,))


def test_build_kdtree_defaults_to_the_card(monkeypatch):
    """Without ``device`` the tree goes to the CUDA device: here, where
    none is available, it raises instead of building on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(1).random((50, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiu.build_kdtree(pts)
    tree = tiu.build_kdtree(pts, device="cpu")
    idx, _ = tiu.kdtree_nearest(tree, torch.from_numpy(pts[:5]))
    assert idx.tolist() == list(range(5)) and isinstance(tree, tiu.KdTree)
