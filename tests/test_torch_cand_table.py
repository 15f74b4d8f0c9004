"""The candidate table's column maps against the rows they describe
(``models/cand_table.py``), on the CPU.

For each row kind (quantized float32 triangles and tets, simplex float64
tets, quads in float32 and float64, accurate mode's df-plane rows of a
float32 tet box) a small grid is built and its packed rows are read back
through the ``RowLayout`` the probe gets, on the main and the extension
table: the cell ids at ``id_role``, the encoded counts at ``count_col``
and one fused variable at ``var_roles``.  The variables are linear in
the coordinates, so every interpolant the rows carry is exact and is
checked at its cell's centroid.

Then ``load_grid`` of a checkpoint whose K is the capacity K or a
cover-widened one, with its fused-variable pin or without one (a pre-v4
file's ``cand_nv = -1``): ``cand_table.stale`` keeps the lists (the
builder is not called) and the rows are packed as before.
"""

import dataclasses

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models import cand_table
from interpolate_unstructured_tpu_torch.utils import meshgen

HOST = tiu.IUConfig(cand_build="host")


def _ext(bins_per_cell, row_bytes=1024):
    """Coarse bins and no cover widening: overflow bins with extension
    rows beside bins whose list fits K."""
    return dataclasses.replace(
        HOST, cand_bins_per_cell=bins_per_cell, cand_ext_max_k=256,
        cand_cover_row_bytes=0, cand_row_bytes=row_bytes)


def _tri():
    return meshgen.triangle_rect_mesh(16, 16)


def _tet():
    return meshgen.tet_box_mesh(6, 6, 6)


def _quad():
    return meshgen.quad_rect_mesh(16, 16)


# name: (cell type, mesh, dtype, config, row kind)
KINDS = {
    "quantized-triangle": ("triangle", _tri, torch.float32, _ext(0.3),
                           "quantized"),
    "quantized-tetra": ("tetra", _tet, torch.float32, _ext(0.3),
                        "quantized"),
    "simplex-tetra-float64": ("tetra", _tet, torch.float64,
                              _ext(0.3, 2048), "simplex"),
    "quad-float32": ("quad", _quad, torch.float32, _ext(0.5), "quad"),
    "quad-float64": ("quad", _quad, torch.float64, _ext(0.3, 4096),
                     "quad"),
    "qdf-tetra": ("tetra", _tet, torch.float32, HOST, "qdf"),
}
CASES = [(k, t) for k in KINDS for t in ("main", "ext")
         if not (KINDS[k][4] == "qdf" and t == "ext")]


def _linear(p, v):
    """Point-data variable v, linear in the coordinates."""
    a = (1.0 + 2.0 * p[:, 0] - 3.0 * p[:, 1] + 0.5 * p[:, 2],
         2.0 + 0.25 * p[:, 0] - p[:, 2] + 0.75 * p[:, 1])
    return a[v]


def _build(kind):
    cell_type, mesh, dtype, cfg, row_kind = KINDS[kind]
    pts, cells, nbrs = mesh()
    g = tiu.build_grid(pts, cells, nbrs, cell_type,
                       point_data={"a": _linear(pts, 0),
                                   "b": _linear(pts, 1)},
                       dtype=dtype, config=cfg, locate_mode="walk",
                       device="cpu")
    if row_kind == "qdf":
        g = tiu.prepare_accurate(g)
        assert g.cand_df_table is not None
    return np.asarray(pts, np.float64), g


def _overflow_bins(g):
    """The overflow bins in extension-slot order."""
    over = torch.nonzero(g.cand_ext_slot >= 0).squeeze(1)
    return over[torch.argsort(g.cand_ext_slot[over])]


def _role(rows, lay, j):
    """(n, K) columns of role j."""
    return rows[:, j * lay.k:(j + 1) * lay.k]


def _centroids(g, pts, ids):
    """(n, K, 3) float64 centroids of the candidates ``ids``."""
    return pts[g.cells[ids.clamp_min(0).long()].numpy()].mean(axis=2)


def _centroid_values(g, pts, cols, rows, lay, ids, bins):
    """(n, K) values of the fused variable ``lay.var_roles[0]`` at each
    candidate's centroid, from the row's own columns."""
    row_kind = cols.kind
    cent = torch.from_numpy(_centroids(g, pts, ids))
    vr = lay.var_roles[0]
    col = [_role(rows, lay, vr + j).double() for j in range(cols.var_step)]
    if row_kind in ("quantized", "qdf"):
        local = cent - cand_table.bin_centers(g, bins).double()[:, None, :]
        if row_kind == "quantized":
            gx, c = col[:3], col[3]
        else:  # (ghx ghy ghz glx gly glz c_hi c_lo)
            gx = [col[d] + col[3 + d] for d in range(3)]
            c = col[6] + col[7]
        return sum(gx[d] * local[..., d] for d in range(3)) + c
    # simplex: vertex data premultiplied by the inverse height, weighted
    # by the margin of the face opposite each vertex (face v + 1)
    nf = lay.nf
    n = [torch.stack([_role(rows, lay, d * nf + f).double()
                      for d in range(3)], dim=-1) for f in range(nf)]
    off = [_role(rows, lay, 3 * nf + f).double() for f in range(nf)]
    val = 0.0
    for v in range(nf):
        f = (v + 1) % nf
        margin = off[f] - (n[f] * cent).sum(-1)
        val = val + col[v] * margin
    return val


@pytest.mark.parametrize("kind,table", CASES)
def test_rows_read_back_through_the_layout(kind, table):
    pts, g = _build(kind)
    row_kind = KINDS[kind][4]
    nv = cand_table.fused_nv(g)
    assert nv == g.cand_nv >= 1
    slot = nv - 1
    n_bins = g.cand_ids.shape[0]
    if row_kind == "qdf":
        rows, lay = g.cand_df_table, cand_table.df_layout(g, (slot,))
        ids, bins = g.cand_ids, torch.arange(n_bins, dtype=torch.int32)
        count = g.cand_count
    elif table == "main":
        assert g.cand_ext_table is not None
        over = g.cand_ext_slot >= 0
        assert over.any() and not over.all()
        rows = g.cand_table
        lay = cand_table.layout(g, g.cand_ids.shape[1], (slot,))
        ids, bins = g.cand_ids, torch.arange(n_bins, dtype=torch.int32)
        k = g.cand_ids.shape[1]
        # a count past K sends the probe to the bin's extension row
        count = torch.where(over, k + 1 + g.cand_ext_slot, g.cand_count)
        assert (g.cand_count[~over] <= k).all()
    else:
        bins = _overflow_bins(g)
        rows = g.cand_ext_table
        lay = cand_table.layout(g, g.cand_ext_ids.shape[1], (slot,))
        ids, count = g.cand_ext_ids, g.cand_count[bins]
    assert lay.kind == row_kind
    assert rows.shape[0] == ids.shape[0]
    assert rows.shape[1] * rows.element_size() % 512 == 0
    cols = (cand_table.qdf(g.cell_type, nv) if row_kind == "qdf"
            else cand_table.columns(g.cell_type, g.dtype, g.config, nv))
    assert rows.shape[1] == cols.width(lay.k, rows.element_size())
    assert lay.count_col + cols.trailing <= rows.shape[1]

    # cell ids at id_role, -1 in the padding slots
    torch.testing.assert_close(_role(rows, lay, lay.id_role),
                               ids.to(rows.dtype), rtol=0, atol=0)
    # the encoded counts at count_col
    torch.testing.assert_close(rows[:, lay.count_col],
                               count.to(rows.dtype), rtol=0, atol=0)
    # one fused variable at var_roles
    valid = ids >= 0
    if row_kind == "quad":  # the raw vertex data
        cells = g.cells[ids.clamp_min(0).long()].long()  # (n, K, npc)
        want = g.point_data[:, slot][cells]
        for v in range(lay.nf):
            got = _role(rows, lay, lay.var_roles[0] + v)
            assert torch.equal(got[valid], want[..., v][valid])
        return
    got = _centroid_values(g, pts, cols, rows, lay, ids, bins)
    cent = _centroids(g, pts, ids)
    want = torch.from_numpy(_linear(cent.reshape(-1, 3), slot)
                            .reshape(cent.shape[:2]))
    tol = {"quantized": 1e-4, "qdf": 1e-9, "simplex": 1e-10}[row_kind]
    torch.testing.assert_close(got[valid], want[valid], rtol=tol, atol=tol)


@pytest.mark.parametrize("pin", ["pinned", "pre-v4"])
@pytest.mark.parametrize("k", ["capacity", "cover-widened"])
def test_load_keeps_the_lists(tmp_path, monkeypatch, k, pin):
    """A checkpoint whose K is this config's capacity K or its
    cover-widened K loads without a rebuild, with its ``cand_nv`` pin or
    without one (re-derived to the same count), and packs the same
    rows."""
    cfg = HOST if k == "cover-widened" else dataclasses.replace(
        HOST, cand_cover_row_bytes=0)
    pts, cells, nbrs = _tet()
    g = tiu.build_grid(pts, cells, nbrs, "tetra",
                       point_data={"a": _linear(pts, 0),
                                   "b": _linear(pts, 1)},
                       config=cfg, dtype=torch.float32, locate_mode="walk",
                       device="cpu")
    size = cand_table.sizing(g)
    widened = g.cand_ids.shape[1] > size.k
    assert widened == (k == "cover-widened")
    assert g.cand_nv == size.nv == 2
    fn = tmp_path / "g.binda"
    tiu.save_grid(g if pin == "pinned" else dataclasses.replace(
        g, cand_nv=-1), fn)

    def no_rebuild(*a, **kw):
        raise AssertionError("the candidate lists were rebuilt")

    monkeypatch.setattr(cand_table, "build_candidate_bins_dispatch",
                        no_rebuild)
    lg = tiu.load_grid(fn, config=cfg, device="cpu")
    assert lg.cand_nv == g.cand_nv
    assert lg.cand_ids.shape == g.cand_ids.shape
    for f in ("cand_ids", "cand_count", "cand_ext_slot"):
        assert torch.equal(getattr(lg, f), getattr(g, f)), f
    assert torch.equal(lg.cand_table.view(torch.int32),
                       g.cand_table.view(torch.int32))
    assert lg.cand_qeps == g.cand_qeps
