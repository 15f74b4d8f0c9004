"""The port's ``build_grid`` against the JAX package's, table by table.

Both packages build the same meshes with the host candidate builder
(``cand_build="host"``) in float32.  Geometry leaves, candidate lists
and the bookkeeping columns of the packed rows must be identical; the
quantized int16 words may differ by one unit in a few slots (float32
sums taken in another order can move a value across a rounding
boundary); the f32 face planes agree to rtol 1e-6.  XLA on the CPU
contracts the JAX packer's float32 products and sums into FMAs, torch
rounds each operation, so:

* the value planes and the premultiplied vertex data agree to 1e-6
  relative to the magnitude of each variable's columns (an entry that
  should be 0 carries a few ulp of noise on either side);
* dscale = max |off - n . c| / 32767, where the difference cancels about
  one digit, agrees to rtol 2e-6 (1.2e-6 seen on the 8^3 tet box);
* cand_qeps, derived from the table-wide largest dscale, agrees to
  rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

# The whole file compares with the JAX package: it skips where jax is
# absent, as on a machine that runs only the CUDA tests.
jnp = pytest.importorskip("jax.numpy")

import interpolate_unstructured_tpu as jiu  # noqa: E402
import interpolate_unstructured_tpu_torch as tiu  # noqa: E402
from interpolate_unstructured_tpu.utils import meshgen  # noqa: E402

HOST = jiu.IUConfig(cand_build="host")
EXT = dataclasses.replace(
    HOST, cand_bins_per_cell=0.3, cand_ext_max_k=256, cand_cover_row_bytes=0
)
CASES = {
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(20, 20), HOST),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(20, 20), HOST),
    "tetra": ("tetra", lambda: meshgen.tet_box_mesh(8, 8, 8), HOST),
    "tetra-unquantized": (
        "tetra", lambda: meshgen.tet_box_mesh(8, 8, 8),
        dataclasses.replace(HOST, cand_quantized=False),
    ),
    "tetra-extension": ("tetra", lambda: meshgen.tet_box_mesh(12, 12, 12), EXT),
}


def _point_data(pts):
    return {"Polynomial": pts.sum(1) + 1.0, "XY": pts[:, 0] * pts[:, 1]}


def _build_both(case):
    cell_type, mesh, cfg = CASES[case]
    pts, cells, nbrs = mesh()
    ug = jiu.build_grid(
        pts, cells, nbrs, cell_type, point_data=_point_data(pts),
        dtype=jnp.float32, config=cfg, locate_mode="walk",
    )
    tg = tiu.build_grid(
        pts, cells, nbrs, cell_type, point_data=_point_data(pts),
        dtype=torch.float32, config=tiu.IUConfig(**dataclasses.asdict(cfg)),
        locate_mode="walk", device="cpu",
    )
    return ug, tg


def _int16_halves(words):
    w = words.astype(np.int32)
    return np.stack([(w << 16) >> 16, w >> 16])


def _close_to_scale(actual, desired, rtol=1e-6):
    """|actual - desired| <= rtol * max|desired| over the block."""
    scale = np.abs(desired).max(initial=0.0)
    np.testing.assert_array_less(
        np.abs(actual.astype(np.float64) - desired), rtol * scale + 1e-30
    )


def _compare_rows(jt, tt, ug, k, quantized, nv):
    """Compare two packed tables of K candidates, column class by class."""
    nf = npc = ug.n_faces_per_cell
    assert tt.shape[1] == jt.shape[1]  # physical row width
    jt = jt[: tt.shape[0]]  # the JAX table keeps padded tail rows
    assert jt.shape == tt.shape
    if quantized:
        s_qn, s_qd = -(-3 * nf // 2), -(-nf // 2)
        head = (s_qn + s_qd) * k
        ji = jt.view(np.int32)[:, :head]
        ti = tt.view(np.int32)[:, :head]
        diff = np.abs(_int16_halves(ji) - _int16_halves(ti))
        assert diff.max() <= 1
        assert np.count_nonzero(diff) <= 1e-3 * diff.size
        for v in range(nv):  # value plane (gx gy gz c) of variable v
            cols = slice(head + 4 * v * k, head + 4 * (v + 1) * k)
            _close_to_scale(tt[:, cols], jt[:, cols])
        id_role = s_qn + s_qd + 4 * nv
        ccol = k * (id_role + 1)
        np.testing.assert_allclose(
            tt[:, ccol + 1], jt[:, ccol + 1], rtol=2e-6
        )  # dscale
        tail = ccol + 2
    else:
        id_role = 4 * nf + (3 * npc if ug.cell_type == "quad" else 0)
        planes = slice(0, id_role * k)
        np.testing.assert_allclose(tt[:, planes], jt[:, planes], rtol=1e-6)
        for v in range(nv):  # vertex data of variable v
            cols = slice((id_role + 1 + npc * v) * k,
                         (id_role + 1 + npc * (v + 1)) * k)
            _close_to_scale(tt[:, cols], jt[:, cols])
        ccol = k * (id_role + 1 + npc * nv)
        tail = ccol + 1
    ids = slice(id_role * k, (id_role + 1) * k)
    np.testing.assert_array_equal(tt[:, ids], jt[:, ids])
    np.testing.assert_array_equal(tt[:, ccol], jt[:, ccol])
    np.testing.assert_array_equal(tt[:, tail:], jt[:, tail:])  # padding


@pytest.mark.parametrize("case", list(CASES))
def test_candidate_tables_match_jax(case):
    from interpolate_unstructured_tpu.models.grid import (
        cand_fused_nv,
        cand_is_quantized,
    )

    ug, tg = _build_both(case)
    for f in ("cand_ids", "cand_count", "cand_ext_slot", "cand_rmin",
              "cand_inv_h"):
        np.testing.assert_array_equal(
            getattr(tg, f).numpy(), np.asarray(getattr(ug, f)), err_msg=f
        )
    assert tg.cand_shape == ug.cand_shape
    assert tg.cand_nv == ug.cand_nv == cand_fused_nv(ug) >= 1
    assert tg.cand_ext_covers == ug.cand_ext_covers
    quantized = cand_is_quantized(ug.cell_type, ug.dtype, ug.config)
    k = ug.cand_ids.shape[1]
    _compare_rows(np.asarray(ug.cand_table), tg.cand_table.numpy(), ug, k,
                  quantized, ug.cand_nv)
    if ug.cand_ext_ids is None:
        assert tg.cand_ext_ids is None and tg.cand_ext_table is None
    else:
        np.testing.assert_array_equal(
            tg.cand_ext_ids.numpy(), np.asarray(ug.cand_ext_ids)
        )
        _compare_rows(np.asarray(ug.cand_ext_table),
                      tg.cand_ext_table.numpy(), ug,
                      ug.cand_ext_ids.shape[1], quantized, ug.cand_nv)
    if quantized:
        np.testing.assert_allclose(tg.cand_qeps, ug.cand_qeps, rtol=1e-6)
    else:
        assert tg.cand_qeps == ug.cand_qeps == 0.0
    if case == "tetra-extension":
        assert tg.cand_ext_table is not None and tg.cand_ext_covers


SEED_FIELDS = ("bin_table", "bin_pack", "bin_rmin", "bin_inv_h",
               "walk_table")


@pytest.mark.parametrize("case", ["triangle", "quad", "tetra"])
def test_geometry_leaves_match_jax(case):
    ug, tg = _build_both(case)
    for f in ("points", "cells", "neighbors", "cell_points", "face_normals",
              "face_offsets", "cell_volume", "point_is_at_boundary",
              "point_data", "rmin", "rmax") + SEED_FIELDS:
        np.testing.assert_array_equal(
            getattr(tg, f).numpy(), np.asarray(getattr(ug, f)), err_msg=f
        )
    assert tg.bin_shape == ug.bin_shape
    assert tg.config.eps_inside == ug.config.eps_inside
    assert tg.point_data_names == ug.point_data_names
    assert tg.locate_mode == ug.locate_mode == "walk"


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("case", ["triangle", "quad", "tetra"])
def test_seed_and_walk_tables_match_jax(case, refine):
    """Walk grids without candidate tables: the fine bin seed table, its
    packed rows and the walk rows are bit-identical before the refine;
    after it (every bin center located by a walk) the seeds agree except
    for bins whose center lies on a face shared by both chosen cells."""
    cell_type, mesh, _ = CASES[case]
    cfg = dataclasses.replace(HOST, use_candidate_bins=False,
                              refine_bin_seeds=refine)
    pts, cells, nbrs = mesh()
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, dtype=jnp.float32,
                        config=cfg, locate_mode="walk")
    tg = tiu.build_grid(pts, cells, nbrs, cell_type, dtype=torch.float32,
                        config=tiu.IUConfig(**dataclasses.asdict(cfg)),
                        locate_mode="walk", device="cpu")
    assert tg.cand_table is None and tg.bin_shape == ug.bin_shape
    assert np.prod(tg.bin_shape) >= 3 * tg.n_cells  # the fine table
    for f in ("bin_rmin", "bin_inv_h", "walk_table"):
        np.testing.assert_array_equal(
            getattr(tg, f).numpy(), np.asarray(getattr(ug, f)), err_msg=f
        )
    jt, tt = np.asarray(ug.bin_table), tg.bin_table.numpy()
    differ = np.flatnonzero(jt != tt)
    if not refine:
        assert len(differ) == 0
    else:
        assert len(differ) <= 1e-3 * len(tt)
        # bin centers as the refine computes them
        nbx, nby, nbz = tg.bin_shape
        inv_h = tg.bin_inv_h.numpy()
        h = np.divide(1.0, inv_h, out=np.zeros(3), where=inv_h > 0)
        rmin = tg.bin_rmin.numpy()
        ijk = np.stack(np.unravel_index(differ, (nbx, nby, nbz)), axis=1)
        bc = rmin + (ijk + 0.5) * h
        if h[2] == 0:
            bc[:, 2] = 0.0
        bc = torch.from_numpy(bc.astype(np.float32))
        for ids in (jt[differ], tt[differ]):
            assert bool(tiu.point_is_inside_cell(
                tg, bc, torch.from_numpy(ids)).all())
    # packed rows: [seed id | seed cell center], the center rows equal
    # wherever the seeds are
    jp, tp = np.asarray(ug.bin_pack), tg.bin_pack.numpy()
    np.testing.assert_array_equal(tp[:, 0], tt.astype(np.float32))
    same = jt == tt
    np.testing.assert_array_equal(tp[same], jp[same])


def test_build_timings_and_auto_mode():
    pts, cells, nbrs = meshgen.tet_box_mesh(5, 5, 5)
    timings = {}
    g = tiu.build_grid(pts, cells, nbrs, "tetra",
                       point_data={"P": pts.sum(1)}, dtype=torch.float32,
                       timings=timings, device="cpu")
    assert g.locate_mode == "bruteforce" and g.cand_table is None
    assert {"host_geometry_s", "seed_table_s", "transfer_s"} <= set(timings)
    g = tiu.build_grid(pts, cells, nbrs, "tetra", locate_mode="walk",
                       point_data={"P": pts.sum(1)}, dtype=torch.float32,
                       timings=timings, device="cpu")
    assert {"cand_build_s", "cand_pack_s"} <= set(timings)
    assert "refine_s" not in timings  # candidate tables: no refine
    g = tiu.build_grid(pts, cells, nbrs, "tetra", locate_mode="walk",
                       point_data={"P": pts.sum(1)}, dtype=torch.float32,
                       timings=timings, device="cpu",
                       config=tiu.IUConfig(use_candidate_bins=False))
    assert "refine_s" in timings and g.cand_table is None
    assert tiu.get_point_data_index(g, "P") == 0
    assert tiu.get_point_data_index(g, "Q") == -1
    # cand_build="device" on the CPU: the device builder's plain
    # versions, the same counts and the same cells in every bin
    gd = tiu.build_grid(pts, cells, nbrs, "tetra", locate_mode="walk",
                        point_data={"P": pts.sum(1)}, dtype=torch.float32,
                        config=tiu.IUConfig(cand_build="device"),
                        device="cpu")
    gh = tiu.build_grid(pts, cells, nbrs, "tetra", locate_mode="walk",
                        point_data={"P": pts.sum(1)}, dtype=torch.float32,
                        config=tiu.IUConfig(cand_build="host"), device="cpu")
    assert gd.cand_table is not None and gd.cand_shape == gh.cand_shape
    assert torch.equal(gd.cand_count, gh.cand_count)
    assert torch.equal(gd.cand_ids.sort(1).values, gh.cand_ids.sort(1).values)
