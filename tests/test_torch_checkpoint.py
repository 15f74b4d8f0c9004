"""Grid checkpoints: the port's ``save_grid`` / ``load_grid`` against the
JAX package's, in both directions and within the port.

Three round trips — JAX save -> port load, port save -> JAX load, and
port -> port — over float32 and float64 grids, triangles, quads and
tetrahedra, kd-tree seeds, brute-force grids, candidate tables with
extension rows, and a variable added with ``fuse=False`` (the
``cand_nv`` pin).  Every leaf stored in the container (and the leaves
derived from them on load: ``cell_points``, the ``cand_ids`` rectangle
and the walk rows) equals the saved grid's bit for bit.  The packed
candidate rows are the loading package's own packing of those leaves:
bit-identical within a package; across packages the int16 words and
value planes differ by the FMA contractions that ``tests/
test_torch_build.py`` describes, so there the queries are compared
instead, within the tolerances of ``tests/test_torch_slice.py``
(float32: found masks and cell ids identical, values within 2e-6;
float64: values within 1e-13).  Queries on a grid the port loaded are
``torch.equal`` to the port's queries on the original.  A grid carried
over from the JAX package with ``grid_from_numpy`` and saved by both
packages gives byte-identical files.

The file imports jax only inside the tests that compare with the JAX
package, so that the card, which has no jax, collects its ``cuda`` test
with ``--noconftest``.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.io import checkpoint as tck
from interpolate_unstructured_tpu_torch.models import cand_table
from interpolate_unstructured_tpu_torch.models import grid as tgrid
from interpolate_unstructured_tpu_torch.utils import meshgen

HOST = tiu.IUConfig(cand_build="host")
EXT = dataclasses.replace(
    HOST, cand_bins_per_cell=0.3, cand_ext_max_k=256, cand_cover_row_bytes=0
)
KD = dataclasses.replace(HOST, seed_mode="kdtree")

# name: (cell type, mesh, config, float64?, locate mode, unfused variable?)
KINDS = {
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(16, 16),
                 HOST, False, "walk", False),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(16, 16), HOST, False,
             "walk", False),
    "tetra-extension": ("tetra", lambda: meshgen.tet_box_mesh(10, 10, 10),
                        EXT, False, "walk", False),
    "tetra-float64": ("tetra", lambda: meshgen.tet_box_mesh(6, 6, 6), HOST,
                      True, "walk", False),
    "triangle-float64": ("triangle", lambda: meshgen.triangle_rect_mesh(
        12, 12), HOST, True, "walk", False),
    "tetra-kdtree": ("tetra", lambda: meshgen.tet_box_mesh(6, 6, 6), KD,
                     False, "walk", False),
    "tetra-bruteforce": ("tetra", lambda: meshgen.tet_box_mesh(4, 4, 4),
                         HOST, False, "auto", False),
    "tetra-unfused": ("tetra", lambda: meshgen.tet_box_mesh(6, 6, 6), HOST,
                      False, "walk", True),
}
# every leaf stored in the container, and those derived from them on load
STORED = tck._ARRAY_FIELDS + tck._OPTIONAL_FIELDS
DERIVED = ["cell_points", "cand_ids", "walk_table"]
META = ("cell_type", "bin_shape", "cand_shape", "cand_ext_covers", "cand_nv",
        "kd_max_depth", "point_data_names", "cell_data_names",
        "icell_data_names", "locate_mode")


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


def _data(pts, cells):
    return (
        {"Polynomial": pts.sum(1) + 1.0, "XY": pts[:, 0] * pts[:, 1]},
        {"c": np.arange(len(cells)) * 0.25},
        {"id": np.arange(len(cells), dtype=np.int32) % 5},
    )


def _unfused(pts):
    return np.sin(pts[:, 0]) + pts[:, 1]


def _build_port(kind, device="cpu"):
    cell_type, mesh, cfg, f64, mode, unfused = KINDS[kind]
    pts, cells, nbrs = mesh()
    pd, cd, icd = _data(pts, cells)
    g = tiu.build_grid(pts, cells, nbrs, cell_type, point_data=pd,
                       cell_data=cd, icell_data=icd, config=cfg,
                       dtype=torch.float64 if f64 else torch.float32,
                       locate_mode=mode, device=device)
    if unfused:
        g, _ = tiu.add_point_data(g, "late", _unfused(pts), fuse=False)
        assert 0 <= g.cand_nv < g.n_point_data
    return pts, g


def _build_jax(kind):
    jnp, jiu = _jax()
    cell_type, mesh, cfg, f64, mode, unfused = KINDS[kind]
    pts, cells, nbrs = mesh()
    pd, cd, icd = _data(pts, cells)
    ug = jiu.build_grid(pts, cells, nbrs, cell_type, point_data=pd,
                        cell_data=cd, icell_data=icd,
                        config=jiu.IUConfig(**dataclasses.asdict(cfg)),
                        dtype=jnp.float64 if f64 else jnp.float32,
                        locate_mode=mode)
    if unfused:
        ug, _ = jiu.add_point_data(ug, "late", _unfused(pts), fuse=False)
    return pts, ug


def _carry(ug):
    """A JAX grid's state carried into the port, bits unchanged."""
    leaves = {
        f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
        for f in tgrid.DATA_FIELDS
    }
    return tiu.grid_from_numpy(
        leaves, {f: getattr(ug, f) for f in tgrid.META_FIELDS}, "cpu"
    )


def _host(a):
    if a is None:
        return None
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else (
        np.asarray(a))


def _assert_leaves_equal(saved, loaded, fields=STORED + DERIVED):
    """Bit-for-bit equality of the named leaves (either package)."""
    for f in fields:
        a, b = _host(getattr(saved, f)), _host(getattr(loaded, f))
        assert (a is None) == (b is None), f
        if a is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=f)
    for f in META:
        assert getattr(saved, f) == getattr(loaded, f), f
    assert saved.config.eps_inside == loaded.config.eps_inside


def _bits(t):
    """A tensor's bits: the quantized candidate rows hold int16 pairs in
    float32 words, some of them NaN patterns, which torch.equal of the
    floats would call unequal to themselves."""
    if t.dtype.is_floating_point:
        return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _assert_torch_equal(a, b, config=True):
    """Every tensor leaf (bit for bit) and metadata field of two port
    grids equal; ``config=False`` leaves out the session's config."""
    for f in tgrid.DATA_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert torch.equal(_bits(x), _bits(y.to(x.device))), f
    for f in tgrid.META_FIELDS:
        if f != "config" or config:
            assert getattr(a, f) == getattr(b, f), f


def _queries(pts, n=3000, seed=3):
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(0), pts.max(0)
    span = hi - lo
    r = lo - 0.1 * span + rng.random((n, 3)) * 1.2 * span
    if span[2] == 0:
        r[:, 2] = 0.0
    return r


def _port_query(g, r):
    r = torch.from_numpy(r.astype(np.float64 if g.dtype == torch.float64
                                  else np.float32)).to(g.device)
    return tiu.interpolate_at(g, r, list(range(g.n_point_data)),
                              fill_value=-7.0)


def _jax_query(ug, r, f64):
    jnp, jiu = _jax()
    r = jnp.asarray(r, jnp.float64 if f64 else jnp.float32)
    return jiu.interpolate_at(ug, r, list(range(ug.n_point_data)),
                              fill_value=-7.0)


def _assert_close_to_jax(port, jax_out, f64):
    tv, tic, tf = (x.cpu().numpy() for x in port)
    jv, jic, jf = (np.asarray(x) for x in jax_out)
    assert 0 < jf.sum() < len(jf)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tic, jic)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-13 if f64 else 2e-6)


def _assert_same_query(a, b):
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))


# ---------------------------------------------------------------------------
# Round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_save_port_load(tmp_path, kind):
    _, jiu = _jax()
    pts, ug = _build_jax(kind)
    fn = tmp_path / "g.binda"
    jiu.save_grid(ug, fn)
    tim = {}
    tg = tiu.load_grid(fn, config=KINDS[kind][2], device="cpu", timings=tim)
    assert set(tim) == {"read_s", "rebuild_s", "tables_s"}
    _assert_leaves_equal(ug, tg)
    # the packed rows are the port's own packing of the same leaves
    carried = _carry(ug)
    if carried.cand_ids is not None:
        carried = dataclasses.replace(
            carried, **cand_table.pack(carried, nv=carried.cand_nv))
    _assert_torch_equal(carried, tg)
    r = _queries(pts)
    out = _port_query(tg, r)
    _assert_same_query(out, _port_query(carried, r))
    if kind != "tetra-kdtree":
        _assert_close_to_jax(out, _jax_query(ug, r, KINDS[kind][3]),
                             KINDS[kind][3])


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_save_jax_load(tmp_path, kind):
    _, jiu = _jax()
    cfg = KINDS[kind][2]
    pts, tg = _build_port(kind)
    fn = tmp_path / "g.binda"
    tiu.save_grid(tg, fn)
    ug = jiu.load_grid(fn, config=jiu.IUConfig(**dataclasses.asdict(cfg)))
    _assert_leaves_equal(tg, ug)
    if kind != "tetra-kdtree":
        r = _queries(pts)
        _assert_close_to_jax(_port_query(tg, r),
                             _jax_query(ug, r, KINDS[kind][3]),
                             KINDS[kind][3])


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_save_port_load(tmp_path, kind, monkeypatch):
    """Nothing is rebuilt: the candidate builder is not called, and
    every leaf and query result is torch.equal to the original's."""
    pts, tg = _build_port(kind)
    fn = tmp_path / "g.binda"
    tiu.save_grid(tg, fn)

    def no_rebuild(*a, **k):
        raise AssertionError("the candidate lists were rebuilt")

    monkeypatch.setattr(cand_table, "build_candidate_bins_dispatch", no_rebuild)
    lg = tiu.load_grid(fn, config=KINDS[kind][2], device="cpu")
    _assert_torch_equal(tg, lg)
    r = _queries(pts)
    _assert_same_query(_port_query(tg, r), _port_query(lg, r))
    # the unfused variable interpolates through the generic path alike
    if KINDS[kind][5]:
        i = tg.n_point_data - 1
        rr = torch.from_numpy(r.astype(np.float32))
        _assert_same_query(tiu.interpolate_scalar_at(tg, rr, i),
                           tiu.interpolate_scalar_at(lg, rr, i))


@pytest.mark.parametrize("kind", ["triangle", "tetra-extension",
                                  "tetra-float64", "tetra-kdtree",
                                  "tetra-unfused"])
def test_save_grid_bytes_match_jax(tmp_path, kind):
    """A JAX grid carried over with grid_from_numpy and saved by both
    packages: the same bytes."""
    _, jiu = _jax()
    _, ug = _build_jax(kind)
    jiu.save_grid(ug, tmp_path / "jax.binda")
    tiu.save_grid(_carry(ug), tmp_path / "port.binda")
    assert filecmp.cmp(tmp_path / "jax.binda", tmp_path / "port.binda",
                       shallow=False)


def test_accurate_residuals_round_trip(tmp_path):
    """A float32 grid keeps its float64 residuals across the round trip
    (JAX -> port and port -> port); prepare_accurate on the loaded grid
    answers cold and warm accurate queries exactly as on the original."""
    jnp, jiu = _jax()
    pts, cells, nbrs = meshgen.tet_box_mesh(6, 6, 6)
    rng = np.random.default_rng(9)
    data = {"f": np.sin(3.0 * pts[:, 0]) + pts[:, 1] ** 2
            + rng.random(len(pts)) * 1e-3}
    kw = dict(point_data=data, locate_mode="walk", coord_scale_factor=np.pi)
    ug = jiu.build_grid(pts, cells, nbrs, "tetra", dtype=jnp.float32,
                        config=jiu.IUConfig(**dataclasses.asdict(HOST)), **kw)
    tg = tiu.build_grid(pts, cells, nbrs, "tetra", dtype=torch.float32,
                        config=HOST, device="cpu", **kw)
    jiu.save_grid(ug, tmp_path / "jax.binda")
    tiu.save_grid(tg, tmp_path / "port.binda")
    from_jax = tiu.load_grid(tmp_path / "jax.binda", config=HOST,
                             device="cpu")
    from_port = tiu.load_grid(tmp_path / "port.binda", config=HOST,
                              device="cpu")
    for f in ("points_lo", "point_data_lo"):
        np.testing.assert_array_equal(getattr(from_jax, f).numpy(),
                                      np.asarray(getattr(ug, f)), err_msg=f)
        assert np.abs(getattr(from_jax, f).numpy()).max() > 0
    # the session's eps_inside comes from the stored float32 bounds, in
    # both packages, so it may differ from the build's in its last bits
    jl = jiu.load_grid(tmp_path / "port.binda",
                       config=jiu.IUConfig(**dataclasses.asdict(HOST)))
    assert from_port.config.eps_inside == jl.config.eps_inside
    assert from_port.config == dataclasses.replace(
        tg.config, eps_inside=from_port.config.eps_inside)
    _assert_torch_equal(tg, from_port, config=False)
    r = _queries(pts * np.pi, 2000)
    a, b = tiu.prepare_accurate(tg), tiu.prepare_accurate(from_port)
    _assert_torch_equal(a, b, config=False)
    cold_a = tiu.interpolate_at_acc(a, torch.from_numpy(r), [0])
    cold_b = tiu.interpolate_at_acc(b, torch.from_numpy(r), [0])
    _assert_same_query(cold_a, cold_b)
    warm = [tiu.interpolate_at_acc(g, torch.from_numpy(r), [0],
                                   guess=cold_a[3]) for g in (a, b)]
    _assert_same_query(*warm)


# ---------------------------------------------------------------------------
# Rebuilds on a config or dtype change
# ---------------------------------------------------------------------------

REBUILD = dataclasses.replace(HOST, cand_bins_per_cell=0.8,
                              cand_row_bytes=3072)
CAND = ("cand_ids", "cand_count", "cand_ext_ids", "cand_ext_slot",
        "cand_rmin", "cand_inv_h")


def _assert_rebuilt_like_jax(lg, ug, r):
    """A rebuilt port grid against the JAX package's load of the same
    file: every stored and derived leaf and the new candidate lists bit
    for bit, and queries within the slice tolerances."""
    _assert_leaves_equal(ug, lg, fields=STORED + DERIVED + list(CAND))
    assert lg.cand_ext_covers == ug.cand_ext_covers
    f64 = lg.dtype == torch.float64
    _assert_close_to_jax(_port_query(lg, r), _jax_query(ug, r, f64), f64)


@pytest.mark.parametrize("resave", [False, True])
def test_config_change_rebuilds_like_jax(tmp_path, resave):
    """A session whose candidate config differs (bin shape and K) rebuilds
    the lists on load from the stored geometry, as the JAX package does;
    the pin is cleared and re-derived.  resave_on_rebuild writes the same
    bytes as the JAX package's resave, and a later load needs no
    rebuild."""
    _, jiu = _jax()
    pts, tg = _build_port("tetra-extension")
    fn = {p: tmp_path / f"{p}.binda" for p in ("jax", "port")}
    for p in fn:
        tiu.save_grid(tg, fn[p])
    before = fn["port"].read_bytes()
    cfg = dataclasses.replace(REBUILD, cand_ext_max_k=256,
                              cand_cover_row_bytes=0)
    tim = {}
    lg = tiu.load_grid(fn["port"], config=cfg, device="cpu", timings=tim,
                       resave_on_rebuild=resave)
    ug = jiu.load_grid(fn["jax"], config=jiu.IUConfig(
        **dataclasses.asdict(cfg)), resave_on_rebuild=resave)
    assert lg.cand_shape != tg.cand_shape
    assert lg.cand_ids.shape[1] != tg.cand_ids.shape[1]
    _assert_rebuilt_like_jax(lg, ug, _queries(pts))
    # the rows are the port's packing of the rebuilt lists
    _assert_torch_equal(
        lg, dataclasses.replace(lg, **cand_table.pack(lg)))
    if resave:
        assert fn["port"].read_bytes() != before
        assert filecmp.cmp(fn["jax"], fn["port"], shallow=False)
        again = tiu.load_grid(fn["port"], config=cfg, device="cpu")
        _assert_torch_equal(lg, again)
    else:
        assert fn["port"].read_bytes() == before


def test_float64_load_and_downcast(tmp_path):
    """A float64 checkpoint loads as a float64 grid; dtype=float32
    downcasts and rebuilds the candidate lists as the JAX package does,
    and never resaves across the dtype change."""
    jnp, jiu = _jax()
    pts, g64 = _build_port("tetra-float64")
    fn = tmp_path / "g64.binda"
    tiu.save_grid(g64, fn)
    before = fn.read_bytes()
    lg = tiu.load_grid(fn, config=HOST, device="cpu")
    assert lg.dtype == torch.float64
    _assert_torch_equal(g64, lg)
    g32 = tiu.load_grid(fn, config=HOST, dtype=torch.float32, device="cpu",
                        resave_on_rebuild=True)
    assert fn.read_bytes() == before
    assert g32.dtype == torch.float32 and g32.cells.dtype == torch.int32
    ug = jiu.load_grid(fn, config=jiu.IUConfig(**dataclasses.asdict(HOST)),
                       dtype=jnp.float32)
    _assert_rebuilt_like_jax(g32, ug, _queries(pts))
    with pytest.raises(ValueError, match="float32 or float64"):
        tiu.load_grid(fn, dtype=torch.float16, device="cpu")


def test_device_builder_rebuild_raises(tmp_path):
    """A load whose rebuild takes the device candidate builder
    (``cand_build="device"``) rebuilds as the JAX package's load of the
    same file does: the same lists, leaves and queries.  On a strongly
    graded mesh, which the device builder declines, both loads raise the
    same ValueError; a load that rebuilds nothing does not need it."""
    _, jiu = _jax()
    pts, tg = _build_port("triangle")
    fn = tmp_path / "g.binda"
    tiu.save_grid(tg, fn)
    device_cfg = dataclasses.replace(REBUILD, cand_build="device")
    lg = tiu.load_grid(fn, config=device_cfg, device="cpu")
    ug = jiu.load_grid(fn, config=jiu.IUConfig(
        **dataclasses.asdict(device_cfg)))
    assert lg.cand_ids.shape[1] != tg.cand_ids.shape[1]
    ids = ("cand_ids", "cand_ext_ids")
    _assert_leaves_equal(ug, lg, fields=[
        f for f in STORED + DERIVED + list(CAND) if f not in ids])
    assert lg.cand_ext_covers == ug.cand_ext_covers
    # the id lists with the device builder's tolerance (tests/
    # test_torch_cand_build.py), from the stored float32 geometry the
    # rebuild ran on
    from test_torch_cand_build import _alike_bins, assert_lists_match

    up = {f: _host(getattr(tg, f)).astype(np.float64)
          for f in ("points", "face_normals", "face_offsets", "rmin", "rmax")}
    alike, n_differ = _alike_bins(
        (up["points"][_host(tg.cells)], up["face_normals"],
         up["face_offsets"], up["rmin"], up["rmax"], 2), torch.float32,
        device_cfg.cand_bins_per_cell, device_cfg.cand_max_bins,
        2.0 * lg.config.eps_inside)
    no_ext = np.zeros((0, 0), np.int32)
    assert assert_lists_match(
        _host(lg.cand_ids), _host(lg.cand_ext_ids) if lg.cand_ext_ids
        is not None else no_ext, _host(lg.cand_ext_slot), _host(ug.cand_ids),
        _host(ug.cand_ext_ids) if ug.cand_ext_ids is not None else no_ext,
        _host(ug.cand_ext_slot), ordered_bins=alike) <= n_differ
    _assert_close_to_jax(_port_query(lg, _queries(pts)),
                         _jax_query(ug, _queries(pts), False), False)
    lg = tiu.load_grid(fn, config=dataclasses.replace(
        HOST, cand_build="device"), device="cpu")
    _assert_torch_equal(tg, lg, config=False)
    assert lg.config == dataclasses.replace(tg.config, cand_build="device")

    # one cell spans the whole domain: past the device offset budget
    pts, cells, nbrs = meshgen.tet_box_mesh(4, 4, 4)
    pts = pts.copy()
    pts[0] = [50.0, 50.0, 50.0]
    graded = tiu.build_grid(pts, cells, nbrs, "tetra", config=HOST,
                            dtype=torch.float32, locate_mode="walk",
                            device="cpu")
    fn = tmp_path / "graded.binda"
    tiu.save_grid(graded, fn)
    # another K: a rebuild at the saved bin shape, ~9^3 bins for one cell
    graded_cfg = dataclasses.replace(HOST, cand_build="device",
                                     cand_row_bytes=3072)
    with pytest.raises(ValueError, match="offset budget") as e:
        tiu.load_grid(fn, config=graded_cfg, device="cpu")
    with pytest.raises(ValueError) as e_jax:
        jiu.load_grid(fn, config=jiu.IUConfig(
            **dataclasses.asdict(graded_cfg)))
    assert str(e.value) == str(e_jax.value)


def test_load_grid_device_default_and_bad_files(tmp_path):
    _, tg = _build_port("tetra-bruteforce")
    fn = tmp_path / "g.binda"
    tiu.save_grid(tg, fn)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tiu.load_grid(fn)
    from interpolate_unstructured_tpu_torch.io.binda import BindaWriter

    w = BindaWriter()
    w.add_entry("points", np.zeros((3, 3)))
    w.write_to_file(tmp_path / "mesh.binda")
    with pytest.raises(ValueError, match="not a saved UGrid"):
        tiu.load_grid(tmp_path / "mesh.binda", device="cpu")
    raw = fn.read_bytes().replace(b"5,tetra,", b"9,tetra,", 1)
    (tmp_path / "v9.binda").write_bytes(raw)
    with pytest.raises(ValueError, match="version 9"):
        tiu.load_grid(tmp_path / "v9.binda", device="cpu")


def test_expand_cand_rows():
    """The ragged rows re-expand to the rectangle, counts above K keep
    their first K ids, and an empty store gives rows of -1."""
    flat = torch.tensor([5, 6, 7, 8, 9, 10, 11], dtype=torch.int32)
    counts = torch.tensor([2, 0, 9, 1], dtype=torch.int32)
    out = tck._expand_cand_rows(flat, counts, 4)
    assert out.tolist() == [[5, 6, -1, -1], [-1] * 4, [7, 8, 9, 10],
                            [11, -1, -1, -1]]
    assert out.dtype == torch.int32
    empty = tck._expand_cand_rows(flat[:0], torch.zeros(3, dtype=torch.int32),
                                  2)
    assert empty.tolist() == [[-1, -1]] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tetra-extension", "tetra-bruteforce",
                                  "tetra-unfused"])
def test_cuda_round_trip(tmp_path, cuda, kind):
    """On the card: save, then load onto the card, leaf by leaf
    torch.equal, and the same query results through the kernels."""
    pts, g = _build_port(kind, device=cuda)
    fn = tmp_path / "g.binda"
    tiu.save_grid(g, fn)
    tim = {}
    lg = tiu.load_grid(fn, config=KINDS[kind][2], device=cuda, timings=tim)
    assert lg.device.type == "cuda" and tim["tables_s"] >= 0
    _assert_torch_equal(g, lg)
    r = _queries(pts, 20_000)
    _assert_same_query(_port_query(g, r), _port_query(lg, r))
    # and the file equals the one a host copy of the grid saves
    host = tiu.load_grid(fn, config=KINDS[kind][2], device="cpu")
    tiu.save_grid(host, tmp_path / "host.binda")
    assert filecmp.cmp(fn, tmp_path / "host.binda", shallow=False)
    assert os.path.getsize(fn) > 0
