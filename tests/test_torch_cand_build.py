"""The port's device candidate builder (``ops/cand_build.py``, kernels D1
and D2) against the JAX package's ``ops/cand_build.py``.

On the CPU the port runs the plain versions of D1 and D2
(``bin_pairs_plain``, ``fill_tables_plain``).  Both
packages take the same float64 host geometry and compute stage 1 in the
grid dtype.  XLA on the CPU contracts the JAX package's products and
sums into FMAs, torch rounds each operation (ROADMAP C5), so:

* stage 1's keys are identical, its scores agree within 4 ulp of the
  terms they are made of (|d| <= 4 * eps(float32) * |score| + 4 *
  eps(dtype) * the domain scale; 0.5 eps was seen);
* the builder's bin grid, counts and extension slots are identical, and
  each bin's ordered list is identical wherever the two packages'
  stage-1 scores of that bin agree bit for bit.  Elsewhere the lists
  hold the same cells, and a near tie may rank them otherwise: the
  winner among cells that tie on a shared face, and which cells an
  overflowing bin keeps, follow that order.

Grids built end to end with ``cand_build="device"`` are compared with
the tolerances of ``tests/test_torch_slice.py`` (float32 found masks and
cell ids identical, values within 2e-6).  The heavy-bin soups put
1,296 or 34,992 small tets inside one bin of a 6,000-tet box, so that
one bucket takes D2's block route or its rank route (past shared
memory).  The ``cuda`` cases hold D1's count and write passes and D2
``torch.equal`` to their plain versions on the card, the write pass's
records after canonical ordering inside each bucket.

The file imports jax only inside the tests that compare with the JAX
package, so that the card, which has no jax, collects its ``cuda`` test
with ``--noconftest``.
"""

import dataclasses
from itertools import product

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.models import cand_table
from interpolate_unstructured_tpu_torch.ops import (
    cand_build,
    cand_build_kernel,
    geometry,
)
from interpolate_unstructured_tpu_torch.utils import meshgen

# name: (cell type, ndim, mesh), the sizes of tests/test_cand_build.py
MESHES = {
    "triangle": ("triangle", 2, lambda: meshgen.triangle_rect_mesh(9, 7)),
    "quad": ("quad", 2, lambda: meshgen.quad_rect_mesh(9, 7)),
    "tetra": ("tetra", 3, lambda: meshgen.tet_box_mesh(6, 6, 6)),
}
DTYPES = {"float32": torch.float32, "float64": torch.float64}
KW = dict(bins_per_cell=2.0, max_bins=1 << 22, eps=2e-10, ext_max_k=32)
EPS32 = float(np.finfo(np.float32).eps)
DEVICE = tiu.IUConfig(cand_build="device")


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests: on
    some virtualized hosts the first float32 torch.sqrt a worker thread
    runs in a process is off by ~1e-4 relative (PERF.md §7), and the
    grids built end to end take square roots."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax():
    """The JAX package's builder module and jax.numpy."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from interpolate_unstructured_tpu.ops import cand_build as jcb

    return jnp, jcb


def _geometry(points, cells, neighbors, cell_type):
    cp = geometry.gather_cell_points(points, cells)
    normals, _ = geometry.face_normals_and_boundary(
        cp, cells, neighbors, cell_type, len(points)
    )
    offs = np.einsum("cki,cki->ck", cp, normals)
    return cp, normals, offs


def _args(mesh):
    cell_type, ndim, make = MESHES[mesh]
    pts, cells, nbrs = make()
    cp, normals, offs = _geometry(pts, cells, nbrs, cell_type)
    return (cp, normals, offs, pts.min(0), pts.max(0), ndim)


# The heavy-bin soups: k_max, ext_max_k, bins a cell, and the cover
# budget (the n = 6 soup's worst bin widens K, the n = 18 soup's does not)
SOUP_KW = dict(bins_per_cell=0.25, max_bins=1 << 22, eps=2e-10,
               ext_max_k=32)
SOUP_K = 10
SOUP_COVER = 4096


def _soup(n):
    """The cells of tet_box_mesh(10, 10, 10) on the unit box and of
    tet_box_mesh(n, n, n) scaled to side 0.01 and centred on the center
    of one bin of the soup's bin grid: the stage-1 inputs (cell points,
    normals, offsets, rmin, rmax, ndim)."""
    big = meshgen.tet_box_mesh(10, 10, 10)
    n_cells = len(big[1]) + 6 * n ** 3
    n_target = min(int(SOUP_KW["bins_per_cell"] * n_cells),
                   SOUP_KW["max_bins"])
    _, h, _, _ = geometry._bin_grid_shape(np.zeros(3), np.ones(3), 3,
                                          n_target)
    center = (np.floor(np.array([0.53, 0.47, 0.51]) / h) + 0.5) * h
    pts, cells, nbrs = meshgen.tet_box_mesh(n, n, n)
    small = (center - 0.005 + 0.01 * pts, cells, nbrs)
    parts = [_geometry(*m, "tetra") for m in (big, small)]
    cp, normals, offs = (np.concatenate(a) for a in zip(*parts))
    return (cp, normals, offs, np.zeros(3), np.ones(3), 3)


def _bucket_keys(counts):
    """Each record's bin, records bucket by bucket."""
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device),
        counts.to(torch.int64))


def _canonical(rec, counts):
    """Records bucket by bucket, each bucket in ascending order."""
    return rec[cand_build.bucket_order(_bucket_keys(counts), rec)]


def _shuffled(rec, counts, seed):
    """The records with each bucket in a random order."""
    g = torch.Generator().manual_seed(seed)
    noise = torch.randperm(rec.shape[0], generator=g).to(rec.device)
    return rec[cand_build.bucket_order(_bucket_keys(counts), noise)]


def _jax_stage1(p, args, dtype):
    """The JAX package's _gen_pairs on the port's prelude."""
    jnp, jcb = _jax()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    _, normals, offs, _, _, ndim = args
    key, score, cell = jcb._gen_pairs(
        jnp.asarray(normals, dtype=jdt), jnp.asarray(offs, dtype=jdt),
        jnp.asarray(p.b0.numpy()), jnp.asarray(p.span.numpy()),
        jnp.asarray(p.half, dtype=jdt), jnp.asarray(p.rmin, dtype=jdt),
        jnp.asarray(p.h, dtype=jdt), p.zc,
        offsets=tuple(product(*(range(s) for s in p.smax))),
        bin_shape=p.bin_shape, active=tuple(bool(h > 0) for h in p.h),
        eps=p.eps, ndim=ndim, n_bins=p.n_bins,
    )
    return np.asarray(key), np.asarray(score), np.asarray(cell)


def _alike_bins(args, dtype, bins_per_cell=KW["bins_per_cell"],
                max_bins=KW["max_bins"], eps=KW["eps"]):
    """The bins whose kept slots the two packages' stage 1 scores bit for
    bit alike, and how many bins differ."""
    p, *_ = cand_build.prepare_pairs(*args, dtype, bins_per_cell, max_bins,
                                     eps, "cpu")
    key, score = cand_build.key_score_plain(p)
    jkey, jscore, _ = _jax_stage1(p, args, dtype)
    np.testing.assert_array_equal(key.numpy(), jkey)
    kept = jkey < p.n_bins
    differ = np.unique(jkey[kept & (score.numpy() != jscore)])
    return np.setdiff1d(np.arange(p.n_bins), differ), len(differ)


def _score_tol(score, dtype, args):
    scale = max(np.abs(args[3]).max(), np.abs(args[4]).max(), 1.0)
    return 4 * EPS32 * np.abs(score) + 4 * torch.finfo(dtype).eps * scale


def _word_key_score(word):
    """(key int32, score float32) back from sort words."""
    order = word & 0xFFFFFFFF
    bits = torch.where(order >= 0x80000000, order ^ 0x80000000,
                       order ^ 0xFFFFFFFF)
    signed = torch.where(bits >= 0x80000000, bits - (1 << 32), bits)
    return (word >> 32).to(torch.int32), -signed.to(torch.int32).view(
        torch.float32)


def _row_lists(ids, ext, slot):
    """Each bin's list: its main row, then its extension row."""
    rows = [list(r[r >= 0]) for r in ids]
    if ext.size:
        for b in np.flatnonzero(slot >= 0):
            e = ext[slot[b]]
            rows[b] += list(e[e >= 0])
    return rows


def assert_lists_match(t_ids, t_ext, t_slot, j_ids, j_ext, j_slot,
                       ordered_bins=None, cut=None):
    """Candidate tables of the port's device builder against the JAX
    package's: the same shapes and extension slots; each bin's list the
    same cells; the same order in every bin of ``ordered_bins`` (all
    bins if None).  ``cut(b, port list, jax list)``, where given, checks
    instead the bins whose lists hold other cells (lists cut short of
    their bins' counts, whose near-tied cells at the cut may differ).
    Returns how many bins rank their cells otherwise."""
    t_ids, t_ext, t_slot = (np.asarray(a) for a in (t_ids, t_ext, t_slot))
    j_ids, j_ext, j_slot = (np.asarray(a) for a in (j_ids, j_ext, j_slot))
    assert t_ids.shape == j_ids.shape and t_ext.shape == j_ext.shape
    np.testing.assert_array_equal(t_slot, j_slot)
    tl, jl = _row_lists(t_ids, t_ext, t_slot), _row_lists(j_ids, j_ext, j_slot)
    reordered = [b for b in range(len(tl)) if tl[b] != jl[b]]
    for b in reordered:
        if cut is not None and sorted(tl[b]) != sorted(jl[b]):
            cut(b, tl[b], jl[b])
            continue
        assert sorted(tl[b]) == sorted(jl[b]), f"bin {b}: {tl[b]} != {jl[b]}"
    if ordered_bins is None:
        assert not reordered, f"bins ranked otherwise: {reordered[:10]}"
    else:
        bad = np.intersect1d(reordered, ordered_bins)
        assert len(bad) == 0, f"bins with equal scores ranked otherwise: {bad}"
    return len(reordered)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_stage1_matches_jax(mesh, dtype):
    """Stage 1 on the port's prelude against the JAX package's
    _gen_pairs: the same keys and cells, scores within 4 ulp; D1's plain
    records lie in their slots' bins, in canonical order, and carry the
    cells and scores; the sort words carry the keys and scores."""
    dtype = DTYPES[dtype]
    args = _args(mesh)
    p, *_ = cand_build.prepare_pairs(*args, dtype, KW["bins_per_cell"],
                                     KW["max_bins"], KW["eps"], "cpu")
    key, score = cand_build.key_score_plain(p)
    jkey, jscore, jcell = _jax_stage1(p, args, dtype)
    np.testing.assert_array_equal(key.numpy(), jkey)
    kept = jkey < p.n_bins
    assert 0 < kept.sum() < len(kept)
    d = np.abs(score.numpy() - jscore)[kept]
    assert (d <= _score_tol(jscore[kept], dtype, args)).all(), d.max()
    counts, rec = cand_build.bin_pairs_plain(p)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(jkey[kept], minlength=p.n_bins))
    # each record sits in its slot's bin and carries its cell and score
    slot = (rec & 0xFFFFFFFF).numpy()
    assert len(slot) == kept.sum()
    np.testing.assert_array_equal(
        jkey[slot], np.repeat(np.arange(p.n_bins), counts.numpy()))
    np.testing.assert_array_equal(jcell[slot], slot % len(args[0]))
    assert torch.equal((rec >> 32) & 0xFFFFFFFF,
                       cand_build.score_order(score[slot]))
    assert torch.equal(rec, _canonical(rec, counts))
    wkey, wscore = _word_key_score(cand_build.sort_word(key, score))
    assert torch.equal(wkey, key) and torch.equal(wscore, score)


@pytest.mark.parametrize("cover", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_builder_matches_jax(mesh, dtype, cover):
    """The whole builder against the JAX package's: bin grid exact,
    counts and extension slots equal, ordered lists equal in every bin
    whose stage-1 scores agree bit for bit, the same cells elsewhere.
    ``cover``: K widens to the worst bin (cover_ok)."""
    jnp, jcb = _jax()
    dtype = DTYPES[dtype]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    args = _args(mesh)
    kw = dict(KW, cover_ok=(lambda m: m <= 64) if cover else None)
    k_max = 2  # small enough for overflow bins in every mesh
    t = cand_build.build_candidate_bins_device(*args, k_max, dtype, **kw,
                                               device="cpu")
    j = jcb.build_candidate_bins_device(*args, k_max, dtype=jdt, **kw)
    assert t[2] == j[2]
    for a, b in ((t[3], j[3]), (t[4], j[4])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    assert all(x.dtype == torch.int32 for x in (t[0], t[1], t[5], t[6]))
    if cover:
        assert t[0].shape[1] == int(t[1].max()) > k_max and t[5].numel() == 0
    else:
        assert t[5].shape[1] > 0  # overflow bins spill into extension rows
    # bins whose kept slots score alike in both packages keep the order
    alike, n_differ = _alike_bins(args, dtype)
    n = assert_lists_match(t[0].numpy(), t[5].numpy(), t[6].numpy(),
                           j[0], j[5], j[6], ordered_bins=alike)
    assert n <= n_differ


def _graded():
    pts, cells, nbrs = meshgen.tet_box_mesh(4, 4, 4)
    pts = pts.copy()
    pts[0] = [50.0, 50.0, 50.0]  # one cell spans the whole domain
    return pts, cells, nbrs


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_graded_mesh_declines_to_host(dtype):
    """A mesh whose AABB spans blow the offset budget is declined by
    both packages' builders; "auto" then builds on the host and
    "device" raises the JAX package's ValueError."""
    jnp, jcb = _jax()
    import interpolate_unstructured_tpu as jiu

    dtype = DTYPES[dtype]
    pts, cells, nbrs = _graded()
    cp, normals, offs = _geometry(pts, cells, nbrs, "tetra")
    args = (cp, normals, offs, pts.min(0), pts.max(0), 3, 10)
    kw = dict(KW, ext_max_k=8)
    assert cand_build.build_candidate_bins_device(
        *args, dtype, **kw, device="cpu") is None
    assert jcb.build_candidate_bins_device(
        *args, dtype=jnp.float64 if dtype == torch.float64 else jnp.float32,
        **kw) is None
    auto = tiu.IUConfig(cand_build="auto", cand_build_device_min_cells=1)
    g = tiu.build_grid(pts, cells, nbrs, "tetra", point_data={"P": pts.sum(1)},
                       config=auto, dtype=dtype, locate_mode="walk",
                       device="cpu")
    host = tiu.build_grid(pts, cells, nbrs, "tetra",
                          point_data={"P": pts.sum(1)},
                          config=dataclasses.replace(auto, cand_build="host"),
                          dtype=dtype, locate_mode="walk", device="cpu")
    assert torch.equal(g.cand_ids, host.cand_ids)
    with pytest.raises(ValueError, match="offset budget") as e:
        tiu.build_grid(pts, cells, nbrs, "tetra", config=DEVICE, dtype=dtype,
                       locate_mode="walk", device="cpu")
    with pytest.raises(ValueError) as e_jax:
        jiu.build_grid(pts, cells, nbrs, "tetra",
                       config=jiu.IUConfig(cand_build="device"),
                       dtype=jnp.float64 if dtype == torch.float64
                       else jnp.float32, locate_mode="walk")
    assert str(e.value) == str(e_jax.value)


@pytest.mark.parametrize("above", [False, True])
def test_auto_picks_the_jax_builder(monkeypatch, above):
    """"auto" picks the builder the JAX package picks on either side of
    cand_build_device_min_cells (lowered to this small mesh's size)."""
    jnp, jcb = _jax()
    import interpolate_unstructured_tpu as jiu
    from interpolate_unstructured_tpu.ops import geometry as jgeometry

    pts, cells, nbrs = meshgen.tet_box_mesh(5, 5, 5)
    n = len(cells)
    calls = []

    def spy(module, name, tag):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls.append(tag)
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    spy(cand_build, "build_candidate_bins_device", "port device")
    spy(geometry, "build_candidate_bins", "port host")
    spy(jcb, "build_candidate_bins_device", "jax device")
    spy(jgeometry, "build_candidate_bins", "jax host")
    cfg = dict(cand_build="auto",
               cand_build_device_min_cells=n if above else n + 1)
    tiu.build_grid(pts, cells, nbrs, "tetra", config=tiu.IUConfig(**cfg),
                   dtype=torch.float32, locate_mode="walk", device="cpu")
    jiu.build_grid(pts, cells, nbrs, "tetra", config=jiu.IUConfig(**cfg),
                   dtype=jnp.float32, locate_mode="walk")
    kind = "device" if above else "host"
    assert calls == [f"port {kind}", f"jax {kind}"]


@pytest.mark.parametrize("case", ["triangle", "quad", "tetra"])
def test_device_built_grid_matches_jax(case):
    """A float32 grid built end to end with cand_build="device" by both
    packages: every candidate leaf but the id tables equal, the id tables
    the same lists (the same cells, and the same order in all but the
    near-tied bins), the packed rows' other columns and the queries within
    the tolerances of tests/test_torch_build.py and tests/
    test_torch_slice.py."""
    jnp, _ = _jax()
    import interpolate_unstructured_tpu as jiu
    from test_torch_build import _compare_rows

    sizes = {"triangle": (meshgen.triangle_rect_mesh, (20, 20)),
             "quad": (meshgen.quad_rect_mesh, (20, 20)),
             "tetra": (meshgen.tet_box_mesh, (8, 8, 8))}
    make, size = sizes[case]
    pts, cells, nbrs = make(*size)
    pd = {"Polynomial": pts.sum(1) + 1.0, "XY": pts[:, 0] * pts[:, 1]}
    ug = jiu.build_grid(pts, cells, nbrs, case, point_data=pd,
                        dtype=jnp.float32, locate_mode="walk",
                        config=jiu.IUConfig(cand_build="device"))
    tg = tiu.build_grid(pts, cells, nbrs, case, point_data=pd,
                        dtype=torch.float32, locate_mode="walk", config=DEVICE,
                        device="cpu")
    for f in ("cand_count", "cand_ext_slot", "cand_rmin", "cand_inv_h",
              "face_normals", "face_offsets", "walk_table"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(ug, f)), err_msg=f)
    assert tg.cand_shape == ug.cand_shape
    assert tg.cand_ext_covers == ug.cand_ext_covers
    assert tg.cand_nv == ug.cand_nv >= 1
    ext = (np.zeros((0, 0), np.int32) if ug.cand_ext_ids is None
           else np.asarray(ug.cand_ext_ids))
    t_ext = (np.zeros((0, 0), np.int32) if tg.cand_ext_ids is None
             else tg.cand_ext_ids.numpy())
    cp, normals, offs = _geometry(pts, cells, nbrs, case)
    cfg = tg.config
    alike, n_differ = _alike_bins(
        (cp, normals, offs, pts.min(0), pts.max(0),
         geometry.NDIM_OF_CELL_TYPE[case]), torch.float32,
        cfg.cand_bins_per_cell, cfg.cand_max_bins, 2.0 * cfg.eps_inside)
    n = assert_lists_match(tg.cand_ids.numpy(), t_ext,
                           tg.cand_ext_slot.numpy(), np.asarray(ug.cand_ids),
                           ext, np.asarray(ug.cand_ext_slot),
                           ordered_bins=alike)
    assert n <= n_differ
    same = (tg.cand_ids.numpy() == np.asarray(ug.cand_ids)).all(1)
    jt = np.asarray(ug.cand_table)[: len(same)]
    quantized = cand_table.is_quantized(case, torch.float32, tg.config)
    _compare_rows(jt[same], tg.cand_table.numpy()[same], ug,
                  tg.cand_ids.shape[1], quantized, tg.cand_nv)

    rng = np.random.default_rng(9)
    lo, hi = pts.min(0), pts.max(0)
    r = lo - 0.05 * (hi - lo) + rng.random((3000, 3)) * 1.1 * (hi - lo)
    if hi[2] == lo[2]:
        r[:, 2] = lo[2]
    r = r.astype(np.float32)
    tv, tic, tf = tiu.interpolate_at(tg, torch.from_numpy(r), [0, 1],
                                     fill_value=-7.0)
    jv, jic, jf = jiu.interpolate_at(ug, jnp.asarray(r), [0, 1],
                                     fill_value=-7.0)
    assert 0 < int(tf.sum()) < len(r)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tic.numpy(), np.asarray(jic))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=2e-6)


def test_word_order_is_the_jax_sort_order():
    """Records (score_order << 32 | slot) in canonical order, buckets by
    key and each ascending, reproduce lax.sort((key, -score, cell),
    num_keys=2, is_stable=True): keys ascending, scores descending, -0.0
    equal to +0.0 and NaN after every number, ties in slot order.  The
    sort words carry the same order bits."""
    jnp, _ = _jax()
    from jax import lax

    rng = np.random.default_rng(4)
    n = 4000
    key = rng.integers(0, 7, n).astype(np.int32)
    score = rng.choice(
        np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, np.nan, 2e-45,
                  -2e-45, 3.0], np.float32), n)
    cell = np.arange(n, dtype=np.int32)
    _, _, jcell = lax.sort(
        (jnp.asarray(key), -jnp.asarray(score), jnp.asarray(cell)),
        num_keys=2, is_stable=True)
    order = cand_build.score_order(torch.from_numpy(score))
    rec = (order << 32) | torch.from_numpy(cell).to(torch.int64)
    tkey = torch.from_numpy(key)
    tcell = rec[cand_build.bucket_order(tkey, rec)] & 0xFFFFFFFF
    np.testing.assert_array_equal(tcell.numpy(), np.asarray(jcell))
    word = cand_build.sort_word(tkey, torch.from_numpy(score))
    assert torch.equal(word & 0xFFFFFFFF, order)


def _numpy_prelude(cp, rmin, rmax, ndim, bins_per_cell, max_bins, eps):
    """The JAX package's prelude lines (its ops/cand_build.py:203-213) in
    numpy: (b0 int64, span int32, smax) of every cell."""
    rmin = np.asarray(rmin, np.float64)
    n_target = min(max(int(bins_per_cell * len(cp)), 1), max_bins)
    bin_shape, _, inv_h, _ = geometry._bin_grid_shape(rmin, rmax, ndim,
                                                      n_target)
    pad = eps + 1e-300
    lo = cp.min(axis=1) - pad
    hi = cp.max(axis=1) + pad
    b0 = np.clip(
        np.floor((lo - rmin) * inv_h).astype(np.int64), 0, bin_shape - 1
    )
    b1 = np.clip(
        np.floor((hi - rmin) * inv_h).astype(np.int64), 0, bin_shape - 1
    )
    span = (b1 - b0 + 1).astype(np.int32)
    return b0, span, span.max(axis=0)


def _jittered():
    """A tet box moved off the origin with jittered vertices, so that
    AABB edges fall near bin edges."""
    pts, cells, nbrs = meshgen.tet_box_mesh(6, 5, 7)
    rng = np.random.default_rng(5)
    pts = pts * [3.1, 0.7, 1.9] + [-3.7, 12.1, 0.3]
    pts = pts + rng.uniform(-0.02, 0.02, pts.shape)
    cp, normals, offs = _geometry(pts, cells, nbrs, "tetra")
    return (cp, normals, offs, pts.min(0), pts.max(0), 3)


def _case(name):
    """Stage-1 inputs and builder keywords of a named case."""
    if name.startswith("soup"):
        return _soup(int(name[4:])), SOUP_KW
    if name == "jittered":
        return _jittered(), KW
    return _args(name), KW


@pytest.mark.parametrize("case", [*MESHES, "jittered", "soup6", "soup18"])
def test_prelude_matches_numpy(case):
    """The prelude's b0, span and smax, computed by torch on the cell
    points, equal the JAX package's numpy lines bit for bit."""
    args, kw = _case(case)
    p, *_ = cand_build.prepare_pairs(*args, torch.float32,
                                     kw["bins_per_cell"], kw["max_bins"],
                                     kw["eps"], "cpu")
    b0, span, smax = _numpy_prelude(args[0], *args[3:],
                                    kw["bins_per_cell"], kw["max_bins"],
                                    kw["eps"])
    assert p.b0.dtype == p.span.dtype == torch.int32
    np.testing.assert_array_equal(p.b0.numpy(), b0)
    np.testing.assert_array_equal(p.span.numpy(), span)
    assert p.smax == tuple(int(s) for s in smax)


@pytest.mark.parametrize("case", [*MESHES, "soup6", "soup18"])
def test_fill_tables_any_bucket_order(case):
    """fill_tables_plain gives identical tables for the canonical records
    and for the records with each bucket shuffled."""
    args, kw = _case(case)
    p, *_ = cand_build.prepare_pairs(*args, torch.float32,
                                     kw["bins_per_cell"], kw["max_bins"],
                                     kw["eps"], "cpu")
    counts, rec = cand_build.bin_pairs_plain(p)
    k_max = 2 if case in MESHES else SOUP_K
    n_over = int((counts > k_max).sum())
    k_ext = min(int(counts.max()) - k_max, 32)
    assert n_over and k_ext
    n_cells = len(args[0])
    want = cand_build.fill_tables_plain(rec, counts, n_cells, k_max, k_ext,
                                        n_over)
    for seed in (0, 1):
        shuffled = _shuffled(rec, counts, seed)
        assert not torch.equal(shuffled, rec)
        got = cand_build.fill_tables_plain(shuffled, counts, n_cells, k_max,
                                           k_ext, n_over)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("cover", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [6, 18])
def test_heavy_bin_soup_matches_jax(n, dtype, cover):
    """A soup whose worst bin holds a whole small tet box (1,296 or
    34,992 cells: D2's block route, or its rank route past shared
    memory) against the JAX package's builder: bin grid, counts and
    extension slots exact, ordered lists equal in every bin whose stage-1
    scores agree bit for bit, the same cells elsewhere but at the cut of
    a list shorter than its bin, where near-tied cells may differ
    (ROADMAP C5).  ``cover``: K widens to the worst bin where it is at
    most SOUP_COVER (n = 6)."""
    jnp, jcb = _jax()
    dtype = DTYPES[dtype]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    args = _soup(n)
    kw = dict(SOUP_KW,
              cover_ok=(lambda m: m <= SOUP_COVER) if cover else None)
    t = cand_build.build_candidate_bins_device(*args, SOUP_K, dtype, **kw,
                                               device="cpu")
    j = jcb.build_candidate_bins_device(*args, SOUP_K, dtype=jdt, **kw)
    assert t[2] == j[2]
    for a, b in ((t[3], j[3]), (t[4], j[4])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    max_count = int(t[1].max())
    assert max_count >= 6 * n ** 3
    if cover and max_count <= SOUP_COVER:
        assert t[0].shape[1] == max_count and t[5].numel() == 0
    else:
        assert t[0].shape[1] == SOUP_K and t[5].shape[1] == 32
    alike, n_differ = _alike_bins(args, dtype, SOUP_KW["bins_per_cell"],
                                  SOUP_KW["max_bins"], SOUP_KW["eps"])
    p, *_ = cand_build.prepare_pairs(*args, dtype, SOUP_KW["bins_per_cell"],
                                     SOUP_KW["max_bins"], SOUP_KW["eps"],
                                     "cpu")
    jkey, jscore, _ = _jax_stage1(p, args, dtype)
    counts = t[1].numpy()
    n_cells, cut_bins = len(args[0]), []

    def cut(b, t_list, j_list):
        """A list cut short of its bin's count may keep other cells than
        the JAX package's only where they tie at the cut: each cell in
        one list alone scores (JAX) within twice the stage-1 tolerance of
        the JAX list's last score."""
        assert counts[b] > len(j_list) and b not in alike, f"bin {b}"
        slots = np.flatnonzero(jkey == b)
        score = dict(zip(slots % n_cells, jscore[slots]))
        last = score[j_list[-1]]
        for c in set(t_list) ^ set(j_list):
            tol = _score_tol(max(abs(score[c]), abs(last)), dtype, args)
            assert abs(score[c] - last) <= 2 * tol, (b, c, score[c], last)
        cut_bins.append(b)

    n_re = assert_lists_match(t[0].numpy(), t[5].numpy(), t[6].numpy(),
                              j[0], j[5], j[6], ordered_bins=alike, cut=cut)
    assert n_re <= n_differ and len(cut_bins) <= 1


def _card_matches_plain(dev, args, dtype, kw, k_max):
    """D1's count pass, its write pass (canonically ordered inside each
    bucket) and D2 (on the write pass's records and on the records with
    each bucket shuffled) torch.equal to their plain versions on the
    card; the builder on the card equal to the builder on the CPU.
    Returns the largest count."""
    bk = cand_build_kernel
    p, *_ = cand_build.prepare_pairs(*args, dtype, kw["bins_per_cell"],
                                     kw["max_bins"], kw["eps"], dev)
    n0 = (bk.count_launches, bk.write_launches, bk.order_launches)
    counts = bk.count_pairs_cuda(p)
    want_counts, want_rec = cand_build.bin_pairs_plain(p)
    assert torch.equal(counts, want_counts)
    start = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rec = bk.write_pairs_cuda(p, start, int(counts.sum()))
    assert torch.equal(_canonical(rec, counts), want_rec)
    max_count = int(counts.max())
    n_over = int((counts > k_max).sum())
    k_ext = min(max_count - k_max, kw["ext_max_k"]) if n_over else 0
    n_cells = len(args[0])
    want = cand_build.fill_tables_plain(want_rec, counts, n_cells, k_max,
                                        k_ext, n_over)
    for r in (rec, _shuffled(rec, counts, 3)):
        got = bk.order_tables_cuda(r, start, counts,
                                   cand_build.ext_slots(counts, k_max),
                                   n_cells, k_max, k_ext, n_over, max_count)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert (bk.count_launches, bk.write_launches, bk.order_launches) == (
        n0[0] + 1, n0[1] + 1, n0[2] + 2)
    on_card = cand_build.build_candidate_bins_device(*args, k_max, dtype,
                                                     **kw, device=dev)
    on_cpu = cand_build.build_candidate_bins_device(*args, k_max, dtype,
                                                    **kw, device="cpu")
    for i in (0, 1, 5, 6):
        assert torch.equal(on_card[i].cpu(), on_cpu[i])
    assert on_card[2] == on_cpu[2]
    return max_count


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cuda_kernels_match_plain(cuda, mesh, dtype):
    """D1's counts and records and D2's tables torch.equal to their plain
    versions on the same card tensors, and the whole builder on the card
    to the builder on the CPU."""
    _card_matches_plain(cuda, _args(mesh), DTYPES[dtype], KW, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [6, 18])
def test_cuda_heavy_bin_soup(cuda, n, dtype):
    """The heavy-bin soups on the card: D2's block route (n = 6) and its
    rank route past shared memory (n = 18) torch.equal to the plain
    version, with and without K widened to the worst bin."""
    args = _soup(n)
    dtype = DTYPES[dtype]
    max_count = _card_matches_plain(cuda, args, dtype, SOUP_KW, SOUP_K)
    assert max_count > (16384 if n == 18 else 32)
    _card_matches_plain(cuda, args, dtype, SOUP_KW, max_count)


@pytest.mark.cuda
def test_cuda_builder_runs_no_sort(cuda):
    """The builder on a CUDA grid launches D1 twice and D2 once, and no
    aten::sort."""
    from torch.profiler import ProfilerActivity, profile

    bk = cand_build_kernel
    args = _args("tetra")
    cand_build.build_candidate_bins_device(*args, 10, torch.float32, **KW,
                                           device=cuda)
    n0 = (bk.count_launches, bk.write_launches, bk.order_launches)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cand_build.build_candidate_bins_device(*args, 10, torch.float32,
                                               **KW, device=cuda)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert not any("sort" in x for x in names), sorted(names)
    assert (bk.count_launches, bk.write_launches, bk.order_launches) == (
        n0[0] + 1, n0[1] + 1, n0[2] + 1)
