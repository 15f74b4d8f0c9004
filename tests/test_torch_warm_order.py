"""The bin order of a walk grid's large batches (``ops/order_kernel.py``).

On the CPU: the plain key pass against the seed bins shifted by hand,
the plain order (key pass, scan and scatter) and unsort against a direct
permutation, the engage rule and the key grid's coarsening as pure
functions of the batch, and ``interpolate_at``'s route in bin order
(the plain versions, forced on) ``torch.equal`` to the unordered route
in cells, found masks, values and B3's step count, on float32 and
float64 walk grids of tets, triangles and quads, a kd-tree-seeded one
included, with good, negative and out-of-range guesses, no guess and
queries off the domain; the counters ``order.calls`` and
``order.queries`` of a traced call, and none for a candidate grid's
calls.

On the card: each kernel against its plain version, and the same
equalities through ``interpolate_at`` itself, for batches just below and
just above the engage rule.
"""

import dataclasses

import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.ops import (
    geometry,
    interp,
    locate,
    order_kernel,
)
from interpolate_unstructured_tpu_torch.utils import meshgen, timing

WALK = tiu.IUConfig(use_candidate_bins=False, walk_compact_min_batch=2048)
CONFIGS = {
    "bins": WALK,
    "kdtree": dataclasses.replace(WALK, seed_mode="kdtree"),
}
MESHES = {
    "tetra": lambda: meshgen.tet_box_mesh(7, 7, 7),
    "triangle": lambda: meshgen.triangle_rect_mesh(20, 20),
    "quad": lambda: meshgen.quad_rect_mesh(20, 20),
}
DTYPES = {"float32": torch.float32, "float64": torch.float64}
GUESSES = ["good", "negative", "past_last", "none"]


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_sqrt():
    """Run torch.sqrt once on every intra-op thread before the tests:
    on some virtualized hosts a worker thread's first float32
    torch.sqrt in a process is off by ~1e-4 relative."""
    x = torch.rand(1 << 20) + 0.5
    for _ in range(2):
        torch.sqrt(x)


@pytest.fixture(autouse=True)
def _empty_registry():
    timing.metrics.reset()
    yield
    timing.metrics.reset()


def _build(cell_type, dtype, device, config=WALK):
    pts, cells, nbrs = MESHES[cell_type]()
    pd = {"a": pts[:, 0] + 2 * pts[:, 1] - pts[:, 2],
          "b": pts[:, 0] * pts[:, 1] + 0.5}
    return tiu.build_grid(pts, cells, nbrs, cell_type, point_data=pd,
                          dtype=dtype, device=device, config=config,
                          locate_mode="walk")


def _queries(grid, n, guess_kind, seed=5):
    """n queries over the grid's box widened by 10% each side (some off
    the domain; z = 0 on a 2D mesh), and guesses of the kind asked for:
    the cells of the queries a small step back, those negated, those
    pushed past the last cell, or None."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = grid.rmin.cpu().double(), grid.rmax.cpu().double()
    span = hi - lo
    r = lo - 0.1 * span + 1.2 * span * torch.rand(n, 3, generator=g,
                                                  dtype=torch.float64)
    flat = span[2] == 0
    if flat:
        r[:, 2] = lo[2]
    r = r.to(dtype=grid.dtype, device=grid.device)
    if guess_kind == "none":
        return r, None
    step = 0.02 * span * (torch.rand(n, 3, generator=g, dtype=torch.float64)
                          - 0.5)
    if flat:
        step[:, 2] = 0
    back = (r.cpu().double() - step).to(dtype=grid.dtype, device=grid.device)
    guess, _ = locate.get_cell(grid, back)
    if guess_kind == "negative":
        guess = torch.where(guess >= 0, -guess - 2, guess)
    elif guess_kind == "past_last":
        guess = guess + grid.n_cells
    return r, guess


def _traced(fn):
    """``fn()`` inside a CPU profiler session (the port's counters on);
    returns its output and the entry call's counters."""
    timing.metrics.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    calls = timing.metrics.report().get("entry_calls", [])
    timing.metrics.reset()
    return out, calls


def _unordered(grid, r, slots, guess):
    ic, found = locate.get_cell(grid, r, guess)
    return ic, found, interp.interpolate_at_icell(grid, r, slots, ic)


def _steps(fn):
    """(outputs, walk.steps summed) of ``fn()`` traced."""
    timing.metrics.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    steps = timing.metrics.report()["counters"].get("walk.steps", 0.0)
    timing.metrics.reset()
    return out, steps


def _bits(x):
    """A tensor's bits: floats as integers of their width, so NaNs
    compare."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def _assert_same(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))


def _fixed_shift(m, shift):
    """Make the bin order use a key grid of ``shift`` halvings (the
    monkeypatch context ``m``)."""
    m.setattr(order_kernel, "key_shift", lambda shape: shift)


def _interpolate_unordered(monkeypatch, grid, r, slots, guess):
    """``interpolate_at`` with the bin order turned off, and the step
    count of its walks."""
    with monkeypatch.context() as m:
        m.setattr(interp, "_takes_bin_order", lambda g, n: False)
        return _steps(lambda: tiu.interpolate_at(grid, r, slots,
                                                       guess=guess))


# ---- pure functions --------------------------------------------------------


H100_L2 = 50 * 2**20  # bytes


@pytest.mark.parametrize("n_queries,n_cells,l2,cell_type,expect", [
    (10_000_000, 998_250, H100_L2, "tetra", True),
    (2_994_749, 998_250, H100_L2, "tetra", False),
    (2_994_750, 998_250, H100_L2, "tetra", True),
    (1_996_500, 998_250, H100_L2, "tetra", False),
    # 750,000 tets: 3 a cell is under the batch's 28 L2, 4 is over
    (2_250_000, 750_000, H100_L2, "tetra", False),
    (2_867_199, 750_000, H100_L2, "tetra", False),
    (2_867_200, 750_000, H100_L2, "tetra", True),
    # 413,526 tets (4.04 L2) at 10 a cell; 409,599 (3.9999 L2) never
    (4_135_260, 413_526, H100_L2, "tetra", True),
    (10**9, 409_599, H100_L2, "tetra", False),
    (10**9, 409_600, H100_L2, "tetra", True),
    (10_000_000, 998_250, 3 * H100_L2, "tetra", False),
    (10_000_000, 998_250, H100_L2 // 4, "tetra", True),
    (10_000_000, 1_000_000, H100_L2, "quad", False),
    (10_000_000, 999_698, H100_L2, "triangle", False),
    (0, 0, H100_L2, "tetra", False),
])
def test_engage_rule(n_queries, n_cells, l2, cell_type, expect):
    """Tets whose walk rows of 512 bytes a cell fill at least
    MIN_L2_TIMES times the L2, a batch of at least MIN_PER_CELL queries a
    cell, whose queries, a row each, fill at least MIN_BATCH_L2_TIMES
    times the L2."""
    assert (order_kernel.MIN_L2_TIMES, order_kernel.MIN_PER_CELL,
            order_kernel.MIN_BATCH_L2_TIMES) == (4, 3, 28)
    row_bytes = 512 * n_cells
    assert order_kernel.engages(n_queries, n_cells, row_bytes, l2,
                                cell_type) is expect
    want = (cell_type == "tetra"
            and row_bytes >= order_kernel.MIN_L2_TIMES * l2
            and n_queries >= order_kernel.MIN_PER_CELL * n_cells
            and n_queries * 512 >= order_kernel.MIN_BATCH_L2_TIMES * l2)
    assert want is expect


@pytest.mark.parametrize("shape,shift", [
    ((158, 158, 158), 5), ((203, 203, 203), 6), ((40, 40, 1), 2),
    ((7, 3, 5), 0), ((1, 1, 1), 0), ((1000, 3, 3), 3)])
def test_key_shift_rule(shape, shift):
    """The fewest halvings whose key grid has at most TILE // KEY_RUN
    bins, counted bin by bin."""
    assert order_kernel.key_shift(shape) == shift

    def n_keys(s):
        out = 1
        for n in shape:
            out *= len({i >> s for i in range(n)})
        return out

    limit = order_kernel.TILE // order_kernel.KEY_RUN
    assert order_kernel.key_shape(shape, shift) == tuple(
        len({i >> shift for i in range(n)}) for n in shape)
    assert order_kernel.n_keys(shape, shift) == n_keys(shift) <= limit
    assert all(n_keys(s) > limit for s in range(shift))


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_keys_are_shifted_seed_bins(shift, dtype):
    """The plain key pass: the seed bin of get_cell's cold start, each
    coordinate shifted right, flat over the key grid; queries off the
    grid clamp to its edge bins."""
    grid = _build("tetra", DTYPES[dtype], "cpu")
    r, _ = _queries(grid, 3000, "none")
    key = order_kernel.order_keys_plain(r, grid.bin_rmin, grid.bin_inv_h,
                                        grid.bin_shape, shift)
    ijk = geometry.bin_ijk(r, grid.bin_rmin, grid.bin_inv_h, grid.bin_shape,
                           torch.int64)
    ks = order_kernel.key_shape(grid.bin_shape, shift)
    want = [(int(i) >> shift, int(j) >> shift, int(k) >> shift)
            for i, j, k in zip(*ijk)]
    assert [((int(x) // ks[2]) // ks[1], (int(x) // ks[2]) % ks[1],
             int(x) % ks[2]) for x in key] == want
    assert int(key.min()) >= 0 and int(key.max()) < ks[0] * ks[1] * ks[2]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_start", [True, False])
def test_plain_order_against_a_direct_permutation(monkeypatch, dtype,
                                                  with_start):
    """order_plain lists the queries key bin by key bin, in ascending key
    order and in query order inside a bin, with their start cells; slot
    is each query's place in that list."""
    grid = _build("tetra", DTYPES[dtype], "cpu")
    r, guess = _queries(grid, 2000, "good")
    start = guess if with_start else None
    shift = 1
    _fixed_shift(monkeypatch, shift)
    key = order_kernel.order_keys_plain(r, grid.bin_rmin, grid.bin_inv_h,
                                        grid.bin_shape, shift)
    r_o, start_o, back = order_kernel.order(grid, r, start)
    slot = back.slot
    assert slot.dtype == back.pos.dtype == torch.int32
    want = sorted(range(2000), key=lambda q: (int(key[q]), q))
    for s, q in enumerate(want):
        assert torch.equal(r_o[s], r[q]) and int(slot[q]) == s
        if with_start:
            assert int(start_o[s]) == int(start[q])
    assert (start_o is None) is (not with_start)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_vars", [0, 1, 3])
def test_plain_unsort_against_a_direct_permutation(monkeypatch, dtype,
                                                  n_vars):
    """unsort_plain takes row slot[q] into row q, so it undoes the
    order."""
    g = torch.Generator().manual_seed(2)
    b = 777
    slot = torch.randperm(b, generator=g).to(torch.int32)
    ic = torch.randint(-5, 50, (b,), generator=g, dtype=torch.int32)
    found = ic >= 0
    vals = torch.rand(b, n_vars, generator=g, dtype=DTYPES[dtype])
    back = order_kernel.Back(slot, order_kernel.tile_positions(slot))
    ic_q, found_q, vals_q = order_kernel.unsort(back, ic, found, vals)
    for q in range(b):
        s = int(slot[q])
        assert int(ic_q[q]) == int(ic[s]) and bool(found_q[q]) == bool(
            found[s])
        assert torch.equal(vals_q[q], vals[s])
    # the order, then the unsort, is the identity
    grid = _build("tetra", DTYPES[dtype], "cpu")
    r, guess = _queries(grid, b, "good")
    _fixed_shift(monkeypatch, 2)
    r_o, start_o, back = order_kernel.order(grid, r, guess)
    _assert_same(order_kernel.unsort(back, start_o, start_o >= 0, r_o),
                 (guess, guess >= 0, r))


@pytest.mark.parametrize("b", [1, 2047, 2048, 5000])
def test_tile_positions_against_a_direct_count(b):
    """A query's position among its tile's slots: how many queries of its
    tile of TILE have a lower slot."""
    g = torch.Generator().manual_seed(b)
    slot = torch.randperm(b, generator=g).to(torch.int32)
    pos = order_kernel.tile_positions(slot)
    t = order_kernel.TILE
    for q in range(b):
        lo = q // t * t
        tile = slot[lo: lo + t]
        assert int(pos[q]) == int((tile < slot[q]).sum())


def test_order_and_unsort_check_their_shapes():
    grid = _build("tetra", torch.float32, "cpu")
    with pytest.raises(ValueError):
        order_kernel.order(grid, torch.zeros(4, 2))
    with pytest.raises(ValueError):
        order_kernel.order(grid, torch.zeros(4, 3),
                           torch.zeros(3, dtype=torch.int32))
    slot = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        order_kernel.unsort(order_kernel.Back(slot, slot),
                            torch.zeros(4, dtype=torch.int32),
                            torch.zeros(3, dtype=torch.bool),
                            torch.zeros(4, 1))


# ---- the route, on the CPU (plain versions) --------------------------------


@pytest.fixture(scope="module")
def cpu_grids():
    return {}


def _grid(cache, cell_type, dtype, seed_mode, device="cpu"):
    key = (cell_type, dtype, seed_mode, device)
    if key not in cache:
        cache[key] = _build(cell_type, DTYPES[dtype], device,
                            CONFIGS[seed_mode])
    return cache[key]


@pytest.mark.parametrize("guess_kind", GUESSES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cell_type", list(MESHES))
def test_route_in_bin_order_is_bit_equal(cpu_grids, monkeypatch, cell_type,
                                         dtype, guess_kind):
    """In bin order (the plain key pass, scan, scatter and unsort) the
    cells, found masks, values and step count are the unordered route's,
    at every coarsening."""
    grid = _grid(cpu_grids, cell_type, dtype, "bins")
    r, guess = _queries(grid, 4000, guess_kind)
    slots = (0, 1)
    want, steps = _steps(lambda: _unordered(grid, r, slots, guess))
    assert not bool(want[1].all()) and bool(want[1].any())
    for shift in (None, 0, 2):
        with monkeypatch.context() as m:
            if shift is not None:
                _fixed_shift(m, shift)
            got, got_steps = _steps(lambda: interp._in_bin_order(
                grid, r, slots, guess))
        _assert_same(got, want)
        assert got_steps == steps > 0


@pytest.mark.parametrize("guess_kind", ["good", "past_last", "none"])
def test_route_in_bin_order_on_a_kdtree_grid(cpu_grids, guess_kind):
    grid = _grid(cpu_grids, "tetra", "float64", "kdtree")
    assert grid.kd_node_points is not None
    r, guess = _queries(grid, 3000, guess_kind)
    want = _unordered(grid, r, (0,), guess)
    _assert_same(interp._in_bin_order(grid, r, (0,), guess), want)


def test_interpolate_at_takes_the_route_and_counts_it(cpu_grids,
                                                      monkeypatch):
    """Forced on for the CPU, interpolate_at takes the bin order: the
    same outputs (fill included), order.calls 1 and order.queries B in
    the traced call; a batch the rule turns down counts nothing."""
    grid = _grid(cpu_grids, "tetra", "float32", "bins")
    r, guess = _queries(grid, 3000, "good")
    want = tiu.interpolate_at(grid, r, [0, 1], guess=guess, fill_value=-7.0)
    monkeypatch.setattr(interp, "_takes_bin_order", lambda g, n: True)
    got, calls = _traced(lambda: tiu.interpolate_at(
        grid, r, [0, 1], guess=guess, fill_value=-7.0))
    _assert_same(got, want)
    (call,) = calls
    assert call["counters"]["order.calls"] == 1
    assert call["counters"]["order.queries"] == 3000
    assert call["counters"]["walk.queries"] == 3000
    monkeypatch.undo()
    _, calls = _traced(lambda: tiu.interpolate_at(grid, r, [0], guess=guess))
    assert "order.calls" not in calls[0]["counters"]


def test_candidate_grid_calls_count_no_order(monkeypatch):
    """A candidate grid keeps its routes (the fused cold call, the warm
    probe): no order counter, even with the rule forced open."""
    pts, cells, nbrs = meshgen.tet_box_mesh(6, 6, 6)
    grid = tiu.build_grid(pts, cells, nbrs, "tetra",
                          point_data={"a": pts[:, 0]}, device="cpu",
                          locate_mode="walk")
    assert grid.cand_table is not None
    monkeypatch.setattr(order_kernel, "engages", lambda *a: True)
    r, guess = _queries(grid, 2000, "good")
    assert not interp._takes_bin_order(grid, r.shape[0])
    for g in (None, guess):
        _, calls = _traced(lambda: tiu.interpolate_at(grid, r, [0], guess=g))
        assert not any(k.startswith("order.") for k in calls[0]["counters"])


def test_cpu_grids_keep_the_unordered_route(monkeypatch):
    """The route engages on the card only: a CPU grid takes the unordered
    route even where the rule would take its batch."""
    grid = _build("tetra", torch.float32, "cpu")
    monkeypatch.setattr(order_kernel, "engages", lambda *a: True)
    assert not interp._takes_bin_order(grid, 10**8)


# ---- on the card ----------------------------------------------------------


@pytest.fixture(scope="module")
def card_grids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shift", [1, 3])
def test_cuda_kernels_match_their_plain_versions(card_grids, monkeypatch,
                                                 dtype, shift):
    """The key pass and scatter put the queries in ascending key order
    (as the plain keys order them; in a bin in any order), each with its
    start cell, the keys of the plain version, and a slot that finds each
    query there; the unsort equals its plain version, on the kernels'
    slots and on the plain version's."""
    grid = _grid(card_grids, "tetra", dtype, "bins", "cuda")
    b = 200_003
    r, guess = _queries(grid, b, "good")
    _fixed_shift(monkeypatch, shift)
    for start in (guess, None):
        r_o, start_o, back = order_kernel.order(grid, r, start)
        s = back.slot.long()
        assert torch.equal(torch.sort(s).values,
                           torch.arange(b, device="cuda"))
        assert torch.equal(r_o[s], r)
        if start is None:
            assert start_o is None
        else:
            assert torch.equal(start_o[s], start)
        plain = order_kernel.order_plain(r, start, grid.bin_rmin,
                                         grid.bin_inv_h, grid.bin_shape,
                                         shift)
        key = order_kernel.order_keys_plain(r_o, grid.bin_rmin,
                                            grid.bin_inv_h, grid.bin_shape,
                                            shift)
        assert bool((key[1:] >= key[:-1]).all())
        assert torch.equal(back.pos, order_kernel.tile_positions(back.slot))
    ic, found = locate.get_cell(grid, r)
    for n_vars in (0, 3, 5):
        vals = torch.rand(b, n_vars, dtype=grid.dtype, device="cuda")
        for bk in (back, plain[2]):
            _assert_same(order_kernel.unsort(bk, ic, found, vals),
                         order_kernel.unsort_plain(bk, ic, found, vals))


@pytest.mark.cuda
@pytest.mark.parametrize("guess_kind", GUESSES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cell_type", list(MESHES))
def test_cuda_route_in_bin_order_is_bit_equal(card_grids, monkeypatch,
                                              cell_type, dtype, guess_kind):
    """interpolate_at in bin order (the rule opened for a small grid): the
    unordered route's values, cells, found masks and B3's step count."""
    grid = _grid(card_grids, cell_type, dtype, "bins", "cuda")
    b = 150_001
    monkeypatch.setattr(order_kernel, "engages", lambda *a: True)
    assert interp._takes_bin_order(grid, b)
    r, guess = _queries(grid, b, guess_kind)
    want, steps = _interpolate_unordered(monkeypatch, grid, r, [0, 1], guess)
    assert not bool(want[2].all()) and bool(want[2].any())
    got, got_steps = _steps(lambda: tiu.interpolate_at(
        grid, r, [0, 1], guess=guess))
    _assert_same(got, want)
    assert got_steps == steps > 0


@pytest.mark.cuda
@pytest.mark.parametrize("guess_kind", ["good", "none"])
def test_cuda_route_on_a_kdtree_grid(card_grids, monkeypatch, guess_kind):
    grid = _grid(card_grids, "tetra", "float64", "kdtree", "cuda")
    b = 70_000
    monkeypatch.setattr(order_kernel, "engages", lambda *a: True)
    assert interp._takes_bin_order(grid, b)
    r, guess = _queries(grid, b, guess_kind)
    want, _ = _interpolate_unordered(monkeypatch, grid, r, [0], guess)
    _assert_same(tiu.interpolate_at(grid, r, [0], guess=guess), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_engage_rule_edges(card_grids, monkeypatch, dtype):
    """On a 46^3 box (583,976 tets, walk rows more than MIN_L2_TIMES
    times the card's L2) the batch one under the rule's least stays
    unordered and the least takes the bin order: each gives the
    unordered route's outputs, and the traced call counts order.calls and
    order.queries only for the second."""
    pts, cells, nbrs = meshgen.tet_box_mesh(46, 46, 46)
    grid = tiu.build_grid(pts, cells, nbrs, "tetra",
                          point_data={"a": pts[:, 0] - pts[:, 2]},
                          dtype=DTYPES[dtype], device="cuda", config=WALK,
                          locate_mode="walk")
    l2 = order_kernel.l2_bytes(grid.device)
    row = grid.walk_table.nbytes // grid.n_cells
    edge = max(order_kernel.MIN_PER_CELL * grid.n_cells,
               -(-order_kernel.MIN_BATCH_L2_TIMES * l2 // row))
    assert grid.walk_table.nbytes >= order_kernel.MIN_L2_TIMES * l2
    for b, ordered in ((edge - 1, False), (edge, True)):
        assert interp._takes_bin_order(grid, b) is ordered
        r, guess = _queries(grid, b, "good", seed=b)
        want, _ = _interpolate_unordered(monkeypatch, grid, r, [0], guess)
        got, calls = _traced(lambda: tiu.interpolate_at(
            grid, r, [0], guess=guess))
        _assert_same(got, want)
        (call,) = calls
        if ordered:
            assert call["counters"]["order.calls"] == 1
            assert call["counters"]["order.queries"] == b
        else:
            assert "order.calls" not in call["counters"]


@pytest.mark.cuda
def test_cuda_candidate_grid_counts_no_order(card_grids, monkeypatch):
    pts, cells, nbrs = meshgen.tet_box_mesh(12, 12, 12)
    grid = tiu.build_grid(pts, cells, nbrs, "tetra",
                          point_data={"a": pts[:, 0]}, device="cuda",
                          locate_mode="walk")
    assert grid.cand_table is not None
    monkeypatch.setattr(order_kernel, "engages", lambda *a: True)
    r, guess = _queries(grid, 100_000, "good")
    for g in (None, guess):
        _, calls = _traced(lambda: tiu.interpolate_at(grid, r, [0], guess=g))
        assert not any(k.startswith("order.") for k in calls[0]["counters"])
