"""The fused tracer's set-up as a CUDA graph (``trace._graphed_start``).

On the card a fused trace replays its start cells and start field as one
CUDA graph from the second call of a key (the grid, the batch size, the
fields, the stream: what the set-up reads) on; a key's first call runs
eagerly, and a set-up that cannot be captured runs eagerly for good.

On the CPU: the bookkeeping, with a stand-in graph whose replay runs the
set-up again into its static outputs: eager, capture, replays; a new
key eager; at most ``GRAPHS_KEPT`` keys a grid, dropped with the grid; a
set-up with a host read (a candidate grid whose rows leave a residual)
never captured, and spans off inside the capture.  On the card: graphed
traces ``torch.equal`` to eager ones in every ``TraceResult`` field over
several starts of one batch size, on candidate, walk, brute-force,
residual and kd-tree-seeded grids; a new batch size and a grid from
``add_point_data`` run eagerly, a second table and ``reverse`` replay
the same graph; a set-up whose capture CUDA refuses runs eagerly; the
counters; a first call made while tracing leaves no span inside the
graph; a traced fused call and a traced walk-grid ``get_cell`` read
nothing back; a device move keeps the held walk tolerances.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch import trace as ttrace
from interpolate_unstructured_tpu_torch.utils import meshgen, timing
from interpolate_unstructured_tpu_torch.utils.config import walk_tolerances

TRACE_KW = dict(min_dx=1e-3, max_dx=0.05, max_steps=24, rtol=1e-3,
                atol=1e-3)
FIELDS = (1, 2, 3)
COUNTERS = ("trace.graph_eager", "trace.graph_captures",
            "trace.graph_replays")


@pytest.fixture(autouse=True)
def _empty_registry():
    timing.metrics.reset()
    yield
    timing.metrics.reset()


def _grids(device, n):
    """Candidate (rows covering every bin), walk and brute-force grids
    of a tet box with a linear field and a helix, and a candidate grid
    whose rows leave a residual (coarse bins, short rows and no
    extension rows)."""
    pts, cells, nbrs = meshgen.tet_box_mesh(n, n, n)
    pd = {"a": pts[:, 0] + 2 * pts[:, 1] - pts[:, 2],
          "hx": -(pts[:, 1] - 0.5), "hy": pts[:, 0] - 0.5,
          "hz": 0.25 + 0 * pts[:, 0]}

    def build(mesh=(pts, cells, nbrs), **kw):
        kw.setdefault("locate_mode", "walk")
        return tiu.build_grid(*mesh, "tetra", point_data=pd, device=device,
                              dtype=torch.float32, **kw)

    small = meshgen.tet_box_mesh(4, 4, 4)
    residual = tiu.IUConfig(cand_build="host", cand_cover_row_bytes=0,
                            cand_ext_max_k=0, cand_bins_per_cell=0.05,
                            cand_row_bytes=64)
    grids = {
        "cand": build(),
        "walk": build(config=tiu.IUConfig(use_candidate_bins=False)),
        "residual": build(config=residual),
        "kdtree": build(config=tiu.IUConfig(use_candidate_bins=False,
                                            seed_mode="kdtree")),
    }
    spts = small[0]
    pd_small = {"a": spts[:, 0], "hx": -(spts[:, 1] - 0.5),
                "hy": spts[:, 0] - 0.5, "hz": 0.25 + 0 * spts[:, 0]}
    grids["bruteforce"] = tiu.build_grid(
        *small, "tetra", point_data=pd_small, device=device,
        dtype=torch.float32, locate_mode="bruteforce")
    assert grids["cand"].cand_ext_covers
    assert not grids["residual"].cand_ext_covers
    assert grids["kdtree"].kd_node_points is not None
    return grids


def _starts(device, b, seed):
    g = torch.Generator().manual_seed(seed)
    return (0.3 + 0.4 * torch.rand(b, 3, generator=g)).to(device)


def _counts():
    c = timing.metrics.report()["counters"]
    return tuple(int(c.get(k, 0)) for k in COUNTERS)


# ---- the bookkeeping, on the CPU ------------------------------------------


class _Replay:
    """A stand-in for a CUDA graph: replay runs the set-up again on the
    static input and writes its static outputs in place."""

    def __init__(self, start, y0, out):
        self.start, self.y0, self.out = start, y0, out

    def replay(self):
        with timing.capturing():  # a replay makes no span
            new = self.start(self.y0)
        for o, n in zip(self.out, new, strict=True):
            o.copy_(n)


def _stand_in_capture(self, start, y0):
    y0 = y0.clone()
    with timing.capturing():
        out = start(y0)
    self.graph, self.y0, self.out = _Replay(start, y0, out), y0, out


@pytest.fixture(scope="module")
def cpu_grids():
    return _grids("cpu", 5)


def _cpu_start(grid):
    """The fused path's set-up, as ``integrate_along_field`` makes it,
    on the CPU: start cells, found mask, the field there."""

    def start(y0):
        ic, found = tiu.get_cell(grid, y0)
        field = tiu.interpolate_at_icell(grid, y0, FIELDS, ic.clamp_min(0))
        return ic, found, field

    return start


def _run(grid, key, y0):
    return ttrace._graphed_start(grid, key, _cpu_start(grid), y0)


@pytest.mark.parametrize("case", ["repeat", "new_key", "kept", "host_read"])
def test_graphed_start_bookkeeping(cpu_grids, monkeypatch, case):
    monkeypatch.setattr(ttrace._SetupGraph, "capture", _stand_in_capture)
    grid = cpu_grids["residual" if case == "host_read" else "cand"]
    grid = dataclasses.replace(grid)  # a cache of its own
    starts = [_starts("cpu", 64, s) for s in range(5)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        if case == "kept":
            for k in range(ttrace.GRAPHS_KEPT + 3):
                _run(grid, ("key", k), starts[0])
            assert list(ttrace._graphs_of(grid)) == [
                ("key", k) for k in range(3, ttrace.GRAPHS_KEPT + 3)]
            gid = id(grid)
            del grid
            gc.collect()
            assert gid not in ttrace._GRAPHS  # dropped with the grid
            return
        for k, y0 in enumerate(starts):
            key = ("key", k) if case == "new_key" else ("key",)
            got = _run(grid, key, y0)
            want = _cpu_start(grid)(y0)
            assert all(torch.equal(a, b) for a, b in zip(got, want,
                                                         strict=True))
    expect = {"repeat": (1, 1, 3), "new_key": (5, 0, 0),
              "host_read": (5, 0, 0)}[case]
    assert _counts() == expect
    # iu.locate: each reference set-up and each eager one; the capture
    # ran with the spans off
    spans = timing.metrics.report()["spans"]
    assert spans["iu.locate"]["count"] == 5 + expect[0]
    if case == "host_read":
        assert ttrace._graphs_of(grid)[("key",)].graph is None


# ---- on the card ----------------------------------------------------------


@pytest.fixture(scope="module")
def card_grids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _grids(torch.device("cuda"), 10)


def _trace(grid, y0, table, **kw):
    return tiu.integrate_along_field(grid, y0, FIELDS, trace_table=table,
                                     **dict(TRACE_KW, **kw))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def _eager(g, y0, table, **kw):
    """The trace of ``y0`` on a copy of ``g`` that no call has seen, so
    its set-up runs eagerly."""
    return _trace(dataclasses.replace(g), y0, table, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["cand", "walk", "bruteforce", "residual",
                                  "kdtree"])
def test_cuda_graphed_trace_equals_eager(card_grids, grid):
    """Calls 3-5 replay (the residual and kd-tree grids, whose set-ups
    read the device back: all eager) and each equals the eager trace of
    its starts, field by field."""
    g = dataclasses.replace(card_grids[grid])
    table = tiu.build_trace_table(g, FIELDS)
    starts = [_starts("cuda", 1000, seed) for seed in range(5)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [_trace(g, y0, table) for y0 in starts]
        torch.cuda.synchronize()
    eager = grid in ("residual", "kdtree")
    assert _counts() == ((5, 0, 0) if eager else (1, 1, 3))
    for seed, (y0, res) in enumerate(zip(starts, got, strict=True)):
        assert _equal(res, _eager(g, y0, table)), seed


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["batch", "table", "add_point_data",
                                    "reverse"])
def test_cuda_new_key_runs_eagerly(card_grids, change):
    """A new batch size or a new grid is a new key, so its first call
    runs eagerly; a second table or ``reverse``, which the set-up does
    not read, replays the key's graph.  Each equals the eager trace."""
    g = dataclasses.replace(card_grids["cand"])
    table = tiu.build_trace_table(g, FIELDS)
    y0 = _starts("cuda", 1000, 0)
    for _ in range(3):
        _trace(g, y0, table)
    kw, y1 = {}, _starts("cuda", 1000, 1)
    if change == "batch":
        y1 = y1[:999]
    elif change == "table":
        table = tiu.build_trace_table(g, FIELDS)
    elif change == "add_point_data":
        g, _ = tiu.add_point_data(g, "b", np.zeros(g.n_points), fuse=False)
        assert not ttrace._graphs_of(g)
    else:
        kw = {"reverse": True}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = _trace(g, y1, table, **kw)
    torch.cuda.synchronize()
    assert _counts() == ((1, 0, 0) if change in ("batch", "add_point_data")
                         else (0, 0, 1))
    assert _equal(got, _eager(g, y1, table, **kw))


@pytest.mark.cuda
def test_cuda_refused_capture_runs_eagerly(card_grids):
    """A set-up that syncs outside any host-read site: CUDA refuses its
    capture, so the key runs eagerly for good, on the caller's stream,
    and the graphed traces that follow are still right."""
    g = dataclasses.replace(card_grids["cand"])

    def start(y0):
        ic, found = tiu.get_cell(g, y0)
        if bool(found.any()):  # a read no host_read site marks
            ic = ic + 0
        return ic, found

    stream = torch.cuda.current_stream()
    starts = [_starts("cuda", 1000, s) for s in range(3)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for y0 in starts:
            got = ttrace._graphed_start(g, ("sync",), start, y0)
            assert torch.cuda.current_stream() == stream
            assert _equal(got, tiu.get_cell(g, y0))
    assert _counts() == (3, 0, 0)
    assert ttrace._graphs_of(g)[("sync",)].graph is None
    table = tiu.build_trace_table(g, FIELDS)
    got = [_trace(g, y0, table) for y0 in starts]
    for y0, res in zip(starts, got, strict=True):
        assert _equal(res, _eager(g, y0, table))


@pytest.mark.cuda
def test_cuda_capture_while_tracing_leaves_no_span(card_grids):
    """Every call traced, the first three included: only the eager call
    makes iu.locate and iu.icell spans (the capture ran with them off,
    and a replay makes none); each call makes its iu.trace.setup; no
    call reads the device back; the replays equal the eager traces."""
    g = dataclasses.replace(card_grids["cand"])
    table = tiu.build_trace_table(g, FIELDS)
    starts = [_starts("cuda", 2048, s) for s in range(4)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        got = [_trace(g, y0, table) for y0 in starts]
        torch.cuda.synchronize()
    rep = timing.metrics.report()
    assert _counts() == (1, 1, 2)
    assert rep["spans"]["iu.locate"]["count"] == 1
    assert rep["spans"]["iu.icell"]["count"] == 1
    assert rep["spans"]["iu.trace.setup"]["count"] == 4
    assert "iu.host_read" not in rep["spans"]
    for c in rep["entry_calls"]:
        assert not any(k.startswith("host_reads.") for k in c["counters"])
    timing.metrics.reset()
    for y0, res in zip(starts, got):
        assert _equal(res, _eager(g, y0, table))
    # replayed outside the session, the graph records no span either
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _trace(g, starts[0], table)
    assert "iu.locate" not in timing.metrics.report()["spans"]


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["trace.fused", "get_cell.walk"])
def test_cuda_walk_tolerances_not_read(card_grids, call):
    g = card_grids["cand" if call == "trace.fused" else "walk"]
    y0 = _starts("cuda", 4096, 7)
    table = tiu.build_trace_table(g, FIELDS)
    if call == "trace.fused":
        _trace(g, y0, table)
    else:
        tiu.get_cell(g, y0)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        if call == "trace.fused":
            _trace(g, y0, table)
        else:
            tiu.get_cell(g, y0)
    rep = timing.metrics.report()
    assert "host_reads.walk_tolerances" not in rep["counters"]
    assert "iu.host_read" not in rep["spans"]


@pytest.mark.cuda
def test_cuda_device_move_keeps_the_tolerances(card_grids):
    pts, cells, nbrs = meshgen.tet_box_mesh(6, 6, 6)
    for dtype in (torch.float32, torch.float64):
        host = tiu.build_grid(pts * 3.0 - 1.0, cells, nbrs, "tetra",
                              dtype=dtype, device="cpu", locate_mode="walk")
        card = host.to("cuda")
        assert card.walk_tol == host.walk_tol == walk_tolerances(
            dtype, card.rmin, card.rmax)
        assert card.to("cpu").walk_tol == host.walk_tol
