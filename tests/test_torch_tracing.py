"""The port's spans and counters (``utils/timing.py``).

Off (no ``torch.profiler`` session): a span site makes no profiler
range, no CUDA event, no registry entry and no count, which the tests
hold by making ``record_function`` and ``torch.cuda.Event`` raise.  On
(a profiler session on the CPU): the same calls give the same bits, the
Chrome trace holds the ``iu.*`` span tree, each record knows its parent
and its entry call, the registry keeps the newest ``SPANS_KEPT`` spans
a name, and the trace counters equal the sums of the result.  On the
card: B3's step counter against the plain walk's steps, B3's outputs
with and without it, the host reads of a cold candidate call and of a
walk-grid call, and device times for the timed spans alone.
"""

import json

import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.ops import locate, walk_kernel
from interpolate_unstructured_tpu_torch.utils import meshgen, timing

TRACE_KW = dict(min_dx=1e-3, max_dx=0.05, max_steps=24, rtol=1e-3,
                atol=1e-3)
CALLS = ["interpolate_at.bruteforce", "interpolate_at.walk",
         "interpolate_at.cand", "interpolate_scalar_at.cand", "get_cell.cold",
         "get_cell.warm", "trace.fused", "trace.generic"]


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


def _grids(device, n=5):
    """Brute-force, walk and candidate grids of a tet box with a linear
    field and a helix, and the candidate grid in float64 (the generic
    tracer's)."""
    pts, cells, nbrs = meshgen.tet_box_mesh(n, n, n)
    pd = {"a": pts[:, 0] + 2 * pts[:, 1] - pts[:, 2],
          "hx": -(pts[:, 1] - 0.5), "hy": pts[:, 0] - 0.5,
          "hz": 0.25 + 0 * pts[:, 0]}

    def build(dtype=torch.float32, **kw):
        return tiu.build_grid(pts, cells, nbrs, "tetra", point_data=pd,
                              dtype=dtype, device=device, **kw)

    return {
        "bruteforce": build(locate_mode="bruteforce"),
        "walk": build(config=tiu.IUConfig(use_candidate_bins=False),
                      locate_mode="walk"),
        "cand": build(locate_mode="walk"),
        "cand64": build(torch.float64, locate_mode="walk"),
    }


def _calls(grids, device):
    """Every entry point the tests trace, as name -> thunk."""
    g = torch.Generator().manual_seed(3)
    r = (torch.rand(700, 3, generator=g) * 1.2 - 0.1).to(device)
    y0 = (0.3 + 0.4 * torch.rand(12, 3, generator=g)).to(device)
    guess = torch.full((700,), 7, dtype=torch.int32, device=device)

    def trace(grid):
        return lambda: tiu.integrate_along_field(grid, y0, (1, 2, 3),
                                                 **TRACE_KW)

    calls = {
        "interpolate_at.bruteforce":
            lambda: tiu.interpolate_at(grids["bruteforce"], r, [0]),
        "interpolate_at.walk":
            lambda: tiu.interpolate_at(grids["walk"], r, [0], guess=guess),
        "interpolate_at.cand": lambda: tiu.interpolate_at(grids["cand"], r,
                                                          [0]),
        "interpolate_scalar_at.cand":
            lambda: tiu.interpolate_scalar_at(grids["cand"], r, 0),
        "get_cell.cold": lambda: tiu.get_cell(grids["walk"], r),
        "get_cell.warm": lambda: tiu.get_cell(grids["cand"], r, guess),
        "trace.fused": trace(grids["cand"]),
        "trace.generic": trace(grids["cand64"]),
    }
    assert list(calls) == CALLS
    return calls


@pytest.fixture(scope="module")
def cpu_grids():
    return _grids("cpu")


def _leaves(out):
    return list(out) if isinstance(out, tuple) else [out]


def _bits(x):
    """A tensor's bits: floats as integers of their width, so NaNs
    compare."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def _equal(a, b):
    return all(torch.equal(_bits(x), _bits(y))
               for x, y in zip(_leaves(a), _leaves(b), strict=True))


def test_off_path_records_nothing(cpu_grids, monkeypatch):
    """With no profiler running, every entry point runs with
    ``record_function`` and ``torch.cuda.Event`` raising, and leaves the
    registry empty."""

    def boom(*a, **k):
        raise AssertionError("a span site acted with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert not timing.tracing()
    for name, call in _calls(cpu_grids, "cpu").items():
        call()
    assert timing.metrics.report() == {"times_s": {}, "calls": {},
                                       "counters": {}}
    assert not timing.metrics.spans and not timing.metrics.entry_calls


@pytest.mark.parametrize("name", CALLS)
def test_traced_outputs_are_bit_equal(cpu_grids, name):
    """Under a profiler session on the CPU each call gives the bits it
    gives untraced, and records its spans."""
    call = _calls(cpu_grids, "cpu")[name]
    plain = call()
    with torch.profiler.profile():
        traced = call()
    assert _equal(plain, traced)
    assert timing.metrics.report()["spans"]


def _span_events(path):
    """The Chrome trace's ``iu.*`` ranges: [(name, start, end)]."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e["name"].startswith("iu.")]


def _inside(spans, inner, outer):
    """Some ``inner`` range lies inside an ``outer`` range."""
    outs = [(s, t) for n, s, t in spans if n == outer]
    return any(s0 <= s and t <= t0 for n, s, t in spans if n == inner
               for s0, t0 in outs)


def test_chrome_trace_holds_the_span_tree(cpu_grids, tmp_path):
    """iu.interpolate_at > iu.locate > iu.locate.walk / .probe, with
    iu.icell and iu.fill beside iu.locate; iu.integrate_along_field >
    iu.trace.setup / iu.trace.loop > iu.trace.iteration (the generic
    path) and host reads."""
    calls = _calls(cpu_grids, "cpu")
    with torch.profiler.profile() as prof:
        for name in ("interpolate_at.walk", "interpolate_at.cand",
                     "trace.fused", "trace.generic"):
            calls[name]()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = _span_events(path)
    for inner, outer in [
            ("iu.locate", "iu.interpolate_at"),
            ("iu.locate.walk", "iu.locate"),
            ("iu.locate.probe", "iu.locate"),
            ("iu.icell", "iu.interpolate_at"),
            ("iu.fill", "iu.interpolate_at"),
            ("iu.trace.setup", "iu.integrate_along_field"),
            ("iu.locate", "iu.trace.setup"),
            ("iu.icell", "iu.trace.setup"),
            ("iu.trace.loop", "iu.integrate_along_field"),
            ("iu.host_read", "iu.trace.loop"),
            ("iu.trace.iteration", "iu.trace.loop")]:
        assert _inside(spans, inner, outer), (inner, outer)
    # the fused route's location and the trace's start cells are one
    # iu.locate each, never nested in another
    locs = [(s, t) for n, s, t in spans if n == "iu.locate"]
    assert not any(a != b and b[0] <= a[0] and a[1] <= b[1]
                   for a in locs for b in locs)


def test_records_know_parent_and_call(cpu_grids):
    """Each kept record names the enclosing span and the entry call it
    ran in; an entry span opens a call of its own, and the report lists
    the calls with the counts made inside them."""
    calls = _calls(cpu_grids, "cpu")
    with torch.profiler.profile():
        calls["interpolate_at.walk"]()
        res = calls["trace.generic"]()
    m = timing.metrics
    (q,), (t,) = m.records("iu.interpolate_at"), m.records(
        "iu.integrate_along_field")
    assert (q.parent, t.parent) == (None, None) and q.call != t.call
    (loc_q, loc_t) = m.records("iu.locate")
    assert (loc_q.parent, loc_q.call) == ("iu.interpolate_at", q.call)
    assert (loc_t.parent, loc_t.call) == ("iu.trace.setup", t.call)
    (walk,) = m.records("iu.locate.walk")
    assert (walk.parent, walk.call) == ("iu.locate", q.call)
    (setup,) = m.records("iu.trace.setup")
    assert (setup.parent, setup.call) == ("iu.integrate_along_field", t.call)
    its = m.records("iu.trace.iteration")
    assert its and all(r.parent == "iu.trace.loop" and r.call == t.call
                       for r in its)
    assert all(r.device_ms is None for r in its)  # CPU work: no events
    assert {r.device for r in (q, t, loc_q, loc_t, walk, *its)} == {"cpu"}
    rep = m.report()
    assert rep["spans"]["iu.locate"]["parents"] == ["iu.interpolate_at",
                                                   "iu.trace.setup"]
    assert rep["spans"]["iu.locate"]["count"] == 2
    ids = [c["id"] for c in rep["entry_calls"]]
    assert ids == [q.call, t.call]
    tc = rep["entry_calls"][1]["counters"]
    assert tc["trace.lines"] == res.n_steps.shape[0]
    assert tc["trace.iterations"] == int(res.n_iterations.sum())
    assert tc["trace.steps"] == int(res.n_steps.clamp_max(
        TRACE_KW["max_steps"]).sum())
    assert tc["trace.iterations"] >= tc["trace.steps"] - tc["trace.lines"]
    qc = rep["entry_calls"][0]["counters"]
    assert qc["walk.queries"] == 700 and qc["walk.steps"] >= 1
    # host reads count CUDA tensors only
    assert not any(k.startswith("host_reads.") for k in {**qc, **tc})
    assert rep["counters"]["walk.steps"] == qc["walk.steps"]


def test_walk_step_counter_equals_the_plain_steps(cpu_grids):
    """The walk counter of a traced get_cell on a walk grid equals the
    steps that the plain walk's two phases report for those queries."""
    g = cpu_grids["walk"]
    r = torch.rand(3000, 3, generator=torch.Generator().manual_seed(5))
    cfg = g.config
    with torch.profiler.profile():
        tiu.get_cell(g, r)
    counted = timing.metrics.report()["counters"]["walk.steps"]
    # the plain walk's own steps, phase by phase
    p1 = min(cfg.walk_phase1_steps, cfg.max_walk_steps)
    if r.shape[0] < cfg.walk_compact_min_batch:
        p1 = 0
    steps = torch.zeros((), dtype=torch.int64)
    walk_kernel.get_cell_walk_plain(g, locate._queries(g, r), None,
                                    cfg.max_walk_steps, p1, steps)
    assert counted == int(steps) > r.shape[0] // 2


def test_registry_keeps_the_newest_spans():
    """At most SPANS_KEPT spans (and entry calls) a name are kept, the
    newest; the count covers every span."""
    m = timing.Metrics()
    n = timing.SPANS_KEPT + 5
    with torch.profiler.profile():
        for i in range(n):
            with m.span("iu.test.entry", entry=True):
                with m.span("iu.test.inner"):
                    m.count("k", 2)
    recs = m.records("iu.test.inner")
    assert len(recs) == timing.SPANS_KEPT
    assert len(m.records("iu.test.entry")) == timing.SPANS_KEPT
    assert recs[-1].call == n - 1 and recs[0].call == 5
    rep = m.report()
    assert rep["spans"]["iu.test.inner"]["count"] == n
    assert len(rep["entry_calls"]) == timing.SPANS_KEPT
    assert rep["entry_calls"][-1]["counters"] == {"k": 2.0}
    assert rep["counters"]["k"] == 2.0 * n
    m.reset()
    assert m.report() == {"times_s": {}, "calls": {}, "counters": {}}


def test_device_counts_are_summed_and_bounded():
    """A 0-d tensor count is summed with the host counts of its name in
    the report, and folded once SPANS_KEPT of them are held."""
    m = timing.Metrics()
    m.count("x", 1.5)
    for _ in range(timing.SPANS_KEPT + 3):
        m.count("x", torch.tensor(2, dtype=torch.int64))
    assert len(m.device_counts["x"]) < timing.SPANS_KEPT
    assert m.report()["counters"]["x"] == 1.5 + 2 * (timing.SPANS_KEPT + 3)


# ---- on the card ----------------------------------------------------------


@pytest.fixture(scope="module")
def card_grids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _grids(torch.device("cuda"), n=12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("warm", [False, True])
def test_cuda_walk_step_counter(card_grids, dtype, warm):
    """B3's get_cell walk with the step counter: the same outputs as
    without it, and the counter equal to the plain walk's steps on the
    same queries."""
    pts, cells, nbrs = meshgen.tet_box_mesh(12, 12, 12)
    g = tiu.build_grid(pts, cells, nbrs, "tetra", dtype=dtype,
                       config=tiu.IUConfig(use_candidate_bins=False),
                       locate_mode="walk", device="cuda")
    gen = torch.Generator().manual_seed(11)
    r = (torch.rand(200_000, 3, generator=gen, dtype=torch.float64) * 1.1
         - 0.05).to(dtype=dtype, device="cuda")
    start = None
    if warm:
        start = torch.randint(0, g.n_cells, (r.shape[0],), generator=gen,
                              dtype=torch.int32).cuda()
    args = (g, r, start, g.config.max_walk_steps, 16)
    plain_ic, plain_found = walk_kernel.get_cell_walk_cuda(*args)
    counted = torch.zeros((), dtype=torch.int64, device="cuda")
    ic, found = walk_kernel.get_cell_walk_cuda(*args, counted)
    assert torch.equal(ic, plain_ic) and torch.equal(found, plain_found)
    steps = torch.zeros((), dtype=torch.int64, device="cuda")
    walk_kernel.get_cell_walk_plain(*args, steps)
    assert int(counted) == int(steps) > 0


@pytest.mark.cuda
def test_cuda_host_reads_per_call(card_grids):
    """A cold call on a candidate grid whose rows cover every bin, a
    walk-grid call and a fused trace read nothing back: the walks take
    the tolerances the grid holds.  The timed spans (iu.locate, iu.icell) have a device
    time, the others none; every span but the host reads, and every
    entry call, names the card."""
    assert card_grids["cand"].cand_ext_covers
    calls = _calls(card_grids, "cuda")
    for name in ("interpolate_at.cand", "interpolate_at.walk"):
        calls[name]()  # builds and loads the kernels
    torch.cuda.synchronize()
    timing.metrics.reset()
    # a CPU session turns the spans on, and the timed ones time the card
    # with their own events: the profiler's device records are not needed
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        calls["interpolate_at.cand"]()
        calls["interpolate_at.walk"]()
        calls["trace.fused"]()
    rep = timing.metrics.report()
    reads = [sum(v for k, v in c["counters"].items()
                 if k.startswith("host_reads.")) for c in rep["entry_calls"]]
    assert reads == [0, 0, 0]
    for name, s in rep["spans"].items():
        if name in ("iu.locate", "iu.icell"):
            assert all(ms is not None and ms >= 0 for ms in s["device_ms"])
        else:
            assert s["device_ms"] == [None] * len(s["device_ms"]), name
        if name != "iu.host_read":
            assert all(d.startswith("cuda") for d in s["device"]), name
    assert all(c["device"].startswith("cuda") for c in rep["entry_calls"])
    assert rep["entry_calls"][1]["counters"]["walk.steps"] > 0
