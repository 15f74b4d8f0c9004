"""The readers of the port's own spans and counters (``iubench/spans.py``
and the metrics that use it): None on an empty registry, the right
value on a registry filled by hand, nothing from spans that ran off the
card; on the card, a traced run of each cell reports every per-layer
metric that lists it."""

import json

import pytest

from conftest import ROOT
from iubench import harness
from interpolate_unstructured_tpu_torch.utils import timing

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
READERS = ["locate_span_ms", "icell_span_ms", "trace_setup_ms",
           "host_reads_per_call.query", "host_reads_per_call.trace",
           "walk_steps_per_query", "trace_iters_per_step"]


def reader(name):
    return harness.load_module(ROOT / "iubench" / "metrics" / f"{name}.py")


@pytest.fixture(autouse=True)
def empty_registry():
    timing.metrics.reset()
    yield
    timing.metrics.reset()


class Event:
    """A stand-in for a CUDA timing event at ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def span(name, host_ms, device_ms, on_card=True):
    """A finished span kept in the registry, on the card or off it;
    ``device_ms`` None: one not timed by events."""
    rec = timing.SpanRecord(name, None, None, "cuda:0" if on_card else "cpu")
    rec.host_s = host_ms / 1e3
    if device_ms is not None:
        rec.events = (Event(1.0), Event(1.0 + device_ms))
    timing.metrics._keep(rec)
    return rec


def call(name, on_card, counts, host_ms=5.0):
    """An entry call with the counts made in it."""
    c = timing.metrics._open_call(span(name, host_ms, None, on_card))
    c.record.call = c.id
    for k, v in counts.items():
        c.counts[k].append(v)
    return c


def fill():
    """Calls of both entries, on the card and off it."""
    for ms in (2.0, 4.0, 3.0):
        span("iu.locate", 10.0, ms)
    span("iu.locate", 10.0, None)  # not timed: no device ms
    span("iu.locate", 10.0, 9.0, on_card=False)  # off the card: not read
    span("iu.icell", 1.0, 1.5)
    span("iu.icell", 1.0, 1.25)
    for host in (0.5, 0.9, 0.7, 0.6):
        span("iu.trace.setup", host, None)
    span("iu.trace.setup", 99.0, None, on_card=False)
    call("iu.interpolate_at", True, {"host_reads.walk_tolerances": 2,
                                    "walk.queries": 100, "walk.steps": 250})
    call("iu.interpolate_at", True, {"host_reads.walk_tolerances": 2,
                                    "host_reads.warm_miss": 1,
                                    "walk.queries": 100, "walk.steps": 150})
    call("iu.interpolate_at", False, {"host_reads.x": 50,
                                     "walk.queries": 1, "walk.steps": 99})
    call("iu.integrate_along_field", True, {"host_reads.walk_tolerances": 2,
                                           "trace.iterations": 300,
                                           "trace.steps": 240})
    call("iu.integrate_along_field", True, {"host_reads.walk_tolerances": 2,
                                           "trace.iterations": 100,
                                           "trace.steps": 80})


EXPECTED = {"locate_span_ms": 3.0, "icell_span_ms": 1.375,
            "trace_setup_ms": 0.65, "host_reads_per_call.query": 2.5,
            "host_reads_per_call.trace": 2.0, "walk_steps_per_query": 2.0,
            "trace_iters_per_step": 1.25}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_from_an_empty_registry(name):
    assert reader(name).read(None) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_registry_filled_by_hand(name):
    fill()
    assert reader(name).read(None) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_skips_what_ran_off_the_card(name):
    """Spans and calls whose work ran off the card (a CPU run) give
    nothing."""
    span("iu.locate", 1.0, 1.0, on_card=False)
    span("iu.icell", 1.0, 1.0, on_card=False)
    span("iu.trace.setup", 1.0, None, on_card=False)
    call("iu.interpolate_at", False, {"host_reads.a": 1, "walk.queries": 1,
                                      "walk.steps": 1})
    call("iu.integrate_along_field", False, {"trace.iterations": 1,
                                             "trace.steps": 1})
    assert reader(name).read(None) is None


def test_every_reader_is_a_per_layer_metric_of_its_cells():
    layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        m = layer[name]
        assert m["source"] == "program_span"
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_on_the_card_reports_every_metric(card, workload):
    """A traced run of the cell on the card: every per-layer metric that
    applies to the cell has a value."""
    import subprocess
    import sys

    res = subprocess.run(
        [sys.executable, "iubench/run.py", "--workload", workload, "--seed",
         "4294967397", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    want = {m["name"] for m in harness.find_spec(workload).per_layer}
    assert want <= set(line["metrics"]), want - set(line["metrics"])
