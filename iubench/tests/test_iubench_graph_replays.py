"""The reader of ``trace_graph_replays_per_call`` (the port's
``trace.graph_*`` counters): None on an empty registry, on calls that
count no ``trace.graph_*`` (a port without the set-up graphs) and on
calls off the card; the replays a card call otherwise; and its entry in
``BENCHMARK.json``."""

import json

import pytest

from conftest import ROOT
from iubench import harness
from interpolate_unstructured_tpu_torch.utils import timing

NAME = "trace_graph_replays_per_call"
ENTRY = "iu.integrate_along_field"


@pytest.fixture(autouse=True)
def empty_registry():
    timing.metrics.reset()
    yield
    timing.metrics.reset()


def read():
    return harness.load_module(
        ROOT / "iubench" / "metrics" / f"{NAME}.py").read(None)


def call(on_card, counts):
    """An entry call with the counts made in it, on the card or off it."""
    rec = timing.SpanRecord(ENTRY, None, None, "cuda:0" if on_card else "cpu")
    timing.metrics._keep(rec)
    c = timing.metrics._open_call(rec)
    rec.call = c.id
    for k, v in counts.items():
        c.counts[k].append(v)


@pytest.mark.parametrize("calls, want", [
    ([], None),
    ([(True, {"trace.lines": 16, "host_reads.walk_tolerances": 2})] * 3,
     None),
    ([(False, {"trace.graph_replays": 1})] * 2, None),
    ([(True, {"trace.graph_replays": 1})] * 4, 1.0),
    ([(True, {"trace.graph_eager": 1}), (True, {"trace.graph_captures": 1}),
      (True, {"trace.graph_replays": 1}), (True, {"trace.graph_replays": 1}),
      (False, {"trace.graph_replays": 1})], 0.5),
    ([(True, {"trace.graph_eager": 1})] * 2, 0.0),
], ids=["empty", "no_graphs", "off_card", "replays", "mixed", "eager"])
def test_reader(calls, want):
    for on_card, counts in calls:
        call(on_card, counts)
    got = read()
    assert got == (None if want is None else pytest.approx(want))


def test_benchmark_entry():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert bench["per_layer"][-1] is m
    tracer = [x["layer"] for x in bench["per_layer"]
              if x["name"] == "trace_setup_ms"]
    assert m == {"name": NAME, "unit": "calls", "better": "higher",
                 "source": "program_span", "layer": tracer[0],
                 "moves": "field_lines_per_s",
                 "workloads": ["tet998k_f32.fieldlines"]}
