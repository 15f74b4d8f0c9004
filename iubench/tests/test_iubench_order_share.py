"""The reader of ``ordered_query_share.query``: ``order.queries`` over
``walk.queries`` of the card's ``interpolate_at`` calls, None on an
empty registry, off the card, and for a port without the bin order
(the parent of the change that added it), whose calls count no
``order.*``; and its entry in ``BENCHMARK.json``."""

import importlib.util
import json

import pytest

from conftest import ROOT
from iubench import harness
from interpolate_unstructured_tpu_torch.utils import timing

NAME = "ordered_query_share.query"


def reader():
    return harness.load_module(ROOT / "iubench" / "metrics" / f"{NAME}.py")


@pytest.fixture(autouse=True)
def empty_registry():
    timing.metrics.reset()
    yield
    timing.metrics.reset()


def call(on_card, counts):
    rec = timing.SpanRecord("iu.interpolate_at", None, None,
                            "cuda:0" if on_card else "cpu")
    timing.metrics._keep(rec)
    c = timing.metrics._open_call(rec)
    rec.call = c.id
    for k, v in counts.items():
        c.counts[k].append(v)


def test_share_of_the_cards_calls():
    assert reader().read(None) is None
    call(True, {"walk.queries": 100, "order.calls": 1, "order.queries": 100})
    call(True, {"walk.queries": 300})  # a batch the rule turned down
    call(False, {"walk.queries": 50, "order.queries": 50})  # off the card
    assert reader().read(None) == 0.25


def test_nothing_off_the_card():
    call(False, {"walk.queries": 50, "order.queries": 50})
    assert reader().read(None) is None


def test_nothing_from_a_port_without_the_bin_order(monkeypatch):
    call(True, {"walk.queries": 100})
    real = importlib.util.find_spec

    def find_spec(name, *a, **kw):
        if name.endswith(".ops.order_kernel"):
            return None
        return real(name, *a, **kw)

    monkeypatch.setattr(importlib.util, "find_spec", find_spec)
    assert reader().read(None) is None


def test_benchmark_entry():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    routing = [x["layer"] for x in bench["per_layer"]
               if x["name"] == "host_reads_per_call.query"]
    assert m == {"name": NAME, "unit": "ratio", "better": "higher",
                 "source": "program_span", "layer": routing[0],
                 "moves": "queries_per_s",
                 "workloads": ["tet998k_f64_walk.particles"]}
