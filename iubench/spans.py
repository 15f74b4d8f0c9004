"""Reading the port's own spans and counters after a traced run: the
registry of ``interpolate_unstructured_tpu_torch/utils/timing.py``.

The port records only while a ``torch.profiler`` session runs, so after
``harness.traced`` the registry holds the profiled calls alone.  Only
what ran on the card is read: spans and entry calls whose device is a
CUDA device (device ms: of the spans the port times by events).  Each function returns None where there is nothing
to read (a CPU run, or a port without spans)."""

from __future__ import annotations

import statistics


def report():
    """The registry's report, or None when it holds no span."""
    from interpolate_unstructured_tpu_torch.utils import timing

    rep = timing.metrics.report()
    return rep if rep.get("spans") else None


def _on_card(device):
    return device is not None and device.startswith("cuda")


def _card_spans(name):
    """[(host ms, device ms or None)] of the spans ``name`` whose work
    ran on the card."""
    rep = report()
    s = rep["spans"].get(name) if rep else None
    if not s:
        return []
    return [(h, d) for h, d, dev in zip(s["host_ms"], s["device_ms"],
                                        s["device"]) if _on_card(dev)]


def median_device_ms(name):
    """Median device ms of the spans ``name`` timed on the card."""
    ms = [d for _, d in _card_spans(name) if d is not None]
    return statistics.median(ms) if ms else None


def median_host_ms(name):
    """Median host ms of the spans ``name`` whose work ran on the card."""
    spans = _card_spans(name)
    return statistics.median(h for h, _ in spans) if spans else None


def _card_calls(entry):
    """The entry calls named ``entry`` that ran on the card."""
    rep = report()
    if not rep:
        return []
    return [c for c in rep.get("entry_calls", [])
            if c["name"] == entry and _on_card(c["device"])]


def per_call(entry, prefix):
    """Mean over the card's calls of ``entry`` of the sum of the counters
    whose names start with ``prefix``."""
    calls = _card_calls(entry)
    if not calls:
        return None
    return sum(v for c in calls for k, v in c["counters"].items()
               if k.startswith(prefix)) / len(calls)


def ratio(entry, num, den):
    """Counter ``num`` over counter ``den``, each summed over the card's
    calls of ``entry``; None where ``den`` sums to 0."""
    calls = _card_calls(entry)
    n = sum(c["counters"].get(num, 0.0) for c in calls)
    d = sum(c["counters"].get(den, 0.0) for c in calls)
    return n / d if d else None
