"""Lightweight instrumentation: wall-clock scopes, counters and spans.

The reference's only observability is ``system_clock`` calls inside its
benchmark (SURVEY.md §5.1); this module gives the port the JAX
package's timer registry, with the same names and report keys.

CUDA launches return before the card has run them, so a scope that
times work on the card must wait for its outputs before it stops the
clock: pass them to ``scope(...)``'s ``sync`` argument (a tensor, a
tuple, list or dict of them, or a ``TraceResult``).  The scope then
synchronizes the CUDA device of each of those tensors; tensors on the
CPU need no wait.

Spans.  The port marks its layer boundaries with :func:`span` (the
``iu.*`` names: ``iu.interpolate_at`` > ``iu.locate`` >
``iu.locate.probe``, ``iu.integrate_along_field`` > ``iu.trace.setup``
/ ``iu.trace.loop``, ...), each device-to-host read on its hot path
with :func:`host_read`, and counts walk steps and RK iterations.
Tracing is on exactly while a ``torch.profiler`` session records
(:func:`tracing`), except while a CUDA graph is captured
(:func:`capturing`); there is no other switch.
To trace calls and read what they recorded::

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        tiu.interpolate_at(grid, r, [0])
    rep = timing.metrics.report()
    rep["spans"]["iu.locate"]["device_ms"]   # one number a span
    rep["entry_calls"][-1]["counters"]       # host_reads.*, walk.*

Off, a span site costs one :func:`tracing` check and records nothing:
no profiler range, no CUDA event, no registry entry, no counter (about
0.7 us a site on the host of an H100 machine).  On, a span opens a
``torch.profiler.record_function`` range, so it lies in the profiler's
Chrome trace on the clock of the device operations; it records its host
``perf_counter`` seconds, the device its work runs on, its parent span
and the id of its entry call (on that host about 13 us a span under a
CPU and CUDA profiler session).  Only a span opened with ``timed=True``
on a CUDA device also records two timing events on the current stream,
for its device ms (about 40 us more a span): the port times
``iu.locate`` and ``iu.icell`` so.  Nothing synchronizes or reads the
device inside a call: :meth:`Metrics.report` resolves the events and
reads the device counters.  The registry keeps the newest
``SPANS_KEPT`` spans of each name.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque

import torch

SPANS_KEPT = 4096  # spans kept a name, and entry calls a name
_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled
_capture = threading.local()  # .on: this thread captures a CUDA graph


class HostReadInCapture(RuntimeError):
    """A :func:`host_read` site was reached inside :func:`capturing`: the
    work being captured reads the device back, so a graph of it cannot
    be replayed."""


def tracing() -> bool:
    """True while a ``torch.profiler`` session records and this thread
    captures no CUDA graph (:func:`capturing`): the port's spans and
    counters are on."""
    return _profiler_enabled() and not getattr(_capture, "on", False)


@contextlib.contextmanager
def capturing():
    """Around the warm-up and the capture of a CUDA graph on this thread:
    spans and counters are off (no span event, range or counter tensor
    lands in the graph), and a :func:`host_read` site raises
    :class:`HostReadInCapture` before it reads anything."""
    outer = getattr(_capture, "on", False)
    _capture.on = True
    try:
        yield
    finally:
        _capture.on = outer


def _devices(obj, out: set) -> set:
    """The CUDA devices of every tensor in ``obj`` (nested tuples, lists
    and dicts; a ``TraceResult`` is a tuple)."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _devices(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _devices(v, out)
    return out


def block_until_ready(obj):
    """Wait until the card has written every CUDA tensor in ``obj``;
    returns ``obj``."""
    for dev in _devices(obj, set()):
        torch.cuda.synchronize(dev)
    return obj


def _total(values) -> float:
    """The sum of host numbers and 0-d tensors (read from the device)."""
    return float(sum(float(v) for v in values))


class SpanRecord:
    """One finished span: its ``name``, the enclosing span's name
    (``parent``, None at the top), the id of the entry call it ran in
    (``call``, None outside any), its host seconds, the device its work
    runs on (``"cuda:0"``, ``"cpu"``, or None where the site names
    none), and its CUDA events (None unless timed on the card)."""

    __slots__ = ("name", "parent", "call", "host_s", "device", "events")

    def __init__(self, name, parent, call, device=None):
        self.name, self.parent, self.call = name, parent, call
        self.host_s, self.events = 0.0, None
        self.device = None if device is None else str(device)

    @property
    def device_ms(self):
        """Milliseconds between the span's two events on the card (waits
        for the second), or None for a span with no events."""
        if self.events is None:
            return None
        e0, e1 = self.events
        e1.synchronize()
        return e0.elapsed_time(e1)


class _Call:
    """An entry span's call: its id, its record and the counts made
    inside it (name -> values)."""

    __slots__ = ("id", "record", "counts")

    def __init__(self, call_id, record):
        self.id, self.record, self.counts = call_id, record, defaultdict(list)


class _Span:
    """The context manager a span site gets while tracing."""

    __slots__ = ("metrics", "record", "stream", "entry", "call", "range",
                 "t0")

    def __init__(self, metrics, name, device, entry, timed):
        self.metrics, self.entry = metrics, entry
        self.record = SpanRecord(name, None, None, device)
        self.stream = (torch.cuda.current_stream(device)
                       if timed and device is not None
                       and device.type == "cuda" else None)

    def __enter__(self):
        m, rec = self.metrics, self.record
        self.range = torch.profiler.record_function(rec.name)
        self.range.__enter__()
        stack = m._stack()
        outer = stack[-1] if stack else None
        rec.parent = outer.record.name if outer else None
        self.call = outer.call if outer else None
        if self.entry and self.call is None:
            self.call = m._open_call(rec)
        rec.call = self.call.id if self.call else None
        stack.append(self)
        if self.stream is not None:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.record
        rec.host_s = time.perf_counter() - self.t0
        if rec.events is not None:
            rec.events[1].record(self.stream)
        self.metrics._stack().pop()
        self.metrics._keep(rec)
        self.range.__exit__(*exc)
        return False


class Metrics:
    """Process-wide named timers/counters with simple reporting, and the
    spans of the port's traced calls."""

    def __init__(self):
        self.times = defaultdict(float)
        self.calls = defaultdict(int)
        self.counters = defaultdict(float)
        self._local = threading.local()
        self._ids = itertools.count()
        self._init_spans()

    def _init_spans(self):
        self.spans = defaultdict(lambda: deque(maxlen=SPANS_KEPT))
        self.span_counts = defaultdict(int)
        self.entry_calls = defaultdict(lambda: deque(maxlen=SPANS_KEPT))
        self.device_counts = defaultdict(list)  # name -> 0-d tensors

    @contextlib.contextmanager
    def scope(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.times[name] += dt
            self.calls[name] += 1

    def span(self, name: str, device=None, entry: bool = False,
             timed: bool = False):
        """A span named ``name`` around a ``with`` block while tracing,
        else a shared no-op context.  ``device``: where the block's work
        runs.  ``entry``: the block is a public entry point, which opens
        a call of its own unless it runs inside another.  ``timed``: on
        a CUDA device, time the block by two events (for spans whose
        device ms is read: the events cost more than the span)."""
        if not tracing():
            return _OFF
        return _Span(self, name, device, entry, timed)

    def count(self, name: str, value: float = 1.0):
        """Add ``value`` (a number, or a 0-d tensor summed on its device
        and read in :meth:`report`) to counter ``name``, and to the
        traced call it is made in."""
        if isinstance(value, torch.Tensor):
            vals = self.device_counts[name]
            vals.append(value.detach())
            if len(vals) >= SPANS_KEPT:
                vals[:] = [torch.stack(vals).sum()]
        else:
            self.counters[name] += value
        stack = self._stack()
        if stack and stack[-1].call is not None:
            stack[-1].call.counts[name].append(value)

    def _stack(self) -> list:
        """This thread's open spans, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open_call(self, rec) -> _Call:
        call = _Call(next(self._ids), rec)
        self.entry_calls[rec.name].append(call)
        return call

    def _keep(self, rec):
        self.spans[rec.name].append(rec)
        self.span_counts[rec.name] += 1

    def records(self, name: str) -> list:
        """The kept :class:`SpanRecord` of spans ``name``, oldest first."""
        return list(self.spans.get(name, ()))

    def report(self) -> dict:
        """``times_s``, ``calls`` (scope call counts) and ``counters``; once
        spans were recorded also ``spans`` (a name's count, host ms and
        device ms of each kept span, None off the card, and the parent
        names seen, and the device of each kept span) and ``entry_calls``
        (id, name, host ms, device and counters of each kept entry call,
        oldest first).  Reads the
        device: call it outside the calls it reports."""
        counters = dict(self.counters)
        for name, vals in self.device_counts.items():
            counters[name] = counters.get(name, 0.0) + _total(vals)
        out = {
            "times_s": dict(self.times),
            "calls": dict(self.calls),
            "counters": counters,
        }
        if not self.spans:
            return out
        out["spans"] = {
            name: {
                "count": self.span_counts[name],
                "host_ms": [1e3 * r.host_s for r in recs],
                "device_ms": [r.device_ms for r in recs],
                "device": [r.device for r in recs],
                "parents": sorted({r.parent for r in recs} - {None}),
            }
            for name, recs in self.spans.items()
        }
        calls = sorted((c for q in self.entry_calls.values() for c in q),
                       key=lambda c: c.id)
        out["entry_calls"] = [
            {"id": c.id, "name": c.record.name,
             "host_ms": 1e3 * c.record.host_s,
             "device": c.record.device,
             "counters": {k: _total(v) for k, v in c.counts.items()}}
            for c in calls
        ]
        return out

    def dump(self, file=None):
        print(json.dumps(self.report(), indent=2, sort_keys=True), file=file)

    def reset(self):
        self.times.clear()
        self.calls.clear()
        self.counters.clear()
        self._init_spans()


metrics = Metrics()


span = metrics.span  # the process-wide registry's spans


def spanned(name: str, entry: bool = False, timed: bool = False):
    """Decorator: the whole function is span ``name``; its work runs on
    the device of its first argument (a grid or a tensor)."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with span(name, getattr(args[0], "device", None), entry, timed):
                return f(*args, **kwargs)

        return wrapper

    return deco


def host_read(site: str, *tensors):
    """A device-to-host read on the hot path, at ``site``: while tracing,
    an ``iu.host_read`` span around the ``with`` block, and counter
    ``host_reads.<site>`` counts each CUDA tensor among ``tensors`` (the
    values the block reads back).  Inside :func:`capturing` it raises
    :class:`HostReadInCapture`."""
    if getattr(_capture, "on", False):
        raise HostReadInCapture(site)
    if not tracing():
        return _OFF
    n = sum(isinstance(t, torch.Tensor) and t.device.type == "cuda"
            for t in tensors)
    if n:
        metrics.count(f"host_reads.{site}", n)
    return span("iu.host_read")


def env_ticker(env_var: str, label: str):
    """Opt-in section timer for host-side build phases.

    Returns ``tick(tag)`` printing per-section wall-clock when
    ``env_var`` is set in the environment, else a no-op — used by the
    candidate-table builder (enable with ``IU_BUILD_PROFILE=1``)."""
    if not os.environ.get(env_var):
        return lambda tag: None
    state = {"t": time.perf_counter()}

    def tick(tag: str):
        now = time.perf_counter()
        print(f"  [{label}] {tag}: {now - state['t']:.1f}s", flush=True)
        state["t"] = now

    return tick


def timed(name: str):
    """Decorator: accumulate wall-clock of a function into ``metrics``."""

    def deco(f):
        def wrapper(*args, **kwargs):
            with metrics.scope(name):
                out = f(*args, **kwargs)
            return out

        wrapper.__name__ = getattr(f, "__name__", name)
        return wrapper

    return deco
