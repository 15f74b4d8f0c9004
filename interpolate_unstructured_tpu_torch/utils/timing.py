"""Lightweight instrumentation: wall-clock scopes and counters.

The reference's only observability is ``system_clock`` calls inside its
benchmark (SURVEY.md §5.1); this module gives the port the JAX
package's timer registry, with the same names and report keys.

CUDA launches return before the card has run them, so a scope that
times work on the card must wait for its outputs before it stops the
clock: pass them to ``scope(...)``'s ``sync`` argument (a tensor, a
tuple, list or dict of them, or a ``TraceResult``).  The scope then
synchronizes the CUDA device of each of those tensors; tensors on the
CPU need no wait.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


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


class Metrics:
    """Process-wide named timers/counters with simple reporting."""

    def __init__(self):
        self.times = defaultdict(float)
        self.calls = defaultdict(int)
        self.counters = defaultdict(float)

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

    def count(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def report(self) -> dict:
        return {
            "times_s": dict(self.times),
            "calls": dict(self.calls),
            "counters": dict(self.counters),
        }

    def dump(self, file=None):
        print(json.dumps(self.report(), indent=2, sort_keys=True), file=file)

    def reset(self):
        self.times.clear()
        self.calls.clear()
        self.counters.clear()


metrics = Metrics()


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
