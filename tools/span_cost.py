#!/usr/bin/env python3
"""What the port's spans cost while they are on, in one benchmark cell.

    python3 tools/span_cost.py --workload tet998k_f32.cold --seed 7 --calls 100

from the root of a checkout, on a CUDA card.  Sets the cell up as
``iubench/run.py`` does, then makes three stretches of ``--calls`` calls
in this order: untraced, under ``torch.profiler`` (CPU and CUDA
activities, the port's spans and counters on, each call in the
harness's ``iubench.entry`` range), untraced.  Each call is timed by
CUDA events from its issue to its last device operation and ended by a
synchronize, as the benchmark's window times it.  Prints one JSON
line: the card and its power limit, the median call of each stretch,
the traced median over the untraced ones, and from the port's registry
each span's count and median host and device ms and the counters a
call.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def stretch(cell, state, n, traced):
    """Median ms of ``n`` calls, under the profiler when ``traced``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ms = []
    cell.tracing = traced
    ctx = (torch.profiler.profile(activities=acts) if traced
           else contextlib.nullcontext())
    with ctx:
        for _ in range(n):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            cell.spec.kind.call(cell, state)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
    cell.tracing = False
    return statistics.median(ms)


def span_summary(rep):
    """Per span name: count, median host ms, median device ms."""
    out = {}
    for name, s in rep.get("spans", {}).items():
        dev = [d for d in s["device_ms"] if d is not None]
        out[name] = {"count": s["count"],
                     "host_ms": statistics.median(s["host_ms"]),
                     "device_ms": statistics.median(dev) if dev else None}
    return out


def per_call(rep):
    """Each counter's mean over the entry calls."""
    calls = rep.get("entry_calls", [])
    names = {k for c in calls for k in c["counters"]}
    return {k: sum(c["counters"].get(k, 0.0) for c in calls) / len(calls)
            for k in sorted(names)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--calls", type=int, default=100)
    args = p.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import interpolate_unstructured_tpu_torch as tiu
    from interpolate_unstructured_tpu_torch.utils import cache, timing
    from iubench import harness, work

    cache.enable_compile_cache(ROOT / "build")
    spec = harness.find_spec(args.workload)
    cell = harness.Cell(spec, args.seed, torch.device("cuda"), tiu)
    harness.make_mesh(cell)
    harness.build(cell)
    state = spec.kind.setup(cell)
    torch.cuda.synchronize()
    timing.metrics.reset()
    first = stretch(cell, state, args.calls, False)
    traced = stretch(cell, state, args.calls, True)
    second = stretch(cell, state, args.calls, False)
    rep = timing.metrics.report()
    print(json.dumps({
        "workload": args.workload, "card": work.power_limit(),
        "calls": args.calls,
        "median_call_ms": {"untraced_1": first, "traced": traced,
                           "untraced_2": second},
        "traced_over_untraced": traced / statistics.mean((first, second)),
        "spans": span_summary(rep), "counters_per_call": per_call(rep),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
