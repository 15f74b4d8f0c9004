"""Reading a ``torch.profiler`` trace (Chrome trace JSON) of a stretch of
calls.

The harness wraps the stretch in ``record_function("iubench.window")``
and each call of the system under test in
``record_function("iubench.entry")``.  A device operation (kernel,
copy, memset) belongs to a call when the host launched it (its runtime
event, matched by correlation id) inside that call's entry range; the
benchmark's own work between calls (the particle advance) is outside
every entry range and so is left out of the entry's busy time.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW, ENTRY = "iubench.window", "iubench.entry"
TOP = 10


def union(intervals):
    """[(start, end)] merged, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def length(merged):
    return sum(e - s for s, e in merged)


def read(path):
    """Summary of the traced stretch, seconds throughout:
    ``window_s``, ``busy_s`` (union of device operations in the window),
    ``entry_busy_s`` (union of those launched inside an entry range),
    ``n_entries``, ``device_ops`` and ``idle_gaps`` (top lists of
    [name, seconds]); None when the trace holds no window range."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    windows = [e for e in host if e["name"] == WINDOW]
    if not windows:
        return None
    w = windows[0]
    w0, w1 = w["ts"], w["ts"] + w["dur"]
    entries = sorted((e["ts"], e["ts"] + e["dur"]) for e in host
                     if e["name"] == ENTRY and w0 <= e["ts"] <= w1)
    starts = [s for s, _ in entries]
    launch = {e["args"]["correlation"]: e["ts"] for e in host
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}

    def in_entry(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= entries[i][1]

    dev, dev_entry = [], []
    by_name = defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        dev.append((s, t))
        by_name[e["name"][:160]] += (t - s) * 1e-6
        ts = launch.get(e.get("args", {}).get("correlation"))
        if ts is not None and in_entry(ts):
            dev_entry.append((s, t))
    busy = union(dev)
    gaps = [(a[1], b[0]) for a, b in zip([[w0, w0]] + busy, busy + [[w1, w1]])
            if b[0] > a[1]]
    main = [e for e in host if e.get("tid") == w.get("tid")
            and e["name"] != WINDOW]
    main.sort(key=lambda e: e["ts"])
    main_ts = [e["ts"] for e in main]
    gap_names = defaultdict(float)
    for s, t in gaps:
        mid = 0.5 * (s + t)
        i = bisect.bisect_right(main_ts, mid)
        cover = [e for e in main[max(0, i - 400): i]
                 if e["ts"] + e["dur"] >= mid]
        name = min(cover, key=lambda e: e["dur"])["name"] if cover else "host"
        gap_names[name[:160]] += (t - s) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": length(busy) * 1e-6,
        "entry_busy_s": length(union(dev_entry)) * 1e-6,
        "n_entries": len(entries),
        "device_ops": top(by_name),
        "idle_gaps": top(gap_names),
    }
