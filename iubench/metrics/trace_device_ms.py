"""trace_device_ms: device-busy ms of one trace call, the union of the
device operations it launched (profiler; layer: tracer)."""


def read(rec):
    p = rec.profile
    if rec.unit != "lines" or not p or not p["n_entries"]:
        return None
    busy = p["entry_busy_s"] / p["n_entries"]
    return 1e3 * busy if busy > 0 else None
