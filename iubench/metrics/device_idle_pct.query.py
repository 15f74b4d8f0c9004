"""device_idle_pct.query: 100 x (1 - the union of device operations' time
over the wall time of the profiled stretch of calls), in cells whose
calls answer queries."""


def read(rec):
    p = rec.profile
    if rec.unit != "queries" or not p or min(p["window_s"], p["busy_s"]) <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
