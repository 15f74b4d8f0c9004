"""query_roofline: 100 x the least time of one call's work
(``iubench/work.py``) over the device-busy time of the operations the
call of the system under test launched (profiler; the benchmark's own
advance left out)."""


def read(rec):
    p, w = rec.profile, rec.work
    if rec.unit != "queries" or not p or not w or not p["n_entries"]:
        return None
    per_call = p["entry_busy_s"] / p["n_entries"]
    if per_call <= 0:
        return None
    return 100.0 * w["least_s"] / per_call
