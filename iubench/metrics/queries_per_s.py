"""queries_per_s: queries answered in the window over the window's
seconds, every call counted; host clock over the whole window."""


def read(rec):
    if rec.unit != "queries" or rec.window_s <= 0:
        return None
    return rec.calls * rec.units_per_call / rec.window_s
