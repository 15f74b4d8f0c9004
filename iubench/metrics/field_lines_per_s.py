"""field_lines_per_s: lines traced to their end in the window over the
window's seconds, every call counted; host clock over the whole
window."""


def read(rec):
    if rec.unit != "lines" or rec.window_s <= 0:
        return None
    return rec.calls * rec.units_per_call / rec.window_s
