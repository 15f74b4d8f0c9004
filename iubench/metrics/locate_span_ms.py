"""locate_span_ms: median device ms of the port's own ``iu.locate`` spans
(``get_cell``, or the fused candidate route of a cold call) in the
profiled calls (layer: locate)."""

from iubench import spans


def read(rec):
    return spans.median_device_ms("iu.locate")
