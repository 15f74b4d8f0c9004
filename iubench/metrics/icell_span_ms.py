"""icell_span_ms: median device ms of the port's own ``iu.icell`` spans
(``interpolate_at_icell``, kernel E1) in the profiled calls (layer:
known-cell interpolation)."""

from iubench import spans


def read(rec):
    return spans.median_device_ms("iu.icell")
