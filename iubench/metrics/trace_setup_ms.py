"""trace_setup_ms: median host ms of the port's own ``iu.trace.setup``
spans (start cells, start field, tolerances and buffers, up to B4's
launch) in the profiled trace calls (layer: tracer)."""

from iubench import spans


def read(rec):
    return spans.median_host_ms("iu.trace.setup")
