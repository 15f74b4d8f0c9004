"""trace_call_ms_p95: the 95th percentile over every call in the window
of one trace call, from its issue to its last device operation: CUDA
events the benchmark records on the card's clock.  Apart from
``call_ms_p95`` because a trace call's host share makes it spread
wider than a query call."""

import statistics


def read(rec):
    if len(rec.call_ms) < 20:
        return None
    return statistics.quantiles(rec.call_ms, n=20)[18]
