"""call_ms_p95: the 95th percentile over every call in the window of one
call of the cell's entry, from its issue to its last device operation:
CUDA events the benchmark records on the card's clock."""

import statistics


def read(rec):
    if len(rec.call_ms) < 20:
        return None
    return statistics.quantiles(rec.call_ms, n=20)[18]
