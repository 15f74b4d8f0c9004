"""get_cell_ms: median ms of ``get_cell(grid, r, guess)`` on the cell's
own batches, by CUDA events around the call (layer: locate)."""

import statistics


def read(rec):
    ms = rec.spans.get("get_cell")
    return statistics.median(ms) if ms else None
