"""icell_ms: median ms of ``interpolate_at_icell`` on the cell's own
batches at the cells ``get_cell`` returned, by CUDA events (layer:
known-cell interpolation, kernel E1)."""

import statistics


def read(rec):
    ms = rec.spans.get("interpolate_at_icell")
    return statistics.median(ms) if ms else None
