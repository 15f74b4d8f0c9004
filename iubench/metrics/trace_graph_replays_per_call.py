"""trace_graph_replays_per_call: the fused tracer's set-up replayed as a
CUDA graph (the port's ``trace.graph_replays`` counter) a profiled
``integrate_along_field`` call (layer: tracer).  None for a port whose
calls count none of ``trace.graph_eager``, ``trace.graph_captures`` and
``trace.graph_replays``, one of which every fused call on the card with
a given trace table counts."""

from iubench import spans

ENTRY = "iu.integrate_along_field"


def read(rec):
    if not spans.per_call(ENTRY, "trace.graph_"):
        return None
    return spans.per_call(ENTRY, "trace.graph_replays")
