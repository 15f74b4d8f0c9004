"""ordered_query_share.query: the port's ``order.queries`` over
``walk.queries``, the share of B3's walked queries that the entry took in
bin order (``ops/order_kernel.py``), over the profiled ``interpolate_at``
calls (layer: entry and routing).  Nothing where the port has no bin
order."""

import importlib.util

from iubench import spans


def read(rec):
    if importlib.util.find_spec(
            "interpolate_unstructured_tpu_torch.ops.order_kernel") is None:
        return None
    return spans.ratio("iu.interpolate_at", "order.queries", "walk.queries")
