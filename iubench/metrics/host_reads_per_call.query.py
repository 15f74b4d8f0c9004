"""host_reads_per_call.query: device-to-host reads (the port's
``host_reads.*`` counters) a profiled ``interpolate_at`` call (layer:
entry and routing)."""

from iubench import spans


def read(rec):
    return spans.per_call("iu.interpolate_at", "host_reads.")
