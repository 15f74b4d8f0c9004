"""host_reads_per_call.trace: device-to-host reads (the port's
``host_reads.*`` counters) a profiled ``integrate_along_field`` call
(layer: entry and routing)."""

from iubench import spans


def read(rec):
    return spans.per_call("iu.integrate_along_field", "host_reads.")
