"""trace_iters_per_step: the port's ``trace.iterations`` over
``trace.steps``, RK iterations (rejected and boundary retries included)
a stored point, over the profiled trace calls (layer: tracer)."""

from iubench import spans


def read(rec):
    return spans.ratio("iu.integrate_along_field", "trace.iterations",
                       "trace.steps")
