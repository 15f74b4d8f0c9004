"""walk_steps_per_query: the port's ``walk.steps`` over ``walk.queries``,
B3's get_cell walk steps (both phases) a walked query, over the
profiled ``interpolate_at`` calls (layer: locate)."""

from iubench import spans


def read(rec):
    return spans.ratio("iu.interpolate_at", "walk.steps", "walk.queries")
