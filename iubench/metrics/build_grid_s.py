"""build_grid_s: wall seconds of ``build_grid`` with ``timings=``,
from a synchronize before it to one after it (layer: grid build)."""


def read(rec):
    return rec.build.get("build_grid_s")
