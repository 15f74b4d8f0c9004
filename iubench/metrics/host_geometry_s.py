"""host_geometry_s: ``build_grid``'s own ``timings["host_geometry_s"]``,
the float64 host geometry (layer: grid build)."""


def read(rec):
    return rec.build.get("host_geometry_s")
