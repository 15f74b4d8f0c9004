"""setup_s: seconds from the harness's first line to the window's start
(mesh and data from the seed, the kernel library's load or build,
``build_grid``, the traffic's inputs and warm-up); host clock."""


def read(rec):
    return rec.setup_s
