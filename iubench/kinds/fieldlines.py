"""Field lines: bundles of lines traced through a helical field by
``integrate_along_field`` (upstream ``test_trace_field.f90``;
``bench.py``'s ``trace_at_scale``).

Set-up adds the helix (-(y - 0.5), x - 0.5, 0.25) to the grid as three
unfused point-data variables and builds the trace table once; each call
traces one bundle of ``n_lines`` lines, cycled from ``n_sets`` bundles
made from the seed.  A bundle's starts are uniform in [low, high]^3 and
stratified: the cube is cut into ``n_lines`` boxes and each holds one
start, jittered within it and shuffled in order by the seed.  A call
lasts as long as its longest line, so with plain uniform starts the
seed would change the work; stratified, every seed traces the same
spread of line lengths.

Traffic parameters: ``n_lines``, ``n_sets``, ``low``, ``high``,
``min_dx``, ``max_dx``, ``max_steps``, ``rtol``, ``atol``,
``warm_calls``, ``check_calls``, ``check_lines``.
"""

from __future__ import annotations

import torch

from iubench import fields, queries, traces

UNIT = "lines"
HELIX = ("helix_x", "helix_y", "helix_z")


class State:
    def __init__(self, starts, i_field, table):
        self.starts, self.i_field, self.table, self.k = starts, i_field, \
            table, 0


def trace_kw(t) -> dict:
    return {k: (int(t[k]) if k == "max_steps" else float(t[k]))
            for k in ("min_dx", "max_dx", "max_steps", "rtol", "atol")}


def box_counts(n: int) -> tuple:
    """(a, b, c) with a * b * c = n, as near to a cube as n allows."""
    best = (1, 1, n)
    a = 1
    while a ** 3 <= n:
        for b in range(a, n // a + 1):
            c, r = divmod(n, a * b)
            if c < b:
                break
            if r == 0 and c / a < best[2] / best[0]:
                best = (a, b, c)
        a += 1
    return best


def stratified(cell, n: int, lo: float, hi: float, g):
    """n starts in [lo, hi]^3, one in each box of an a x b x c cut,
    jittered and shuffled by ``g``."""
    dev = cell.device
    counts = torch.tensor(box_counts(n), device=dev)
    i = torch.arange(n, device=dev)
    box = torch.stack([i // (counts[1] * counts[2]),
                       (i // counts[2]) % counts[1], i % counts[2]], 1)
    u = torch.rand(n, 3, generator=g, dtype=torch.float64, device=dev)
    p = lo + (hi - lo) * (box + u) / counts
    order = torch.randperm(n, generator=g, device=dev)
    return p[order].to(cell.dtype)


def setup(cell) -> State:
    t = cell.traffic
    tiu = cell.tiu
    h = fields.helix(cell.points)
    i_field = []
    for j, name in enumerate(HELIX):
        cell.grid, i_var = tiu.add_point_data(cell.grid, name, h[:, j],
                                              fuse=False)
        i_field.append(i_var)
    i_field = tuple(i_field)
    table = tiu.build_trace_table(cell.grid, i_field)
    g = fields.generator(cell.seed, "lines", cell.device)
    starts = [stratified(cell, int(t["n_lines"]), float(t["low"]),
                         float(t["high"]), g)
              for _ in range(int(t["n_sets"]))]
    state = State(starts, i_field, table)
    for _ in range(int(t["warm_calls"])):
        call(cell, state)
    state.k = 0
    return state


def units(cell, state) -> int:
    return int(cell.traffic["n_lines"])


def call(cell, state):
    k = state.k
    b = k % len(state.starts)
    state.k += 1
    with cell.mark("entry"):
        res = cell.tiu.integrate_along_field(
            cell.grid, state.starts[b], state.i_field,
            trace_table=state.table, **trace_kw(cell.traffic))
    return k, b, res


def answers(cell, state, item) -> dict:
    k, b, res = item
    n = state.starts[b].shape[0]
    idx = queries.sample(cell, n, int(cell.traffic["check_lines"]),
                         f"check{k}")
    return {"y0": state.starts[b][idx], "y": res.y[idx],
            "y_field": res.y_field[idx], "n_steps": res.n_steps[idx],
            "code": res.boundary_material[idx]}


def judge(cell, answers) -> dict:
    return traces.judge(cell, answers, trace_kw(cell.traffic))


def control(cell, answers, dtype=None) -> list:
    return traces.control(cell, answers, trace_kw(cell.traffic), dtype)


def spans(cell, state, n) -> dict:
    return {}


def work(cell, state, item):
    return None
