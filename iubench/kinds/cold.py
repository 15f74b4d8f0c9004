"""Cold queries: batches of uniform points, each answered by
``interpolate_scalar_at(grid, r, i_var)`` with no guess (upstream
``benchmark.f90``'s cold pass, ``bench.py``'s ``large_mesh``).

Traffic parameters: ``n_queries`` a call, ``n_batches`` made at set-up
and cycled, ``low`` / ``high`` the cube they fill (on a 2D mesh, the
square in its plane z = 0), ``variable`` the
point-data name interpolated, ``warm_calls``, and for the check
``check_calls`` (calls sampled) and ``check_queries`` (answers compared
in each).
"""

from __future__ import annotations

import torch

from iubench import fields, queries, work as counting

UNIT = "queries"


class State:
    def __init__(self, batches, i_var):
        self.batches, self.i_var, self.k = batches, i_var, 0


def setup(cell) -> State:
    t = cell.traffic
    g = fields.generator(cell.seed, "queries", cell.device)
    lo, hi = float(t["low"]), float(t["high"])
    batches = [lo + (hi - lo) * torch.rand(int(t["n_queries"]), 3,
                                           generator=g, dtype=cell.dtype,
                                           device=cell.device)
               for _ in range(int(t["n_batches"]))]
    if cell.spec.config["cell_type"] in ("triangle", "quad"):
        # upstream weights a 2D cell by its vertices in 3D (unsigned
        # areas, inverse-bilinear), which interpolates linearly only in
        # the mesh's plane: z = 0 (iubench/mesh.py)
        for b in batches:
            b[:, 2] = 0
    i_var = list(cell.spec.config["point_data"]).index(t["variable"])
    state = State(batches, i_var)
    for _ in range(int(t["warm_calls"])):
        call(cell, state)
    state.k = 0
    return state


def units(cell, state) -> int:
    return int(cell.traffic["n_queries"])


def call(cell, state):
    k = state.k
    b = k % len(state.batches)
    state.k += 1
    with cell.mark("entry"):
        out = cell.tiu.interpolate_scalar_at(cell.grid, state.batches[b],
                                             state.i_var)
    return k, b, out


def answers(cell, state, item) -> dict:
    k, b, (vals, ic, found) = item
    idx = queries.sample(cell, vals.shape[0],
                         int(cell.traffic["check_queries"]), f"check{k}")
    return {"q": state.batches[b][idx], "values": vals[idx, None],
            "cell": ic[idx], "found": found[idx]}


def judge(cell, answers) -> dict:
    return queries.judge(cell, answers, [cell.traffic["variable"]])


def control(cell, answers, dtype=None) -> list:
    return queries.control(cell, answers, [cell.traffic["variable"]], dtype)


def spans(cell, state, n) -> dict:
    """CUDA-event ms of ``get_cell`` on the cell's own batches."""
    ms = []
    for _ in range(n):
        r = state.batches[state.k % len(state.batches)]
        state.k += 1
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        cell.tiu.get_cell(cell.grid, r)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    return {"get_cell": ms}


def work(cell, state, item) -> dict:
    _, _, (vals, ic, found) = item
    return counting.query_work(cell, ic[found], n_queries=vals.shape[0],
                           n_vars=1, guess=False)
