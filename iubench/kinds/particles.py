"""Particle steps: every particle moves, then the field is interpolated at
every particle with last step's cells as guesses (upstream
``benchmark.f90``'s warm step, repeated as a particle tracker runs it).

Step ``k`` puts particle ``i`` at ``fold(r0_i + k dt v_i)``: the
straight path folded back at the walls of the cube [low, high]^3 in
closed form, so particles stay inside and every step is the same
displacement of about ``dt |v|``.  The advance is the benchmark's own
code (outside the entry range when tracing); the call then runs
``interpolate_at(grid, r, variables, guess=previous cells)``.

Traffic parameters: ``n_particles``, ``low`` / ``high``, ``dt``,
``variables`` (point-data names), ``warm_calls``, ``check_calls``,
``check_queries``.
"""

from __future__ import annotations

import torch

from iubench import fields, queries, work as counting

UNIT = "queries"


class State:
    def __init__(self, r0, v, var_ids):
        # r0 - low, so that a step's path is one add
        self.r0_lo, self.v, self.var_ids = r0, v, var_ids
        self.guess, self.k = None, 0


def positions(cell, state, k: int):
    """Step k's positions, ``lo + L - |((r0 - lo + k dt v) mod 2L) - L|``
    with ``L = high - low``: the path reflected at both walls, in five
    passes over the particles."""
    t = cell.traffic
    lo, span = float(t["low"]), float(t["high"]) - float(t["low"])
    x = torch.add(state.r0_lo, state.v, alpha=k * float(t["dt"]))
    torch.remainder(x, 2 * span, out=x)
    return torch.rsub(x.sub_(span).abs_(), lo + span)


def setup(cell) -> State:
    t = cell.traffic
    g = fields.generator(cell.seed, "particles", cell.device)
    n = int(t["n_particles"])
    lo, hi = float(t["low"]), float(t["high"])
    r0 = lo + (hi - lo) * torch.rand(n, 3, generator=g, dtype=cell.dtype,
                                     device=cell.device)
    v = torch.rand(n, 3, generator=g, dtype=cell.dtype, device=cell.device)
    names = list(cell.spec.config["point_data"])
    var_ids = [names.index(x) for x in t["variables"]]
    state = State(r0 - lo, v, var_ids)
    # the cold pass gives the first guesses
    _, state.guess, _ = cell.tiu.interpolate_at(cell.grid, r0, var_ids)
    state.k = 1
    for _ in range(int(t["warm_calls"])):
        call(cell, state)
    return state


def units(cell, state) -> int:
    return int(cell.traffic["n_particles"])


def call(cell, state):
    k = state.k
    state.k += 1
    with cell.mark("advance"):
        r = positions(cell, state, k)
    with cell.mark("entry"):
        out = cell.tiu.interpolate_at(cell.grid, r, state.var_ids,
                                      guess=state.guess)
    state.guess = out[1]
    return k, out


def answers(cell, state, item) -> dict:
    k, (vals, ic, found) = item
    idx = queries.sample(cell, vals.shape[0],
                         int(cell.traffic["check_queries"]), f"check{k}")
    r = positions(cell, state, k)
    return {"q": r[idx], "values": vals[idx], "cell": ic[idx],
            "found": found[idx]}


def judge(cell, answers) -> dict:
    return queries.judge(cell, answers, cell.traffic["variables"])


def control(cell, answers, dtype=None) -> list:
    return queries.control(cell, answers, cell.traffic["variables"], dtype)


def spans(cell, state, n) -> dict:
    """CUDA-event ms of ``get_cell`` (with the guesses) and of
    ``interpolate_at_icell`` at the cells it returned, step by step."""
    gc, ii = [], []
    for _ in range(n):
        r = positions(cell, state, state.k)
        state.k += 1
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        ic, _ = cell.tiu.get_cell(cell.grid, r, state.guess)
        ev[1].record()
        cell.tiu.interpolate_at_icell(cell.grid, r, state.var_ids, ic)
        ev[2].record()
        ev[2].synchronize()
        state.guess = ic
        gc.append(ev[0].elapsed_time(ev[1]))
        ii.append(ev[1].elapsed_time(ev[2]))
    return {"get_cell": gc, "interpolate_at_icell": ii}


def work(cell, state, item) -> dict:
    _, (vals, ic, found) = item
    return counting.query_work(cell, ic[found], n_queries=vals.shape[0],
                               n_vars=vals.shape[1], guess=True)
