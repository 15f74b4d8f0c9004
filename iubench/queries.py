"""The check of query answers (cell, found flag, values) against the plain
reference, shared by the query kinds.

Numbers compared, each with its limit in ``iubench/limits/<cell>.json``:

* ``found_mismatch``: queries whose found flag disagrees with the
  reference, counting only those farther than ``tie_band`` inside or
  outside every cell (on a face either answer is right); limit 0;
* ``cell_depth``: the largest distance by which a found query lies
  outside the cell the program gave for it (a face shared by two cells
  holds the query in both, so ids are judged by containment);
* ``value_gap``: the largest ``|value - reference|`` over the found
  queries, the reference interpolating the same vertex data in the cell
  it found.
"""

from __future__ import annotations

import torch

from . import fields
from .harness import check
from .reference.locate import RefMesh

LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def sample(cell, n_total: int, n: int, name: str) -> torch.Tensor:
    """``n`` distinct answer indices of ``n_total``, drawn from the seed."""
    g = fields.generator(cell.seed, name, cell.device)
    n = min(n, n_total)
    return torch.randperm(n_total, generator=g, device=cell.device)[:n]


def vertex_data(cell, names) -> torch.Tensor:
    """(P, V) float64 point data of the variables ``names``."""
    return torch.stack([torch.as_tensor(cell.data[k]) for k in names],
                       1).to(cell.device)


def judge(cell, answers, names) -> dict:
    """The three numbers over every answer in ``answers`` (dicts of q,
    values, cell, found)."""
    ref = RefMesh(cell.points, cell.cells, torch.float64, cell.device)
    data = vertex_data(cell, names)
    band = float(cell.spec.limits["tie_band"])
    n_cells = ref.cells.shape[0]
    mismatch, depth, gap = 0, 0.0, 0.0
    for a in answers:
        q = a["q"].to(cell.device, torch.float64)
        rc, inside = ref.locate(q)
        found = a["found"].to(cell.device)
        mismatch += int(((~found & (inside > band))
                         | (found & (inside < -band))).sum())
        ic = a["cell"].to(cell.device).long()
        sel = found & (inside >= -band)
        valid = (ic >= 0) & (ic < n_cells)
        if bool((sel & ~valid).any()):
            depth = float("inf")
        sel = sel & valid
        if bool(sel.any()):
            depth = max(depth, float(ref.depth(q[sel], ic[sel]).max()))
            want = ref.interpolate(q[sel], rc[sel], data)
            got = a["values"].to(cell.device, torch.float64)[sel]
            gap = max(gap, float((got - want).abs().max()))
    lim = cell.spec.limits
    return {
        "found_mismatch": check(mismatch, lim["found_mismatch"]),
        "cell_depth": check(depth, lim["cell_depth"]),
        "value_gap": check(gap, lim["value_gap"]),
    }


def control(cell, answers, names, dtype=None) -> list:
    """The reference computed in the precision below the configuration's,
    put in the program's place: its answers to the same queries."""
    dtype = dtype or LOWER[cell.dtype]
    low = RefMesh(cell.points, cell.cells, dtype, cell.device)
    data = vertex_data(cell, names)
    band = float(cell.spec.limits["tie_band"])
    out = []
    for a in answers:
        q = a["q"].to(cell.device).to(dtype)
        c, inside = low.locate(q)
        vals = low.interpolate(q, c, data)
        out.append({"q": a["q"], "values": vals.double(), "cell": c,
                    "found": inside >= -band})
    return out
