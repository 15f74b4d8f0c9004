"""The check of traced field lines against the plain reference tracer.

Numbers compared, each with its limit in ``iubench/limits/<cell>.json``,
line by line over the sampled lines (the rules of the port's trace tests
and of its serial-oracle check):

* ``code_mismatch``: lines whose end code differs; limit 0;
* ``steps_gap``: the largest difference in stored points;
* ``curve_gap``: the largest difference of the points and of the field
  samples, up to two points before the shorter line's end (the step at a
  wall may be taken once more or once less);
* ``final_gap``: the largest distance between the last points.

The start cells and the start field show in the codes of lines that
start outside and in the first field sample.
"""

from __future__ import annotations

import torch

from . import fields
from .harness import check
from .queries import LOWER
from .reference import tracer
from .reference.locate import RefMesh


def reference(cell, answers, kw, dtype=torch.float64) -> list:
    """The reference tracer's lines from the same starts, in ``dtype``."""
    mesh = RefMesh(cell.points, cell.cells, dtype, cell.device)
    hull = tracer.hull_planes(cell.points, cell.cells, cell.neighbors, dtype,
                              cell.device)
    helix = torch.as_tensor(fields.helix(cell.points), device=cell.device)
    # the shrink rule of the configuration's dtype
    eps = 1e-8 if cell.dtype == torch.float64 else 3e-4
    out = []
    for a in answers:
        y, yf, ns, code = tracer.trace(mesh, hull, helix, a["y0"],
                                       shrink_eps=eps, **kw)
        out.append({"y0": a["y0"], "y": y, "y_field": yf, "n_steps": ns,
                    "code": code})
    return out


def compare(got, want, max_steps):
    """(code mismatches, steps gap, curve gap, final gap) of two sets of
    lines."""
    ns_g = got["n_steps"].long().clamp(1, max_steps)
    ns_w = want["n_steps"].long().clamp(1, max_steps)
    codes = int((got["code"].long() != want["code"].long()).sum())
    steps = int((got["n_steps"].long() - want["n_steps"].long()).abs().max())
    common = (torch.minimum(ns_g, ns_w) - 2).clamp_min(0)
    t = torch.arange(max_steps, device=ns_g.device)
    mask = (t[None, :] < common[:, None])[..., None]
    dy = (got["y"].double() - want["y"].double()).abs()
    df = (got["y_field"].double() - want["y_field"].double()).abs()
    curve = float(torch.where(mask, torch.maximum(dy, df), 0.0).max())
    rows = torch.arange(ns_g.shape[0], device=ns_g.device)
    last = (got["y"].double()[rows, ns_g - 1]
            - want["y"].double()[rows, ns_w - 1]).norm(dim=1)
    return codes, steps, curve, float(last.max())


def judge(cell, answers, kw) -> dict:
    ref = reference(cell, answers, kw)
    codes, steps, curve, final = 0, 0, 0.0, 0.0
    for a, r in zip(answers, ref):
        a = {k: v.to(cell.device) for k, v in a.items()}
        c, s, cv, f = compare(a, r, kw["max_steps"])
        codes, steps = codes + c, max(steps, s)
        curve, final = max(curve, cv), max(final, f)
    lim = cell.spec.limits
    return {
        "code_mismatch": check(codes, lim["code_mismatch"]),
        "steps_gap": check(steps, lim["steps_gap"]),
        "curve_gap": check(curve, lim["curve_gap"]),
        "final_gap": check(final, lim["final_gap"]),
    }


def control(cell, answers, kw, dtype=None) -> list:
    """The reference tracer in the precision below the configuration's,
    put in the program's place."""
    return reference(cell, answers, kw, dtype or LOWER[cell.dtype])
