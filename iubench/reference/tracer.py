"""Plain PyTorch reference of the field-line tracer: adaptive
Bogacki-Shampine RK23 along the unit vector of the interpolated field,
batched over lines, as upstream's iu_integrate_along_field
(m_interp_unstructured.f90:987-1217) with the two departures the port
documents (``trace.py``, ``ops/trace_kernel.py`` ``step_control``).

Per line: k1 from the field stored at the last accepted point; sub-steps
at ``anchor + 0.5 dx k1``, ``anchor + 0.75 dx k2`` and the third-order
point ``anchor + dx/9 (2 k1 + 3 k2 + 4 k3)``, each reached by a straight
walk from the previous sub-step's end (the first from the anchor);
``err = sqrt(sum(((y3 - y2) / (atol + max(|y3|, |y2|) rtol))^2) / 3)``
with the embedded second-order point ``y2 = anchor + dx/24 (7 k1 + 6 k2
+ 8 k3 + 3 k4)``; accept when ``err <= 1`` or ``dx < 2 min_dx``; then
``dx *= min(growth, 0.8 err^(-1/3))`` clamped to [min_dx, max_dx], with
growth 1 when a step was rejected (or failed) at this or the previous
iteration, else 2.  A walk that leaves the domain fails the iteration:
``dx = min((1 - eps) |r_p - anchor|, 0.75 dx)``, ``r_p`` where the first
failing walk left, and the line ends with code -1 once that is below
``min_dx`` (upstream has no 0.75 cap, and walks every sub-step from the
anchor; ``eps`` is upstream's 1e-8 for a float64 grid and 3e-4 for a
float32 one).  A line whose buffer fills reports ``max_steps + 1``
points.

The field at a point is the mesh's vertex data interpolated in the cell
that :class:`~iubench.reference.locate.RefMesh` finds.  The domain must
be convex: a walk leaves it exactly where its segment crosses one of the
planes of the boundary faces, which is where a neighbor walk leaves it.
"""

from __future__ import annotations

import torch

from .locate import RefMesh

# vertices of face k of a tet: k, k+1, k+2 (cyclic); the fourth is
# the one opposite
_FACE = tuple(tuple((k + j) % 4 for j in range(3)) for k in range(4))


def hull_planes(points, cells, neighbors, dtype, device):
    """(normals (F, 3), offsets (F,)) of the distinct planes of the
    boundary faces, outward; raises if some point lies outside one (the
    domain is not convex)."""
    p = torch.as_tensor(points, dtype=torch.float64, device=device)
    c = torch.as_tensor(cells, dtype=torch.int64, device=device)
    nb = torch.as_tensor(neighbors, device=device)
    ns, offs = [], []
    for k, (i0, i1, i2) in enumerate(_FACE):
        sel = nb[:, k] < 0
        v = p[c[sel]]
        n = torch.linalg.cross(v[:, i1] - v[:, i0], v[:, i2] - v[:, i0])
        n = n / n.norm(dim=1, keepdim=True)
        opp = v[:, (k + 3) % 4]
        off = (n * v[:, i0]).sum(1)
        flip = torch.where((n * opp).sum(1) > off, -1.0, 1.0)
        ns.append(n * flip[:, None])
        offs.append(off * flip)
    n, off = torch.cat(ns), torch.cat(offs)
    key = torch.cat([n, off[:, None]], 1)
    key = torch.unique(torch.round(key * 1e9) / 1e9, dim=0)
    n, off = key[:, :3], key[:, 3]
    if float(((p @ n.T) - off).max()) > 1e-9:
        raise ValueError("the reference tracer needs a convex domain")
    return n.to(dtype), off.to(dtype)


def _unit(f):
    return f / f.norm(dim=1, keepdim=True)


def trace(mesh: RefMesh, hull, field, y0, *, min_dx, max_dx, max_steps,
          rtol, atol, shrink_eps, max_iterations=None):
    """Trace lines from y0 (B, 3) through the vertex field (P, 3).

    Returns (y (B, max_steps, 3), y_field (B, max_steps, 3), n_steps
    (B,) int64, code (B,) int64) in the mesh's dtype: code -1 where a
    line left the domain, -2 where it had not ended."""
    dt, dev = mesh.dtype, mesh.device
    if max_iterations is None:
        max_iterations = 50 * max_steps + 1000
    hn, hoff = hull
    field = torch.as_tensor(field, device=dev).to(dt)
    y0 = torch.as_tensor(y0, device=dev).to(dt)
    b = y0.shape[0]
    rows = torch.arange(b, device=dev)
    y = torch.zeros(b, max_steps, 3, dtype=dt, device=dev)
    yf = torch.zeros_like(y)
    n_steps = torch.ones(b, dtype=torch.int64, device=dev)
    y[:, 0] = y0
    cell, inside = mesh.locate(y0)
    found = inside >= 0
    yf[:, 0] = torch.where(found[:, None],
                           mesh.interpolate(y0, cell, field), 0.0)
    code = torch.where(found, -2, -1)
    done = ~found
    dx = torch.full((b,), max_dx, dtype=dt, device=dev)
    last_rejected = torch.full((b,), -100, dtype=torch.int64, device=dev)

    def walk(start, target):
        """(arrived, exit point) of the straight walk start -> target."""
        d = target - start
        arrived = ((target @ hn.T) - hoff <= 0).all(1)
        along = d @ hn.T
        t = torch.where(along > 0, (hoff - start @ hn.T) / along,
                        torch.inf).min(1).values
        return arrived, start + t.clamp(0, 1)[:, None] * d

    def field_at(r):
        c, _ = mesh.locate(r)
        return mesh.interpolate(r, c, field)

    for it in range(max_iterations):
        act = ~done
        if not bool(act.any()):
            break
        last = (n_steps - 1).clamp_max(max_steps - 1)
        anchor = y[rows, last]
        k1 = _unit(yf[rows, last])
        ok = act.clone()
        r_p = anchor.clone()
        ks = [k1]
        start = anchor
        for s in range(3):
            if s < 2:
                tgt = anchor + ((0.5, 0.75)[s] * dx)[:, None] * ks[-1]
            else:
                tgt = anchor + (dx / 9)[:, None] * (2 * k1 + 3 * ks[1]
                                                    + 4 * ks[2])
            arrived, exit_pt = walk(start, tgt)
            r_p = torch.where((ok & ~arrived)[:, None], exit_pt, r_p)
            ok = ok & arrived
            start = torch.where(ok[:, None], tgt, anchor)
            f = field_at(start)
            ks.append(_unit(f))
        ys3, f4 = tgt, f
        failed = act & ~ok
        y2 = anchor + (dx / 24)[:, None] * (7 * k1 + 6 * ks[1] + 8 * ks[2]
                                            + 3 * ks[3])
        sc = atol + torch.maximum(ys3.abs(), y2.abs()) * rtol
        err = (((ys3 - y2) / sc) ** 2).sum(1).div(3).sqrt()
        accept = ok & ((err <= 1) | (dx < 2 * min_dx))
        full = accept & (n_steps + 1 > max_steps)
        store = accept & ~full
        n_steps = torch.where(full, max_steps + 1,
                              torch.where(store, n_steps + 1, n_steps))
        slot = n_steps - 1
        y[rows[store], slot[store]] = ys3[store]
        yf[rows[store], slot[store]] = f4[store]
        last_rejected = torch.where(act & (failed | ~accept), it,
                                    last_rejected)
        growth = torch.where(last_rejected > it - 2, 1.0, 2.0).to(dt)
        factor = torch.minimum(growth, 0.8 * (1 / err) ** (1 / 3))
        dx_ok = (dx * factor).clamp(min_dx, max_dx)
        dx_fail = torch.minimum((1 - shrink_eps)
                                * (r_p - anchor).norm(dim=1), 0.75 * dx)
        hit = failed & (dx_fail < min_dx)
        dx = torch.where(act, torch.where(failed, dx_fail, dx_ok), dx)
        code = torch.where(hit, -1, code)
        done = done | hit | full
    return y, yf, n_steps, code
