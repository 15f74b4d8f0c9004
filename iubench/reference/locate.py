"""Plain PyTorch reference: which tetrahedron or triangle holds a point,
and the point data interpolated there.

Works from the mesh's own arrays (``points``, ``cells``), in the dtype
it is given: float64 for the reference itself, a lower precision for the
control that stands in the program's place.  It builds its own uniform
bins over the cells' bounding boxes, tests a query against every cell of
its bin and keeps the cell it lies deepest inside.  Nothing here imports
the system under test or takes a table it made.

For a simplex with vertices v0..v_d (d = 3 for a tet, 2 for a
triangle), the barycentric coordinate of vertex k is
``lam_k(q) = a_k . q - b_k``, with ``a_k = n_k / ((v_k - v_j) . n_k)``
for the normal ``n_k`` of the face opposite v_k and a vertex v_j of that
face, and ``b_k = a_k . v_j``.  The signed distance of q inside face k
is ``lam_k / |a_k|`` (``1 / |a_k|`` is the simplex's height over that
face).

A triangle mesh must be flat, in a plane z = const: its lines, normals
and bins live in x and y, and a query's z is ignored, so a value is that
of the query's projection onto the plane.  The port locates by the same
rule, its 2D face planes standing perpendicular to the mesh's plane (its
``ops/geometry.py``), but weights a cell by distances in 3D: the cold
kind puts a 2D mesh's queries in its plane.
Quads are not taken: their inverse-bilinear weights are a reference of
their own.
"""

from __future__ import annotations

import itertools
import math

import torch

# the vertices of the face opposite vertex k, a tet's and a triangle's
_OPPOSITE = {4: ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)),
             3: ((1, 2), (0, 2), (0, 1))}
BLOCK = 1 << 16  # queries per block of a locate


def _normal(v, face):
    """(C, d) normal of the face (d vertices of ``v`` (C, nv, d))."""
    e = [v[:, j] - v[:, face[0]] for j in face[1:]]
    if len(e) == 2:
        return torch.linalg.cross(e[0], e[1])
    return torch.stack([-e[0][:, 1], e[0][:, 0]], 1)


class RefMesh:
    """A tetrahedral or flat triangle mesh held as barycentric planes (or
    lines) and uniform bins."""

    def __init__(self, points, cells, dtype=torch.float64, device="cpu"):
        p = torch.as_tensor(points, dtype=torch.float64, device=device)
        c = torch.as_tensor(cells, dtype=torch.int64, device=device)
        if c.shape[1] not in _OPPOSITE:
            raise ValueError("the reference takes tetrahedra or triangles")
        self.dim = c.shape[1] - 1
        if self.dim == 2:
            if bool((p[:, 2] != p[0, 2]).any()):
                raise ValueError("a triangle mesh must lie in a plane "
                                 "z = const")
            p = p[:, :2]
        self.dtype, self.device = dtype, torch.device(device)
        self.cells = c
        p = p.to(dtype)
        v = p[c]  # (C, nv, dim)
        a, b = [], []
        for k, face in enumerate(_OPPOSITE[c.shape[1]]):
            n = _normal(v, face)
            den = ((v[:, k] - v[:, face[0]]) * n).sum(1)
            ak = n / den[:, None]
            a.append(ak)
            b.append((ak * v[:, face[0]]).sum(1))
        self.a = torch.stack(a, 1)  # (C, nv, dim)
        self.b = torch.stack(b, 1)  # (C, nv)
        self.inv_height = self.a.double().norm(dim=2)  # (C, nv)
        self._bins(v.double(), p.double())

    def _bins(self, v, p):
        """Uniform bins, about one per dim! cells (the simplices of one
        cube or square), each listing every cell whose bounding box
        touches it (padded with -1)."""
        n_cells, dim = self.cells.shape[0], self.dim
        rmin, rmax = p.min(0).values, p.max(0).values
        ext = (rmax - rmin).clamp_min(1e-300)
        nb = max(1, round((n_cells / math.factorial(dim)) ** (1 / dim)))
        self.shape = (nb,) * dim
        self.rmin, self.inv_h = rmin, nb / ext
        slack = 1e-9 * float(ext.max())
        lo = ((v.min(1).values - slack - rmin) * self.inv_h).floor().long()
        hi = ((v.max(1).values + slack - rmin) * self.inv_h).floor().long()
        lo, hi = lo.clamp(0, nb - 1), hi.clamp(0, nb - 1)
        span = hi - lo + 1
        ids, bins = [], []
        smax = span.max(0).values.tolist()
        for off in itertools.product(*(range(s) for s in smax)):
            o = torch.tensor(off, device=self.device)
            ok = (o < span).all(1)
            cell = torch.nonzero(ok).squeeze(1)
            ids.append(cell)
            bins.append(self._flat(lo[cell] + o))
        ids, bins = torch.cat(ids), torch.cat(bins)
        order = torch.argsort(bins, stable=True)
        ids, bins = ids[order], bins[order]
        count = torch.bincount(bins, minlength=nb ** dim)
        start = torch.cumsum(count, 0) - count
        width = int(count.max())
        rank = torch.arange(ids.numel(), device=self.device) - start[bins]
        table = torch.full((nb ** dim, width), -1, dtype=torch.int64,
                           device=self.device)
        table[bins, rank] = ids
        self.table = table

    def _flat(self, ijk):
        """Row-major index of the bins ``ijk`` (B, dim)."""
        out = ijk[:, 0]
        for d in range(1, self.dim):
            out = out * self.shape[d] + ijk[:, d]
        return out

    def _bin_of(self, q):
        ijk = ((q[:, :self.dim].double() - self.rmin)
               * self.inv_h).floor().long()
        ijk = torch.minimum(ijk.clamp_min(0),
                            torch.tensor(self.shape, device=q.device) - 1)
        return self._flat(ijk)

    def lam(self, q, cell):
        """(B, nv) barycentric coordinates of q (B, 3) in ``cell`` (B,)."""
        q = q[:, :self.dim].to(self.dtype)
        return (self.a[cell] * q[:, None, :]).sum(2) - self.b[cell]

    def depth(self, q, cell):
        """(B,) float64 distance by which q lies outside ``cell`` (0 when
        inside): the largest signed distance past one of its faces."""
        s = self.lam(q, cell).double() / self.inv_height[cell]
        return (-s).max(1).values.clamp_min(0)

    def locate(self, q):
        """(cell (B,) int64, inside (B,) float64): for each query the
        candidate cell it lies deepest inside, and its signed distance
        inside that cell's nearest face (negative: outside every cell)."""
        cells, inside = [], []
        for s in range(0, q.shape[0], BLOCK):
            qb = q[s: s + BLOCK]
            cand = self.table[self._bin_of(qb)]  # (b, M)
            safe = cand.clamp_min(0)
            qd = qb[:, :self.dim].to(self.dtype)
            lam = ((self.a[safe] * qd[:, None, None, :]).sum(3)
                   - self.b[safe])  # (b, M, nv)
            dist = (lam.double() / self.inv_height[safe]).min(2).values
            dist = torch.where(cand >= 0, dist, -torch.inf)
            best, arg = dist.max(1)
            cells.append(cand.gather(1, arg[:, None]).squeeze(1))
            inside.append(best)
        return torch.cat(cells), torch.cat(inside)

    def interpolate(self, q, cell, data):
        """(B, V) in the mesh's dtype: ``data`` (P, V) at the vertices of
        ``cell``, weighted by the barycentric coordinates of q."""
        data = torch.as_tensor(data, device=self.device).to(self.dtype)
        out = []
        for s in range(0, q.shape[0], BLOCK):
            c = cell[s: s + BLOCK].clamp_min(0)
            lam = self.lam(q[s: s + BLOCK], c)  # (b, nv)
            vals = data[self.cells[c]]  # (b, nv, V)
            acc = lam[:, 0, None] * vals[:, 0]
            for k in range(1, self.dim + 1):
                acc = acc + lam[:, k, None] * vals[:, k]
            out.append(acc)
        return torch.cat(out)
