"""Frozen copies of the tet-only yardstick: ``tet_box``,
``face_neighbors`` and ``RefMesh`` as they stood before mesh generators
were found by name and the reference took triangles.  Tests hold the
general forms to these bit for bit on tets; nothing else imports them.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def tet_box(n: int):
    """(points (P, 3) float64, cells (C, 4) int64) of the n^3-cube box."""
    g = np.linspace(0.0, 1.0, n + 1)
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    points = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    strides = np.array([(n + 1) * (n + 1), n + 1, 1], dtype=np.int64)
    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                          indexing="ij")
    base = (i.ravel() * strides[0] + j.ravel() * strides[1]
            + k.ravel()).astype(np.int64)
    blocks = []
    for perm in itertools.permutations(range(3)):
        # the path (0,0,0) -> (1,1,1) through the axes in the order perm
        offs = np.concatenate([[0], np.cumsum(strides[list(perm)])])
        tet = base[:, None] + offs[None, :]
        p = points[tet[0]]
        if np.dot(p[1] - p[0], np.cross(p[2] - p[0], p[3] - p[0])) < 0:
            tet = tet[:, [0, 1, 3, 2]]
        blocks.append(tet)
    return points, np.concatenate(blocks, axis=0)


def face_neighbors(cells: np.ndarray, device="cpu") -> np.ndarray:
    """(C, nv) int32 cell across each face (vertices k..k+nv-2 cyclic), -1
    on the boundary; faces matched by one sort of packed vertex keys."""
    c = torch.as_tensor(cells, dtype=torch.int64, device=device)
    n_cells, nv = c.shape
    if nv != 4:
        raise ValueError("face_neighbors takes tetrahedra")
    faces = torch.stack([c[:, [(k + j) % nv for j in range(3)]]
                         for k in range(nv)], dim=1)  # (C, 4, 3)
    faces = faces.sort(dim=2).values
    key = (faces[..., 0] << 42) | (faces[..., 1] << 21) | faces[..., 2]
    key = key.reshape(-1)
    order = torch.argsort(key)
    ks = key[order]
    same = ks[1:] == ks[:-1]
    a, b = order[:-1][same], order[1:][same]
    nb = torch.full((n_cells * nv,), -1, dtype=torch.int64, device=device)
    nb[a] = b // nv
    nb[b] = a // nv
    return nb.reshape(n_cells, nv).to(torch.int32).cpu().numpy()


# the three vertices of the face opposite vertex k
_OPPOSITE = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))
BLOCK = 1 << 16  # queries per block of a locate


class RefMesh:
    """A tetrahedral mesh held as barycentric planes and uniform bins."""

    def __init__(self, points, cells, dtype=torch.float64, device="cpu"):
        p = torch.as_tensor(points, dtype=torch.float64, device=device)
        c = torch.as_tensor(cells, dtype=torch.int64, device=device)
        if c.shape[1] != 4:
            raise ValueError("the reference takes tetrahedra")
        self.dtype, self.device = dtype, torch.device(device)
        self.cells = c
        p = p.to(dtype)
        v = p[c]  # (C, 4, 3)
        a, b = [], []
        for k, (j0, j1, j2) in enumerate(_OPPOSITE):
            n = torch.linalg.cross(v[:, j1] - v[:, j0], v[:, j2] - v[:, j0])
            den = ((v[:, k] - v[:, j0]) * n).sum(1)
            ak = n / den[:, None]
            a.append(ak)
            b.append((ak * v[:, j0]).sum(1))
        self.a = torch.stack(a, 1)  # (C, 4, 3)
        self.b = torch.stack(b, 1)  # (C, 4)
        self.inv_height = self.a.double().norm(dim=2)  # (C, 4)
        self._bins(v.double(), p.double())

    def _bins(self, v, p):
        """Uniform bins, about one per six cells, each listing every cell
        whose bounding box touches it (padded with -1)."""
        n_cells = self.cells.shape[0]
        rmin, rmax = p.min(0).values, p.max(0).values
        ext = (rmax - rmin).clamp_min(1e-300)
        nb = max(1, round((n_cells / 6) ** (1 / 3)))
        self.shape = (nb, nb, nb)
        self.rmin, self.inv_h = rmin, nb / ext
        slack = 1e-9 * float(ext.max())
        lo = ((v.min(1).values - slack - rmin) * self.inv_h).floor().long()
        hi = ((v.max(1).values + slack - rmin) * self.inv_h).floor().long()
        lo, hi = lo.clamp(0, nb - 1), hi.clamp(0, nb - 1)
        span = hi - lo + 1
        ids, bins = [], []
        smax = span.max(0).values.tolist()
        for ox in range(smax[0]):
            for oy in range(smax[1]):
                for oz in range(smax[2]):
                    o = torch.tensor([ox, oy, oz], device=self.device)
                    ok = (o < span).all(1)
                    cell = torch.nonzero(ok).squeeze(1)
                    ijk = lo[cell] + o
                    ids.append(cell)
                    bins.append((ijk[:, 0] * nb + ijk[:, 1]) * nb + ijk[:, 2])
        ids, bins = torch.cat(ids), torch.cat(bins)
        order = torch.argsort(bins, stable=True)
        ids, bins = ids[order], bins[order]
        count = torch.bincount(bins, minlength=nb ** 3)
        start = torch.cumsum(count, 0) - count
        width = int(count.max())
        rank = torch.arange(ids.numel(), device=self.device) - start[bins]
        table = torch.full((nb ** 3, width), -1, dtype=torch.int64,
                           device=self.device)
        table[bins, rank] = ids
        self.table = table

    def _bin_of(self, q):
        ijk = ((q.double() - self.rmin) * self.inv_h).floor().long()
        ijk = torch.minimum(ijk.clamp_min(0),
                            torch.tensor(self.shape, device=q.device) - 1)
        nb = self.shape[0]
        return (ijk[:, 0] * nb + ijk[:, 1]) * nb + ijk[:, 2]

    def lam(self, q, cell):
        """(B, 4) barycentric coordinates of q (B, 3) in ``cell`` (B,)."""
        q = q.to(self.dtype)
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
            lam = ((self.a[safe] * qb.to(self.dtype)[:, None, None, :]).sum(3)
                   - self.b[safe])  # (b, M, 4)
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
            lam = self.lam(q[s: s + BLOCK], c)  # (b, 4)
            vals = data[self.cells[c]]  # (b, 4, V)
            acc = lam[:, 0, None] * vals[:, 0]
            for k in range(1, 4):
                acc = acc + lam[:, k, None] * vals[:, k]
            out.append(acc)
        return torch.cat(out)
