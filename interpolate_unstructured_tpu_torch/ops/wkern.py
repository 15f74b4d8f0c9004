"""Single source of truth for the per-cell weight formulas (torch).

The port of the JAX package's ``ops/wkern.py``: the interpolation
weight formulas of the reference (m_interp_unstructured.f90:529-551
triangle, :553-586 tetra, :588-641 quad), written once over an
arithmetic trait ``ar`` and called by every torch path on per-component
tensors.  The CUDA kernels carry the same formulas, operation for
operation, in ``csrc/wkern.cuh``; an edit here is an edit there.

Two traits, as in the JAX package: :class:`Plain` (one tensor per
scalar) and :class:`DF` (df32 ``(hi, lo)`` pairs, accurate mode; its
CUDA twin is ``csrc/interp_acc.cu``).  Every operation keeps the JAX
package's order of evaluation, so float64 results stay within a few ulp
of the reference (the 1e-14 linear-exactness invariant) and float32
results match the kernels, which are built without FMA contraction.
"""

from __future__ import annotations

import torch

from . import df32


class Plain:
    """Native torch arithmetic: an ``ar`` scalar is one tensor (any shape)."""

    def __init__(self, dtype):
        # Relative threshold for the quad linear fallback: the
        # reference's absolute |A| < 1e-20 (:618) never fires in f32;
        # scaled to the dtype instead (see quad_weights_generic).
        self.rel_eps = 8.0 * float(torch.finfo(dtype).eps)

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def sub(a, b):
        return a - b

    @staticmethod
    def mul(a, b):
        return a * b

    @staticmethod
    def div(a, b):
        return a / b

    @staticmethod
    def neg(a):
        return -a

    @staticmethod
    def scale(a, c):
        return c * a

    @staticmethod
    def sqrt(a):
        return torch.sqrt(a)

    @staticmethod
    def max0(a):
        return torch.clamp_min(a, 0.0)

    @staticmethod
    def hi(a):
        """Leading part — the comparison proxy (identity here)."""
        return a

    @staticmethod
    def select(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def safe_one(cond, a):
        """1 where cond else a (guards divisions by vanishing values)."""
        return torch.where(cond, torch.ones_like(a), a)

    @staticmethod
    def one_minus(a):
        return 1 - a


class DF:
    """df32 arithmetic: an ``ar`` scalar is an (hi, lo) float32 pair."""

    # df32 working precision ~2^-48
    rel_eps = 8.0 * 2.0 ** -48

    add = staticmethod(df32.add)
    sub = staticmethod(df32.sub)
    mul = staticmethod(df32.mul)
    div = staticmethod(df32.div)
    neg = staticmethod(df32.neg)
    scale = staticmethod(df32.scale)
    sqrt = staticmethod(df32.sqrt)

    @staticmethod
    def max0(a):
        neg = (a[0] + a[1]) < 0
        z = torch.zeros_like(a[0])
        return torch.where(neg, z, a[0]), torch.where(neg, z, a[1])

    @staticmethod
    def hi(a):
        return a[0] + a[1]

    @staticmethod
    def select(cond, a, b):
        return torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])

    @staticmethod
    def safe_one(cond, a):
        return (torch.where(cond, torch.ones_like(a[0]), a[0]),
                torch.where(cond, torch.zeros_like(a[1]), a[1]))

    @staticmethod
    def one_minus(a):
        return df32.sub((torch.ones_like(a[0]), torch.zeros_like(a[0])), a)


def _cross_c(ar, ax, ay, az, bx, by, bz):
    """Component cross product, same order as the reference's
    cross_product (:644-651)."""
    return (
        ar.sub(ar.mul(ay, bz), ar.mul(az, by)),
        ar.sub(ar.mul(az, bx), ar.mul(ax, bz)),
        ar.sub(ar.mul(ax, by), ar.mul(ay, bx)),
    )


def _dot3_c(ar, ax, ay, az, bx, by, bz):
    return ar.add(ar.add(ar.mul(ax, bx), ar.mul(ay, by)), ar.mul(az, bz))


def triangle_areas2(v, q, ar):
    """Twice the opposite sub-triangle areas (:529-551), unnormalized.

    Args:
      v: per-vertex components ``v[vtx][dim]`` (3 vertices).
      q: query components ``(qx, qy, qz)``.
    Returns 3 ``ar`` scalars — ``|cross(q - v_j, q - v_k)|`` for
    (j, k) = (1,2), (2,0), (0,1).  Callers normalize by the cell area.
    """

    def area2(j, k):
        e = [ar.sub(q[d], v[j][d]) for d in range(3)]
        f = [ar.sub(q[d], v[k][d]) for d in range(3)]
        cx, cy, cz = _cross_c(ar, *e, *f)
        return ar.sqrt(_dot3_c(ar, cx, cy, cz, cx, cy, cz))

    return [area2(1, 2), area2(2, 0), area2(0, 1)]


def tetra_triples(v, q, ar):
    """Signed scalar triple products (:553-586), unnormalized.

    Returns 4 ``ar`` scalars; callers divide by 6*volume."""

    def e(a, b):  # v[b] - v[a]
        return [ar.sub(v[b][d], v[a][d]) for d in range(3)]

    def pq(a):  # q - v[a]
        return [ar.sub(q[d], v[a][d]) for d in range(3)]

    def triple(a, b, c):
        cx, cy, cz = _cross_c(ar, *b, *c)
        return _dot3_c(ar, *a, cx, cy, cz)

    v1r, v2r = pq(0), pq(1)
    return [
        triple(v2r, e(1, 3), e(1, 2)),
        triple(v1r, e(0, 2), e(0, 3)),
        triple(v1r, e(0, 3), e(0, 1)),
        triple(v1r, e(0, 1), e(0, 2)),
    ]


def quad_weights_generic(v, q, ar):
    """Inverse-bilinear quad weights (:588-641), branch-free.

    The reference root (-B - sqrt(disc))/2A (:612-622), evaluated
    cancellation-free: for qb < 0 the algebraically identical qc/qq form
    is used (qq is the stable half-sum).  The linear fallback remains
    only where the qb >= 0 evaluation divides by a vanishing qa (the
    reference's |A| < 1e-20 parallelogram branch, :618, made relative
    and dtype-scaled).  Lambda comes from the first-occurrence
    largest-|denominator| component (:628-632), with fully degenerate
    quads guarded to return finite values.

    Args:
      v: per-vertex components ``v[vtx][dim]``, 4 vertices in the
        reference's (1,2)-(4,3) order.
      q: query components ``(qx, qy, qz)``.
      ar: arithmetic trait — required: the parallelogram fallback
        threshold is ``ar.rel_eps``, which must match the data's dtype.
    Returns 4 ``ar``-scalar weights.
    """
    qv = [ar.sub(q[d], v[0][d]) for d in range(3)]
    b1 = [ar.sub(v[1][d], v[0][d]) for d in range(3)]
    b2 = [ar.sub(v[3][d], v[0][d]) for d in range(3)]
    # b3 = p0 - p1 - p3 + p2 (:601), left-to-right association
    b3 = [
        ar.add(ar.sub(ar.sub(v[0][d], v[1][d]), v[3][d]), v[2][d])
        for d in range(3)
    ]

    def cpz(a, b):
        return ar.sub(ar.mul(a[0], b[1]), ar.mul(a[1], b[0]))

    qa = cpz(b2, b3)
    qb = ar.sub(cpz(b3, qv), cpz(b1, b2))
    qc = cpz(b1, qv)
    disc = ar.sub(ar.mul(qb, qb), ar.scale(ar.mul(qa, qc), 4.0))
    root = ar.sqrt(ar.max0(disc))

    qb_h = ar.hi(qb)
    pos = qb_h >= 0
    qq = ar.scale(ar.add(qb, ar.select(pos, root, ar.neg(root))), -0.5)
    tiny_qa = torch.abs(ar.hi(qa)) <= ar.rel_eps * torch.abs(qb_h)
    linear = pos & tiny_qa
    qa_safe = ar.safe_one(tiny_qa, qa)
    qb_safe = ar.safe_one(~(torch.abs(qb_h) > 0), qb)
    qq_safe = ar.safe_one(ar.hi(qq) == 0, qq)
    mu = ar.select(
        linear,
        ar.div(ar.neg(qc), qb_safe),
        ar.select(pos, ar.div(qq, qa_safe), ar.div(qc, qq_safe)),
    )

    d3 = [ar.add(b1[d], ar.mul(mu, b3[d])) for d in range(3)]
    a0, a1, a2 = (torch.abs(ar.hi(d3[d])) for d in range(3))
    # First-occurrence maxloc over the 3 components (:628-632)
    use0 = a0 >= a1
    d01 = ar.select(use0, d3[0], d3[1])
    q01 = ar.select(use0, qv[0], qv[1])
    b01 = ar.select(use0, b2[0], b2[1])
    use01 = torch.maximum(a0, a1) >= a2
    dd = ar.select(use01, d01, d3[2])
    qd = ar.select(use01, q01, qv[2])
    bd = ar.select(use01, b01, b2[2])
    dd = ar.safe_one(ar.hi(dd) == 0, dd)
    lam = ar.div(ar.sub(qd, ar.mul(bd, mu)), dd)

    # Vertex order (1,2)-(4,3): tmp1 = p1 (1-lam) + p2 lam,
    # tmp2 = p4 (1-lam) + p3 lam, res = tmp1 (1-mu) + tmp2 mu (:634-639)
    il = ar.one_minus(lam)
    im = ar.one_minus(mu)
    return [
        ar.mul(il, im),
        ar.mul(lam, im),
        ar.mul(lam, mu),
        ar.mul(il, mu),
    ]
