"""Double-float (compensated f32) arithmetic for accurate mode (torch).

The port of the JAX package's ``ops/df32.py``: the error-free-transform
arithmetic of Dekker (1971) and Knuth (TAOCP 4.2.2) on *pairs* of
float32 tensors.  A value is ``hi + lo`` with ``|lo| <= ulp(hi)/2``,
about 48 significant bits (~1e-14 relative) from float32 operations
only.  It is the numeric core of :mod:`.interp_acc` and of the
df-plane candidate rows.

Every function keeps the JAX package's order of operations, and the
CUDA kernels (``csrc/df32.cuh``, built with ``--fmad=false``) keep it
too, so the plain versions and the kernels agree bit for bit.  The JAX
package wraps sums and products in ``_freeze`` to keep XLA from
contracting them into FMAs; eager torch runs each operation on its own
and needs no such guard.

:func:`two_prod` keeps the JAX package's Dekker form: each operand is
split by a mantissa bit mask (the low 12 of the 24 bits), so every
partial product is exact, and the error is the sum of the partial
products minus the rounded product.  The kernels take the same error
from one exact fused multiply-add, ``__fmaf_rn(a, b, -p)``: the rounding
error of a float32 product is itself a float32, so both forms give the
same bits as long as no partial product underflows below 2^-126
(``tests/test_torch_fma_form.py``).  B5 and B2-df's probe share that
header.

Inputs are ``(hi, lo)`` tuples of float32 tensors of one shape (or
shapes that broadcast).  Divide by tensors only: torch turns a CUDA
tensor divided by a Python scalar into a multiply by the rounded
reciprocal, and the kernels divide.
"""

from __future__ import annotations

import torch

_MASK = -4096  # 0xFFFFF000 as int32: sign, exponent, 11 explicit mantissa bits


def split_queries(r64):
    """Split float64 (or float32) queries into a float32 (hi, lo) pair
    on their own device: hi = f32(r), lo = f32(r - f64(hi)).  Float32
    queries get zero residuals."""
    r = torch.as_tensor(r64)
    if r.dtype == torch.float64:
        hi = r.to(torch.float32)
        lo = (r - hi.to(torch.float64)).to(torch.float32)
        return hi, lo
    hi = r.to(torch.float32)
    return hi, torch.zeros_like(hi)


def two_sum(a, b):
    """Error-free a + b: (s, e) with s = fl(a + b), s + e = a + b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """Exact 12/12-bit mantissa split a = hi + lo, by truncation."""
    hi = (a.view(torch.int32) & _MASK).view(torch.float32)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b: (p, e) with p = fl(a * b), p + e = a * b
    (Dekker's split product; the kernels' FMA form gives the same bits,
    see the module docstring)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def add(x, y):
    """df + df -> df (the accurate Knuth variant)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    t, f = two_sum(xl, yl)
    s, e = quick_two_sum(s, e + t)
    return quick_two_sum(s, e + f)


def neg(x):
    return -x[0], -x[1]


def sub(x, y):
    return add(x, neg(y))


def mul(x, y):
    """df * df -> df."""
    xh, xl = x
    yh, yl = y
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def div(x, y):
    """df / df -> df (one Newton refinement of the f32 quotient)."""
    xh, xl = x
    yh, yl = y
    q1 = xh / yh
    r = sub(x, mul((q1, torch.zeros_like(q1)), y))
    q2 = (r[0] + r[1]) / (yh + yl)
    return quick_two_sum(q1, q2)


def sqrt(x):
    """df sqrt (one Newton step from the f32 root)."""
    xh, _ = x
    s1 = torch.sqrt(xh)
    pos = s1 > 0
    safe = torch.where(pos, s1, torch.ones_like(s1))
    z = torch.zeros_like(s1)
    r = sub(x, mul((s1, z), (s1, z)))
    s2 = torch.where(pos, (r[0] + r[1]) / (2.0 * safe), z)
    return quick_two_sum(s1, s2)


def from_f32(a):
    return a, torch.zeros_like(a)


def to_f32(x):
    return x[0] + x[1]


def scale(x, c):
    """df * exact f32 scalar c."""
    c = torch.full_like(x[0], c)
    return mul(x, (c, torch.zeros_like(c)))


def dot3(ax, ay, az, bx, by, bz):
    """df dot product of two 3-vectors of df components."""
    return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz))


def cross(ax, ay, az, bx, by, bz):
    """df cross product -> 3 df components."""
    cx = sub(mul(ay, bz), mul(az, by))
    cy = sub(mul(az, bx), mul(ax, bz))
    cz = sub(mul(ax, by), mul(ay, bx))
    return cx, cy, cz


def triple(ax, ay, az, bx, by, bz, cx, cy, cz):
    """df scalar triple product a . (b x c)."""
    vx, vy, vz = cross(bx, by, bz, cx, cy, cz)
    return dot3(ax, ay, az, vx, vy, vz)
