"""Dual numbers (value, derivative) on torch tensors.

The twisted cylinder chain needs d(r C1/C3)/dr, which the JAX package takes
from `jax.jvp`. The port carries each quantity of the chain as a `Dual`
instead: forward-mode differentiation written out, one rule per operation,
so that the CUDA kernel (`csrc/common.cuh::Dual`) can do the same operations
in the same order and agree with this bit for bit.

The value and the derivative may also be complex pairs (`cplx.C`): the
complex-omega Newton iteration takes d det / d omega from the shoot carried
on such duals (`physics/slab.py::make_dispersion_dual_plain`, the kernel's
`csrc/complex.cuh::CDual`), where the JAX package takes a holomorphic
`jax.jvp` with tangent 1. The rules are the same; `cplx.C` supplies the
complex operations and `dsqrt` takes the principal root.

An operand that is not a `Dual` (a tensor or a Python number) is a constant:
its derivative is 0 and it adds no term. A Python float divides as one IEEE
division (`profiles.div`), as the kernels divide.

    (a + b)' = a' + b'           (a - b)' = a' - b'     (c - a)' = -a'
    (a b)'   = a' b + a b'       (a / b)' = (a' - q b') / b,  q = a / b
    sqrt(a)' = a' / (2 sqrt(a))   (1/b)'  = -(b' (1/b)) (1/b)

(the operations the chain uses; a sum or a difference takes two duals).
`recip` is the reciprocal: one division, where a quotient takes two. The
chain multiplies by the reciprocals of its r-only divisors, which the
kernels compute once per abscissa. `over` is the quotient by a dual whose
value's reciprocal is at hand: the quotient rule with its two divisions as
products by that reciprocal, so x/0 and x (1/0) give the same inf or NaN
wherever the divisor is 0.

At complex omega the cylinder's Newton pass carries duals of complex pairs
through its whole shoot (`physics/cylinder.py`), and a constant (a tensor
or a Python number) may be added to or subtracted from such a dual: (a +
c)' = a'. `quot`, `rquot`, `dlog` and `dwhere` take a complex pair or a
dual of one alike; their rules, operation for operation as the kernels
(`csrc/complex.cuh`) repeat them:

    q = a / b:   (a' - q b') / b, both quotients by b's divisions
    q = r / b:   (-(q b')) / b   (r a Python float)
    log(a)' = a' / a

The twisted chain's d(r C1/C3)/dr at complex omega is a dual in r whose
value and derivative are complex, or on the Newton pass duals in omega of
complex pairs: an `RDual`. Its other operands are the chain's r-only
values, `Dual`s of real tensors, and constants; the rules are those above,
so its derivative's derivative is the mixed d^2/dr domega.
"""
from __future__ import annotations

import torch

from .cplx import C, clog, csqrt, divisor
from .cplx import where as cwhere
from .profiles import div, rdiv, sqrt


def _over(x, c):
    """x / c for a constant c: one division, also by a Python float."""
    return div(x, c) if isinstance(c, (int, float)) else x / c


class Dual:
    __slots__ = ("v", "d")

    def __init__(self, v: torch.Tensor, d: torch.Tensor):
        self.v = v
        self.d = d

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v + o.v, self.d + o.d)
        if isinstance(o, RDual):
            return NotImplemented
        return Dual(self.v + o, self.d)

    def __radd__(self, o):
        return Dual(o + self.v, self.d)

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v - o.v, self.d - o.d)
        if isinstance(o, RDual):
            return NotImplemented
        return Dual(self.v - o, self.d)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.d)

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v * o.v, self.d * o.v + self.v * o.d)
        if isinstance(o, RDual):
            return NotImplemented
        return Dual(self.v * o, self.d * o)

    def __rmul__(self, o):
        return Dual(o * self.v, o * self.d)

    def __truediv__(self, o):
        if isinstance(o, Dual):
            q = self.v / o.v
            return Dual(q, (self.d - q * o.d) / o.v)
        return Dual(_over(self.v, o), _over(self.d, o))


def dsqrt(a: Dual) -> Dual:
    """The square root of a dual (`profiles.sqrt`, correctly rounded; of a
    complex one `cplx.csqrt`, the principal root): (s, a' / (2 s))."""
    if isinstance(a.v, C):
        s = csqrt(a.v)
        return Dual(s, a.d / (2 * s))
    s = sqrt(a.v)
    return Dual(s, a.d / (2 * s))


def recip(b: Dual) -> Dual:
    """1/b: the value 1/b (one IEEE division) and the derivative
    -(b' (1/b)) (1/b)."""
    iv = rdiv(1.0, b.v)
    return Dual(iv, -(b.d * iv) * iv)


def over(a: Dual, b: Dual, ib: torch.Tensor) -> Dual:
    """a / b with ib = 1/b.v: q = a.v ib, (a' - q b') ib."""
    q = a.v * ib
    return Dual(q, (a.d - q * b.d) * ib)


class RDual:
    """A dual in r of complex values, or of `Dual`s of them in omega (the
    twisted chain at complex omega); the other operand of an operation is
    an RDual, a `Dual` of real tensors (an r-only value) or a constant."""
    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v = v
        self.d = d

    def __add__(self, o):
        if isinstance(o, (RDual, Dual)):
            return RDual(self.v + o.v, self.d + o.d)
        return RDual(self.v + o, self.d)

    def __radd__(self, o):
        if isinstance(o, Dual):
            return RDual(o.v + self.v, o.d + self.d)
        return RDual(o + self.v, self.d)

    def __sub__(self, o):
        if isinstance(o, (RDual, Dual)):
            return RDual(self.v - o.v, self.d - o.d)
        return RDual(self.v - o, self.d)

    def __rsub__(self, o):
        if isinstance(o, Dual):
            return RDual(o.v - self.v, o.d - self.d)
        return RDual(o - self.v, -self.d)

    def __neg__(self):
        return RDual(-self.v, -self.d)

    def __mul__(self, o):
        if isinstance(o, (RDual, Dual)):
            return RDual(self.v * o.v, self.d * o.v + self.v * o.d)
        return RDual(self.v * o, self.d * o)

    def __rmul__(self, o):
        if isinstance(o, Dual):
            return RDual(o.v * self.v, o.d * self.v + o.v * self.d)
        return RDual(o * self.v, o * self.d)


def quot(a, b):
    """a / b for complex pairs (b's divisions shared by both parts of a
    dual) or duals of them (a may be a complex constant)."""
    if isinstance(b, Dual):
        ib = divisor(b.v)
        if not isinstance(a, Dual):
            q = a / ib
            return Dual(q, (-(q * b.d)) / ib)
        q = a.v / ib
        return Dual(q, (a.d - q * b.d) / ib)
    return a / divisor(b)


def rquot(r: float, b):
    """r / b for a Python float r and a complex pair or a dual of one."""
    if isinstance(b, Dual):
        ib = divisor(b.v)
        q = ib.rquot(r)
        return Dual(q, (-(q * b.d)) / ib)
    return divisor(b).rquot(r)


def divn(z, n):
    """z / n for a real n (a Python number or a tensor), one IEEE division
    a real part."""
    if isinstance(z, Dual):
        return Dual(divn(z.v, n), divn(z.d, n))
    if isinstance(n, torch.Tensor):
        return C(z.re / n, z.im / n)
    return C(div(z.re, n), div(z.im, n))


def dlog(z):
    """The principal logarithm of a complex pair or of a dual of one."""
    if isinstance(z, Dual):
        return Dual(clog(z.v), z.d / divisor(z.v))
    return clog(z)


def dwhere(mask: torch.Tensor, a, b):
    """torch.where on complex pairs or on duals of them, part by part."""
    if isinstance(a, Dual):
        return Dual(cwhere(mask, a.v, b.v), cwhere(mask, a.d, b.d))
    return cwhere(mask, a, b)


def value(z):
    """The value of a dual, or z."""
    return z.v if isinstance(z, Dual) else z
