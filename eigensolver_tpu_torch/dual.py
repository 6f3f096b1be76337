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
"""
from __future__ import annotations

import torch

from .cplx import C, csqrt
from .profiles import div, rdiv, sqrt


def _over(x, c):
    """x / c for a constant c: one division, also by a Python float."""
    return div(x, c) if isinstance(c, (int, float)) else x / c


class Dual:
    __slots__ = ("v", "d")

    def __init__(self, v: torch.Tensor, d: torch.Tensor):
        self.v = v
        self.d = d

    def __add__(self, o: "Dual"):
        return Dual(self.v + o.v, self.d + o.d)

    def __sub__(self, o: "Dual"):
        return Dual(self.v - o.v, self.d - o.d)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.d)

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v * o.v, self.d * o.v + self.v * o.d)
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
