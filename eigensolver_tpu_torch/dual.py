"""Dual numbers (value, derivative) on torch tensors.

The twisted cylinder chain needs d(r C1/C3)/dr, which the JAX package takes
from `jax.jvp`. The port carries each quantity of the chain as a `Dual`
instead: forward-mode differentiation written out, one rule per operation,
so that the CUDA kernel (`csrc/common.cuh::Dual`) can do the same operations
in the same order and agree with this bit for bit.

An operand that is not a `Dual` (a tensor or a Python number) is a constant:
its derivative is 0 and it adds no term. A Python float divides as one IEEE
division (`profiles.div`), as the kernels divide.

    (a + b)' = a' + b'           (a - b)' = a' - b'     (c - a)' = -a'
    (a b)'   = a' b + a b'       (a / b)' = (a' - q b') / b,  q = a / b
    sqrt(a)' = a' / (2 sqrt(a))

(the operations the chain uses; a sum or a difference takes two duals).
"""
from __future__ import annotations

import torch

from .profiles import div, sqrt


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
    """The square root of a dual (`profiles.sqrt`, correctly rounded)."""
    s = sqrt(a.v)
    return Dual(s, a.d / (2 * s))
