"""Complex numbers as (re, im) pairs of real tensors.

The complex-omega path (Kelvin-Helmholtz growth rates) computes in complex
arithmetic, and its CUDA kernels (`csrc/complex.cuh`) must agree with the
plain PyTorch version bit for bit. PyTorch's own complex kernels do not
allow that: inside one CUDA launch `a*c - b*d` may be contracted into a
fused multiply-add, and its vectorised CPU division is not the scalar
formula. So the port carries a complex number as a pair of real tensors, and
every operation here is a short sequence of real IEEE operations that the
kernels repeat in the same order (built with `--fmad=false`):

    (a + bi) +- (c + di) = (a +- c, b +- d)
    (a + bi) (c + di)    = (ac - bd, ad + bc)
    r (a + bi)           = (ra, rb)            r - (a + bi) = (r - a, -b)
    (a + bi) / (c + di)  Smith's algorithm as numpy and c10::complex divide:
        |c| >= |d|: rat = d/c, scl = 1/(c + d rat),
                    ((a + b rat) scl, (b - a rat) scl)
        else:       rat = c/d, scl = 1/(d + c rat),
                    ((a rat + b) scl, (b rat - a) scl)
        c = d = 0:  (a/0, b/0)
    r / (c + di)         the same with b = 0 and its zero terms dropped
    sqrt(a + bi)         the principal root, Re >= 0, with |.| as below:
                         t = sqrt((|a| + |z|)/2), (t, b/2t) for a >= 0,
                         (|b|/2t, copysign(t, b)) for a < 0; on the real
                         axis (b = +-0) (sqrt|a|, 0) or (0, sqrt|a|), as
                         XLA's complex sqrt gives for either sign of zero
    |a + bi|             m sqrt(1 + (n/m)^2), m = max(|a|, |b|), n = min
    angle(a + bi)        atan2(b, a)
    log(a + bi)          (log|z|, atan2(b, a)), |z| as above

A division is split into `divisor(z)` (rat and scl: the two real divisions,
which depend on the divisor alone) and its application to a numerator (six
products and sums), so that quotients by one divisor share its divisions;
the bits are those of separate divisions. A real operand (a tensor or a
Python number) is a complex number with a zero imaginary part whose zero
terms are dropped: only the sign of a zero can differ from the full complex
operation. Python floats take the dtype of the tensor they meet, as JAX's
weakly typed scalars do.
"""
from __future__ import annotations

import math
from typing import Union

import torch

from .profiles import rdiv, sqrt as rsqrt

Real = Union[torch.Tensor, float, int]


class C:
    """A complex number (or a tensor of them) as real and imaginary parts."""
    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re = re
        self.im = im

    @classmethod
    def of(cls, z: torch.Tensor) -> "C":
        """Split a complex tensor (a real one has imaginary part 0)."""
        if z.is_complex():
            return cls(z.real.contiguous(), z.imag.contiguous())
        return cls(z, torch.zeros_like(z))

    def complex(self) -> torch.Tensor:
        """The pair as a complex tensor (for callers; no arithmetic)."""
        return torch.complex(self.re, self.im)

    def __add__(self, o):
        if isinstance(o, C):
            return C(self.re + o.re, self.im + o.im)
        return C(self.re + o, self.im)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, C):
            return C(self.re - o.re, self.im - o.im)
        return C(self.re - o, self.im)

    def __rsub__(self, o):
        return C(o - self.re, -self.im)

    def __neg__(self):
        return C(-self.re, -self.im)

    def __mul__(self, o):
        if isinstance(o, C):
            return C(self.re * o.re - self.im * o.im,
                     self.re * o.im + self.im * o.re)
        return C(self.re * o, self.im * o)

    def __rmul__(self, o):
        return C(o * self.re, o * self.im)

    def __truediv__(self, o):
        if not isinstance(o, Divisor):
            o = divisor(o)
        return o.quot(self)

    def __rtruediv__(self, o):
        return divisor(self).rquot(o)

    def reshape(self, *shape):
        return C(self.re.reshape(*shape), self.im.reshape(*shape))


class Divisor:
    """The divisions of Smith's algorithm for a divisor c + di: the quotient
    of a + bi is ((a u + b v) scl, (b u - a v) scl) with (u, v) = (1, rat)
    where |c| >= |d| and (rat, 1) elsewhere (x 1 is exact, so these are
    both branches' products); a zero divisor takes (u, v, scl) = (1, 0, inf),
    which gives numpy's (a/0, b/0) for finite numerators."""
    __slots__ = ("u", "v", "scl")

    def __init__(self, u, v, scl):
        self.u = u
        self.v = v
        self.scl = scl

    def quot(self, a: C) -> C:
        u, v, scl = self.u, self.v, self.scl
        return C((a.re * u + a.im * v) * scl, (a.im * u - a.re * v) * scl)

    def rquot(self, r: Real) -> C:
        """r / (c + di) for a real r: (r u scl, -(r v) scl)."""
        return C((r * self.u) * self.scl, (-(r * self.v)) * self.scl)

    def __rtruediv__(self, r):
        if isinstance(r, C):
            return self.quot(r)
        return self.rquot(r)


def divisor(z: C) -> Divisor:
    """The divisions of a quotient by z, for every numerator."""
    c, d = z.re, z.im
    big = c.abs() >= d.abs()          # False where either is NaN
    num = torch.where(big, d, c)
    den = torch.where(big, c, d)
    rat = num / den
    scl = rdiv(1.0, den + num * rat)
    one = torch.ones_like(rat)
    zero = den == 0                   # c = d = 0 (den = d != 0 elsewhere)
    u = torch.where(big, one, rat)
    v = torch.where(zero, torch.zeros_like(rat), torch.where(big, rat, one))
    scl = torch.where(zero, torch.full_like(scl, math.inf), scl)
    return Divisor(u, v, scl)


def cabs(z: C) -> torch.Tensor:
    """|z| = m sqrt(1 + (n/m)^2), m = max(|re|, |im|), n = min: within an
    ulp or so of hypot, from operations that round as IEEE says on every
    device (0 for m = 0, inf for m = inf, NaN propagates)."""
    ax, ay = z.re.abs(), z.im.abs()
    m = torch.maximum(ax, ay)
    n = torch.minimum(ax, ay)
    r = n / m
    s = m * rsqrt(1.0 + r * r)
    s = torch.where(m == 0, torch.zeros_like(s), s)
    return torch.where(m == math.inf, m, s)


def csqrt(z: C) -> C:
    """The principal square root, Re >= 0 (see the module's docstring)."""
    a, b = z.re, z.im
    t = rsqrt((a.abs() + cabs(z)) * 0.5)
    t2 = 2.0 * t
    pos = a >= 0
    re = torch.where(pos, t, b.abs() / t2)
    im = torch.where(pos, b / t2, torch.copysign(t, b))
    # on the real axis, either sign of zero: (sqrt|a|, 0) or (0, sqrt|a|)
    axis = b == 0
    s = rsqrt(a.abs())
    zero = torch.zeros_like(s)
    re = torch.where(axis, torch.where(pos, s, zero), re)
    im = torch.where(axis, torch.where(pos, zero, s), im)
    return C(re, im)


def angle(z: C) -> torch.Tensor:
    """The argument, atan2(im, re)."""
    return torch.atan2(z.im, z.re)


def clog(z: C) -> C:
    """The principal logarithm (log|z|, atan2(im, re)), |z| from `cabs`."""
    return C(torch.log(cabs(z)), torch.atan2(z.im, z.re))


def is_zero(z: C) -> torch.Tensor:
    """z == 0 (both parts, either sign)."""
    return (z.re == 0) & (z.im == 0)


def where(mask: torch.Tensor, a: C, b: C) -> C:
    return C(torch.where(mask, a.re, b.re), torch.where(mask, a.im, b.im))
