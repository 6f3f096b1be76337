"""Closed-form equilibrium profiles on torch tensors.

Port of `eigensolver_tpu.profiles.make_profile`. Each profile is a plain
function of a tensor `x`; the Python-float parameters behave as JAX's weakly
typed scalars do, i.e. they take the dtype of `x`.

`make_profile_derivative` replaces `elementwise_grad` / `elementwise_grad2`
(a `jax.grad` + `vmap`) with hand-written first and second derivatives of
each family. They agree with `jax.grad` to rounding, not bit for bit (the
reverse pass orders its products differently). The CUDA kernels evaluate the
same expressions (`csrc/common.cuh::profile_d1/profile_d2`) from the
constants of `derivative_coefs`, so kernel and plain version agree bit for
bit.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .config import ProfileConfig, ProfileKind

Profile = Callable[[torch.Tensor], torch.Tensor]


def rdiv(a: float, x: torch.Tensor) -> torch.Tensor:
    """`a / x` for a Python float `a`, rounded once in the dtype of `x` as
    JAX rounds it; torch evaluates `a / x` as `x.reciprocal() * a`, which
    rounds twice."""
    return torch.full_like(x, a) / x


def div(x: torch.Tensor, a: float) -> torch.Tensor:
    """`x / a` for a Python float `a`, as one IEEE division in the dtype of
    `x`; on a CUDA tensor torch evaluates `x / a` as `x * (1 / a)`, which
    can differ in the last bit from the kernels' (and JAX's) division."""
    return x / torch.full_like(x, a)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The IEEE square root, correctly rounded, as XLA and CUDA compute it.

    On a CPU tensor `torch.sqrt` is off by an ulp for ~1% of arguments (in
    float32 and float64), so the CPU goes through numpy's, which is the
    hardware's (tests/test_torch_ieee.py)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def make_profile(cfg: ProfileConfig, f0: float, fe: float) -> Profile:
    """f(x) between the internal value f0 (axis/centre) and the external fe.

    Gaussian:  f(x) = fe + (f0 - fe) exp(-(x-x0)^2 / W^2)
    Epstein:   f(x) = fe + (f0 - fe) / cosh(x/a)^8
    Power law: f(r) = amplitude * r^power
    """
    kind = cfg.kind
    if kind == ProfileKind.UNIFORM:
        def f(x):
            return f0 + 0.0 * x
        return f
    if kind == ProfileKind.GAUSSIAN:
        w2 = cfg.width ** 2
        x0 = cfg.center
        def f(x):
            return fe + (f0 - fe) * torch.exp(div(-((x - x0) ** 2), w2))
        return f
    if kind == ProfileKind.EPSTEIN:
        a = cfg.width
        def f(x):
            # x ** 8 as JAX's integer_pow and the kernels evaluate it
            c = torch.cosh(div(x, a))
            c2 = c * c
            c4 = c2 * c2
            return fe + rdiv(f0 - fe, c4 * c4)
        return f
    if kind == ProfileKind.POWER_LAW:
        amp, p = cfg.amplitude, cfg.power
        def f(x):
            return amp * x ** p
        return f
    raise ValueError(f"unknown profile kind {kind}")


def derivative_coefs(cfg: ProfileConfig, f0: float, fe: float):
    """Python-float constants (a1, a2, b2) of the closed-form derivatives,
    formed in double as the kernels receive them (see
    `make_profile_derivative`)."""
    kind = cfg.kind
    if kind == ProfileKind.GAUSSIAN:
        w2 = cfg.width ** 2
        return (-2.0 * (f0 - fe) / w2, 4.0 * (f0 - fe) / w2 ** 2,
                2.0 * (f0 - fe) / w2)
    if kind == ProfileKind.EPSTEIN:
        a = cfg.width
        return -8.0 * (f0 - fe) / a, 8.0 * (f0 - fe) / a ** 2, 0.0
    if kind == ProfileKind.POWER_LAW:
        amp, p = cfg.amplitude, cfg.power
        return amp * p, amp * p * (p - 1.0), 0.0
    return 0.0, 0.0, 0.0


def make_profile_derivative(cfg: ProfileConfig, f0: float, fe: float,
                            order: int) -> Profile:
    """d f/dx (order 1) or d^2 f/dx^2 (order 2) of `make_profile(cfg, f0, fe)`.

    Gaussian, d = x - x0, e = exp(-d^2 / W^2):
        f' = a1 d e,              a1 = -2 (f0 - fe) / W^2
        f'' = e (a2 d^2 - b2),    a2 = 4 (f0 - fe) / W^4,  b2 = 2 (f0 - fe) / W^2
    Epstein, y = x/a, c = cosh y, t = tanh y:
        f' = a1 t / c^8,          a1 = -8 (f0 - fe) / a
        f'' = a2 (8 t^2 - 1/c^2) / c^8,   a2 = 8 (f0 - fe) / a^2
    Power law:
        f' = a1 x^(p-1),          a1 = amp p
        f'' = a2 x^(p-2),         a2 = amp p (p - 1)
    Uniform: 0.
    """
    if order not in (1, 2):
        raise ValueError(f"derivative order {order}: 1 or 2")
    kind = cfg.kind
    a1, a2, b2 = derivative_coefs(cfg, f0, fe)
    if kind == ProfileKind.UNIFORM:
        return torch.zeros_like
    if kind == ProfileKind.GAUSSIAN:
        w2 = cfg.width ** 2
        x0 = cfg.center

        def df(x):
            d = x - x0
            e = torch.exp(div(-(d ** 2), w2))
            if order == 1:
                return a1 * d * e
            return e * (a2 * (d * d) - b2)
        return df
    if kind == ProfileKind.EPSTEIN:
        a = cfg.width

        def df(x):
            y = div(x, a)
            c = torch.cosh(y)
            t = torch.tanh(y)
            c2 = c * c
            c4 = c2 * c2
            c8 = c4 * c4
            if order == 1:
                return a1 * t / c8
            return a2 * (8.0 * (t * t) - rdiv(1.0, c2)) / c8
        return df
    if kind == ProfileKind.POWER_LAW:
        p = cfg.power

        def df(x):
            return a1 * x ** (p - 1.0) if order == 1 else a2 * x ** (p - 2.0)
        return df
    raise ValueError(f"unknown profile kind {kind}")
