"""Closed-form equilibrium profiles on torch tensors.

Port of `eigensolver_tpu.profiles.make_profile`. Each profile is a plain
function of a tensor `x`; the Python-float parameters behave as JAX's weakly
typed scalars do, i.e. they take the dtype of `x`. The derivative helpers
(`elementwise_grad`, a `jax.grad`) are not ported yet: the density and
axial-flow cylinder chain needs no derivative; the slab shear branch
(ROADMAP A8) and the eigenfunctions (A14) do.
"""
from __future__ import annotations

from typing import Callable

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
            return fe + rdiv(f0 - fe, torch.cosh(div(x, a)) ** 8)
        return f
    if kind == ProfileKind.POWER_LAW:
        amp, p = cfg.amplitude, cfg.power
        def f(x):
            return amp * x ** p
        return f
    raise ValueError(f"unknown profile kind {kind}")
