"""Fixed-step RK4 integration on tensors of candidates (PyTorch port).

Port of `eigensolver_tpu.ode.rk4_final` (ode.py:22-47) and
`rk4_final_renorm` (:75-110), the integrators of the numeric exteriors
(`physics/slab.py`, `physics/cylinder.py` with exterior_method="numeric").
The state is a tuple of tensors (one per component, each holding every
candidate), a Python loop takes the place of `lax.scan`, and each operation
is the JAX code's, in its order:

    h = (x1 - x0) / n_steps            (one division, `profiles.div`)
    x = x0 + i h                       (formed afresh at every step)
    k2 = rhs(x + (0.5 h), y + (0.5 h) k1), k3 alike, k4 at x + h
    y = y + (h / 6) (((k1 + 2 k2) + 2 k3) + k4)

and in `rk4_final_renorm`, after step i when (i + 1) % every == 0, the state
divided by its max-norm (NaN-propagating, 1 where it is 0 or NaN) and the
log of that scale added up. The CUDA kernels integrate the exteriors in
this order (`csrc/common.cuh::slab_exterior`, `cyl_exterior`), so the plain
version on the card and the kernels agree bit for bit.

`rk4_trajectory` (the eigenfunction path, ROADMAP A14) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .profiles import div

State = Tuple[torch.Tensor, ...]
# rhs(x, y) -> dy/dx, y a tuple of tensors
RHS = Callable[[torch.Tensor, State], State]


def _step(rhs: RHS, y: State, x: torch.Tensor, h: torch.Tensor,
          hh: torch.Tensor, h6: torch.Tensor) -> State:
    """One classical RK4 step from abscissa x with step h (hh = 0.5 h,
    h6 = h / 6)."""
    def axpy(a, k):
        return tuple(yi + a * ki for yi, ki in zip(y, k))

    k1 = rhs(x, y)
    k2 = rhs(x + hh, axpy(hh, k1))
    k3 = rhs(x + hh, axpy(hh, k2))
    k4 = rhs(x + h, axpy(h, k3))
    return tuple(yi + h6 * (a + 2 * b + 2 * c + d)
                 for yi, a, b, c, d in zip(y, k1, k2, k3, k4))


def _spacing(x0: torch.Tensor, x1: torch.Tensor, n_steps: int):
    h = div(x1 - x0, n_steps)
    return h, 0.5 * h, div(h, 6.0)


def rk4_final(rhs: RHS, y0: State, x0: torch.Tensor, x1: torch.Tensor,
              n_steps: int) -> State:
    """Integrate dy/dx = rhs(x, y) from x0 to x1 in n_steps RK4 steps;
    return y(x1). x0, x1 may be tensors of candidates."""
    h, hh, h6 = _spacing(x0, x1, n_steps)
    y = tuple(y0)
    for i in range(n_steps):
        y = _step(rhs, y, x0 + i * h, h, hh, h6)
    return y


def rk4_final_renorm(rhs: RHS, y0: State, x0: torch.Tensor,
                     x1: torch.Tensor, n_steps: int, every: int = 64
                     ) -> Tuple[State, torch.Tensor]:
    """RK4 as `rk4_final`, with the (linear, homogeneous) state scaled to
    unit max-norm after every `every`-th step. Returns (y_final,
    log_scale): the true solution is y exp(log_scale)."""
    h, hh, h6 = _spacing(x0, x1, n_steps)
    y = tuple(y0)
    logs = torch.zeros_like(y[0])
    for i in range(n_steps):
        y = _step(rhs, y, x0 + i * h, h, hh, h6)
        if (i + 1) % every == 0:
            # jnp.max propagates NaN, as torch.maximum does
            scale = torch.abs(y[0])
            for yi in y[1:]:
                scale = torch.maximum(scale, torch.abs(yi))
            scale = torch.where(scale > 0, scale, torch.ones_like(scale))
            y = tuple(yi / scale for yi in y)
            logs = logs + torch.log(scale)
    return y, logs
