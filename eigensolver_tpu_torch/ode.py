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
version on the card and the kernels agree bit for bit. At complex omega
the state's components are complex pairs (`cplx.C`), or `dual.Dual`s of
them on the Newton pass: the norm takes the values' moduli (`cplx.cabs`),
and each part, value and derivative, is divided by the one real scale (the
ratio of the components, all the slab reads, does not depend on it;
`csrc/slab_complex.cu::exterior_ratio` repeats this).

`rk4_trajectory` (ode.py:50-72) integrates the same steps and keeps every
state, for the eigenfunctions (`eigenfunctions.py`). Its right-hand sides
there are linear, dy/dx = A(x) y (`LinearRHS`): for those it evaluates
A(x) once on all abscissae of the integration, x0 + i h, then (+ 0.5 h)
and (+ h) as each step forms them, in one batch, folds each step into its
2 x 2 transfer matrix and leaves one matrix product a step serial, so
that a trajectory costs O(n_steps) small launches on a card, not the
dozens a step of an unrolled RK4. The matrix form rounds differently from
the staged update (the eigenfunctions agree with the JAX package's to
~1e-12 of their largest value, not bit for bit).
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from .cplx import C, cabs
from .dual import Dual
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
    logs = torch.zeros_like(_modulus(y[0]))
    for i in range(n_steps):
        y = _step(rhs, y, x0 + i * h, h, hh, h6)
        if (i + 1) % every == 0:
            # jnp.max propagates NaN, as torch.maximum does
            scale = _modulus(y[0])
            for yi in y[1:]:
                scale = torch.maximum(scale, _modulus(yi))
            scale = torch.where(scale > 0, scale, torch.ones_like(scale))
            y = tuple(_unscale(yi, scale) for yi in y)
            logs = logs + torch.log(scale)
    return y, logs


def _modulus(y) -> torch.Tensor:
    """|y| of a state component: a real tensor, a complex pair, or a dual
    (its value's)."""
    if isinstance(y, Dual):
        y = y.v
    return cabs(y) if isinstance(y, C) else torch.abs(y)


def _unscale(y, scale: torch.Tensor):
    """y / scale for a real scale, part by part."""
    if isinstance(y, Dual):
        return Dual(_unscale(y.v, scale), _unscale(y.d, scale))
    if isinstance(y, C):
        return C(y.re / scale, y.im / scale)
    return y / scale


class LinearRHS:
    """dy/dx = A(x) y for a two-component state, A(x) = ((a00, a01), (a10,
    a11)) from `matrix(x)`; each entry a tensor of x's shape or a Python
    float. Called as rhs(x, y) it is a plain `RHS`; `rk4_trajectory` tables
    A on all its abscissae at once."""

    def __init__(self, matrix: Callable[[torch.Tensor], tuple]):
        self.matrix = matrix

    def __call__(self, x: torch.Tensor, y: State) -> State:
        a00, a01, a10, a11 = self.matrix(x)
        v, w = y
        return (a00 * v + a01 * w, a10 * v + a11 * w)


def rk4_trajectory(rhs: Union[RHS, LinearRHS], y0: State, x0, x1,
                   n_steps: int) -> Tuple[State, State]:
    """Integrate as `rk4_final` and keep every state: returns (y_final,
    trajectory), each component of the trajectory of shape (n_steps + 1,
    *component shape), the initial state first. y0's components are
    tensors on one device and of one dtype, where the integration runs;
    x0 and x1 are numbers or 0-d tensors. A `LinearRHS` takes the tabled
    path (the module's docstring), any other rhs the staged steps."""
    like = y0[0]
    x0 = torch.as_tensor(x0, dtype=like.dtype, device=like.device)
    x1 = torch.as_tensor(x1, dtype=like.dtype, device=like.device)
    if isinstance(rhs, LinearRHS):
        return _linear_trajectory(rhs, y0, x0, x1, n_steps)
    h, hh, h6 = _spacing(x0, x1, n_steps)
    y = tuple(y0)
    states = [y]
    for i in range(n_steps):
        y = _step(rhs, y, x0 + i * h, h, hh, h6)
        states.append(y)
    traj = tuple(torch.stack([s[c] for s in states])
                 for c in range(len(y0)))
    return y, traj


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 2 x 2 products (.., 2, 2) @ (.., 2, c) as elementwise
    products and one addition each: no BLAS, whose fused multiply-adds and
    orders differ between devices, so that a card and a CPU round alike."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _linear_trajectory(rhs: LinearRHS, y0: State, x0: torch.Tensor,
                       x1: torch.Tensor, n_steps: int
                       ) -> Tuple[State, State]:
    """RK4 of dy/dx = A(x) y as y_{i+1} = M_i y_i: with A_0, A_h, A_1 the
    matrix at x_i = x0 + i h, x_i + h/2 and x_i + h,
        K1 = A_0,  K2 = A_h (I + h/2 K1),  K3 = A_h (I + h/2 K2),
        K4 = A_1 (I + h K3),  M_i = I + h/6 (K1 + 2 K2 + 2 K3 + K4),
    all steps' M_i in one batch; then one product a step (two launches:
    the products and their sums)."""
    h, hh, h6 = _spacing(x0, x1, n_steps)
    dt, dev = h.dtype, h.device
    xa = x0 + torch.arange(n_steps, dtype=dt, device=dev) * h
    xs = torch.cat([xa, xa + hh, xa + h])
    A = torch.stack([torch.as_tensor(a, dtype=dt, device=dev).expand_as(xs)
                     for a in rhs.matrix(xs)], dim=-1).reshape(-1, 2, 2)
    A0, Ah, A1 = A[:n_steps], A[n_steps:2 * n_steps], A[2 * n_steps:]
    eye = torch.eye(2, dtype=dt, device=dev)
    K1 = A0
    K2 = _mm(Ah, eye + hh * K1)
    K3 = _mm(Ah, eye + hh * K2)
    K4 = _mm(A1, eye + h * K3)
    M = eye + h6 * (K1 + 2 * K2 + 2 * K3 + K4)
    y = torch.stack([torch.as_tensor(c, dtype=dt, device=dev)
                     for c in y0])                   # (2, *batch)
    flat = y.reshape(2, -1)
    ys = torch.empty((n_steps + 1, 2, flat.shape[1]), dtype=dt, device=dev)
    ys[0] = flat
    prod = torch.empty((2, 2, flat.shape[1]), dtype=dt, device=dev)
    for i in range(n_steps):
        torch.mul(M[i][:, :, None], ys[i][None], out=prod)
        torch.sum(prod, dim=1, out=ys[i + 1])
    traj = tuple(ys[:, c].reshape((n_steps + 1,) + y.shape[1:])
                 for c in range(2))
    return tuple(t[-1] for t in traj), traj
