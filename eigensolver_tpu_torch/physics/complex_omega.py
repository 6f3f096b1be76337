"""The batched dispersion of a complex-omega case, shared by the slab and
the cylinder: the physics' choice of kernel wrappers, the cast of omega to
a `cplx.C` of the run's type, and the mode fixed or taken per call."""

from __future__ import annotations

from ..cplx import C


def complex_dispersion(disp_kernel, newton_kernel, mode, dtype, params,
                       column):
    """A complex-omega case's batched dispersion (the slab's and the
    cylinder's `make_dispersion`): disp(omega, k, mode) through
    `disp_kernel(omega, k, column, params)` and disp.newton(omega0, k,
    mode, n_iter, damping=1.0, final_eval=False) through
    `newton_kernel(omega0, k, column, n_iter, damping, params,
    final_eval)`, omega a `cplx.C` or a complex tensor cast to `dtype`;
    with a fixed `mode`, disp(omega, k) and the mode dropped from newton's
    arguments."""
    def pair(omega):
        if not isinstance(omega, C):
            omega = C.of(omega)
        return C(omega.re.to(dtype).contiguous(),
                 omega.im.to(dtype).contiguous())

    def disp(omega, k, mode_arg):
        omega = pair(omega)
        return disp_kernel(omega, k.to(dtype).contiguous(),
                           column(mode_arg, omega.re), params)

    def newton(omega0, k, mode_arg, n_iter, damping=1.0, final_eval=False):
        omega0 = pair(omega0)
        return newton_kernel(omega0, k.to(dtype).contiguous(),
                             column(mode_arg, omega0.re), n_iter, damping,
                             params, final_eval)

    if mode is None:
        disp.newton = newton
        return disp
    m_const = float(mode)

    def fixed(omega, k):
        return disp(omega, k, m_const)

    fixed.newton = (lambda omega0, k, _none, n_iter, damping=1.0,
                    final_eval=False:
                    newton(omega0, k, m_const, n_iter, damping, final_eval))
    return fixed
