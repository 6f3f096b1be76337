"""The complex-omega Kelvin-Helmholtz (KH) sweeps at full width, as data.

`cases.slab_flow_complex_coronal()` at its published settings
(`eigensolver_tpu/cases.py:86-109`, from the reference's
`flow_multiprocessor_complex_coronal.py:104-120, :231, :1127`): 20 k over
[0.01, 2.5], the speed edges (-0.5, 0, 0.5, 1), 12 x 10 Newton seeds per
(k, band) cell (7,200 in all), 30 Newton steps, n_interior = 2048, the
shear form with shear pressure and the exact exterior, kink only, float64;
the argument-principle audit over the 60 cells, 512 contour points each.
Two widths: the published 1e5, where U is flat and the Doppler-tanh
relation of `tests/test_complex_kh.py::_analytic_newton` is exact, and 1.0,
the non-uniform KH layer, where the audit is the only oracle.

`TARGETS` holds, for each, what `run_case_complex` of the JAX package gives
on a CPU in float64 (JAX 0.9.0, x64), from

    python tests/test_torch_complex.py jax-counts NAME

(`counts` per branch, and of the roots off the real axis by the audit's
margin, |Im omega| > 0.05 imag_band; the audit's `completeness`; the
largest growth rate Im(omega), its k and Re(omega)), and per seed
(`seed_verdicts`): which seeds were accepted and which had converged, and
`counts_converged`, the roots the converged accepted seeds give after the
sweep's dedup. Nothing here imports torch or jax.
"""
from __future__ import annotations

import base64
import dataclasses
import zlib

import numpy as np

# name: (the case factory's keyword arguments, run_case_complex's)
CONFIGS = {
    "kh_w1e5": (dict(width=1e5), dict(n_re=12, n_im=10, newton_iters=30)),
    "kh_w1": (dict(width=1.0), dict(n_re=12, n_im=10, newton_iters=30)),
}

TARGETS = {
    "kh_w1e5": {
        "counts": {"kink": 49}, "counts_off_axis": {"kink": 10},
        "completeness": {"cells": 60, "checked": 60, "agree": 60,
                         "missed": 0, "fraction": 1.0},
        "max_growth": 0.10035524568726266,
        "max_growth_k": 0.40315789473684216,
        "max_growth_omega_re": 0.22583581537897543,
        "counts_converged": {"kink": 49}, "counts_exact": True,
        "accepted": 4614, "converged": 5990,
        "seeds_accepted": (
            "eNpjYCAFCKhJthXPeW75r37+4w9/7PmP/wSyHj6skmNv/lABIfgPgyQOf6h4"
            "+KNO/vznP//tz/8nDA58sJNvfwhS/JmwYgYGDnbmA1DjCSsGgoYEGf52YhWD"
            "jQe5hTjFDEyMB37UE6sYBFi4GBvc+//+Q5K+//hDBQMzw4GK+v2oigUUGDyE"
            "MAz/Y8DA3nDAgEFBACV6FOTksdm9HUw+/GCAGpl88rid+/mDBQuKYh5+PJ77"
            "UUGSYjZGZMUc7PgUF6ClQGY8itE9OECKHwiQqBgAyv484A=="),
        "seeds_converged": (
            "eNpjYCAFCKhJthXPeW75r37+4w9/7PmP/wSyHj6skmNv/lABIfgPgyQOf6h4"
            "+KNO/vznP//tz/8nDA58sJNvfwhS/JmwYgYGDnbmA1DjCSsGgoYEGf52YhWD"
            "jQe5hTjFDEyMB37U41D8fT9MMTMiFFm4GBvc+//+Q1J3//GHCqCSAxX1YA3n"
            "DzAwKPKffMLAIJHA4CGEYfifCgb2hgMVcvb/hzv4/psEtdsHheLn00lUDAC4"
            "+On5"),
    },
    "kh_w1": {
        "counts": {"kink": 270}, "counts_off_axis": {"kink": 0},
        "completeness": {"cells": 60, "checked": 60, "agree": 60,
                         "missed": 0, "fraction": 1.0},
        "max_growth": 0.0008631742459042521,
        "max_growth_k": 1.0584210526315792,
        "max_growth_omega_re": 1.0986752588903745,
        "counts_converged": {"kink": 246}, "counts_exact": False,
        "accepted": 1891, "converged": 3832,
        "seeds_accepted": (
            "eNpjYCAB1M9//vMfCvHjjz3/4Q8oxCEo6//99///v/3/7/72t+eP/97+9v7z"
            "3/+BOn5v/3/+/L/Kefm3v5///B8EQOoQ4N4fEPnnv/12CP8PQur3t79g+sCP"
            "Ovn2z0Al52FKQKx/8v/RAchkoLOZGEE6zn/+g1CMA0D9ycHSAtQlgOx1i/r/"
            "1ffAat7fR1WMFTC3PwRaBFT09z1hxUAgkW+P6QyCoMGBYUABE+NA2CqgACJZ"
            "OMg3gfEBKZ4UoLWHAPTQ7Cs="),
        "seeds_converged": (
            "eNqlkr9Kw1AYxW+bDJ204OIi8REEl27p7kP4BNrVEjAdhAy+g8WnyJhgBTfj"
            "KBSSOnWQkNpAk5Kbe7z5RxNyK6hnuLk33+8evvMlhPxC+nS5ZY0lpurhbNVY"
            "nt6KHbwA2pXFvHP/xUhM35mtU1VZJiYch40fRvPICYGUcY6lLqCCnwK4NIkA"
            "CtVELopSupVsxrrFd/b7tWKEHHEqROVWTEFeBZKoLPAOwNvuduz49uQ1pBWM"
            "fSpz9uQ7fqtfjz7Qobk583mZP1j606Qk44NmiTw/KJ2lomCL+eNRo6vnCX+n"
            "LAh5vBgKbhwoO1QDYpkA6yNJvxfBREIoDPu1EMDdVDyZcCV0LifOp1GHo1iU"
            "8SYrmW1ruheGEO6fZoDcq8FVG/90busM2MyLH/PvzqwzGbaddx/lGzNa39Q="),
    },
}

# Newton is chaotic near the flow continuum: at width 1.0 some seeds have
# not converged after 30 steps, and where they land, and whether they are
# accepted, follows rounding (the JAX package on a CPU accepts 270 roots,
# the port's kernels on an H100 268; PERF.md section 6). So a float64 run
# is held exactly where the result is determined: a seed has converged
# when one more Newton step from its final omega moves it by at most
# CONVERGED_RTOL |omega| (the 1e-9 to which the tests hold a root); the
# seeds converged in both runs must be accepted alike, seed by seed, and
# the converged accepted seeds must give `counts_converged` roots. The
# total count is held exactly where the JAX package's unconverged accepted
# seeds add no root to those (`counts_exact`: width 1e5, not 1.0). The
# off-axis counts, the audit and the largest growth rate (GROWTH_RTOL) are
# held at both widths.
CONVERGED_RTOL = 1e-9
GROWTH_RTOL = 1e-8


def seed_verdicts(case, om, om_next, mismatch_pct, valid, k,
                  accept_pct: float = 0.5):
    """(accepted, converged) per seed, boolean numpy arrays, from float64
    numpy arrays of the final omegas `om` (complex), the omegas one Newton
    step further `om_next`, the dispersion's % mismatch and valid at `om`,
    and the seeds' k: accepted as `run_case_complex` accepts a root in
    float64 (eigensolver_tpu/sweep.py:359-368), converged as
    CONVERGED_RTOL says."""
    speeds = np.asarray(case.sorted_speeds())
    v = om.real / k
    in_window = ((v > speeds[0] - 0.05) & (v < speeds[-1] + 0.05)
                 & (np.abs(om.imag) < 3 * case.imag_band))
    accepted = ((mismatch_pct < accept_pct) & valid & in_window
                & np.isfinite(mismatch_pct)
                & (np.abs(om.real) > 1e-6 * np.abs(k)))
    converged = np.abs(om_next - om) <= CONVERGED_RTOL * np.abs(om)
    return accepted, converged


def converged_count(om, k, accepted, converged, dedup, dedup_rel) -> int:
    """The roots that the converged accepted seeds give, deduplicated by one
    package's `roots.dedup_complex_roots` (`dedup`)."""
    sel = accepted & converged
    return len(dedup(om[sel], k[sel], dedup_rel)[0])


def pack_mask(mask) -> str:
    """A boolean array as text: its bits packed, zlib, base64."""
    raw = np.packbits(np.asarray(mask, bool)).tobytes()
    return base64.b64encode(zlib.compress(raw, 9)).decode()


def unpack_mask(text: str, n: int) -> np.ndarray:
    """pack_mask's inverse: n booleans."""
    raw = zlib.decompress(base64.b64decode(text))
    return np.unpackbits(np.frombuffer(raw, np.uint8), count=n).astype(bool)


def configure(name: str, cases, **case_kw):
    """(case, run_case_complex's keyword arguments) of `name` with one
    package's `cases` module; `case_kw` replaces case fields (a test's
    reduced k grid)."""
    fac_kw, run_kw = CONFIGS[name]
    case = cases.slab_flow_complex_coronal(**fac_kw)
    if case_kw:
        case = dataclasses.replace(case, **case_kw)
    return case, dict(run_kw)


def analytic_newton(rg, W0, K, n=60):
    """The uniform-limit KH dispersion relation with internal flow (the
    Doppler tanh relation of tests/test_complex_kh.py:14-39, copied: that
    module imports the JAX package), solved for the phase speed W = omega/k
    by Newton's method from W0 with central differences; rg the case's
    regime, K the wavenumber."""
    R1 = rg.rho_e / rg.rho_i0

    def rel(W):
        Om_i = W - rg.U_i0
        Om_e = W - rg.U_e

        def msq(c2, a2, Om):
            cT2 = c2 * a2 / (c2 + a2) if (c2 + a2) > 0 else 0.0
            return (c2 - Om**2) * (a2 - Om**2) / ((c2 + a2) * (cT2 - Om**2))

        m0 = np.sqrt(np.complex128(msq(rg.c_i0**2, rg.vA_i0**2, Om_i)))
        me = np.sqrt(np.complex128(msq(rg.c_e**2, rg.vA_e**2, Om_e)))
        return (R1 * (rg.vA_e**2 - Om_e**2) * m0
                / (np.tanh(K * m0) * me * (rg.vA_i0**2 - Om_i**2)) + 1)

    W = np.complex128(W0)
    for _ in range(n):
        h = 1e-8
        f = rel(W)
        df = (rel(W + h) - rel(W - h)) / (2 * h)
        Wn = W - f / df
        if abs(Wn - W) < 1e-14:
            return Wn
        W = Wn
    return W
