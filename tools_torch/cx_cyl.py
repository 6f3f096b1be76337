"""The complex-omega cylinder sweeps, as data.

`run_case_complex` at the CLI's defaults (12 x 10 Newton seeds per (k,
band) cell, 30 Newton steps, float64, the argument-principle audit on) on
two configurations that the JAX package's CLI reaches with `sweep
--complex` (`eigensolver_tpu/cli.py:91-98`, which makes any case complex):

- `cx_cyl_co_09`: `cases.cylinder_density_coronal(0.9)` with
  complex_omega=True: 90 k x 12 bands x 120 = 129,600 seeds a mode, modes
  (0, 1), n_interior = 2048 and the 128-step log tail, the exact exterior
  (the K_m ratio at complex z);
- `cx_twist_v01_p1`: `cases.cylinder_twisted_photospheric(0.1, 1.0, 1)`
  with complex_omega=True: the twisted chain with the jump term, 60 k x 5
  bands x 120 = 36,000 seeds, mode 1, n_interior = 1536.

`TARGETS` holds what `run_case_complex` of the JAX package gives on a CPU
in float64, from

    python tests/test_torch_complex_cylinder.py jax-counts NAME --k-stride N

on every N-th k of the configuration's grid (`k_stride`: every 30th and
every 6th k, 27 and 13 minutes on a CPU; the full grids would take hours): per branch `counts`, the roots off the
real axis by the audit's margin (`counts_off_axis`), the per-seed
verdicts (`kh.seed_verdicts`: accepted, converged after one more Newton
step) packed as `kh.pack_mask` packs them, and `counts_converged`, the
roots the converged accepted seeds give; the audit's `completeness`. The
card runs the full sweep and compares the seeds of those k
(`subset_seeds`). Nothing here imports torch or jax.
"""
from __future__ import annotations

import dataclasses

import numpy as np

RUN_KW = dict(n_re=12, n_im=10, newton_iters=30)

# name: (case factory, its keyword arguments, fields set on the case,
# exterior_method)
CONFIGS = {
    "cx_cyl_co_09": ("cylinder_density_coronal", dict(width=0.9),
                     dict(complex_omega=True), "bessel"),
    "cx_twist_v01_p1": ("cylinder_twisted_photospheric",
                        dict(v_twist=0.1, power=1.0, mode=1),
                        dict(complex_omega=True), "bessel"),
}

TARGETS = {
    "cx_cyl_co_09": {
        "counts": {"sausage": 7, "kink": 5},
        "counts_off_axis": {"sausage": 0, "kink": 0},
        "completeness": {"cells": 72, "checked": 72, "agree": 72, "missed": 0, "fraction": 1.0},
        "candidates": 8640,
        "k_stride": 30,
        "counts_converged": {"sausage": 7, "kink": 5},
        "accepted": {"sausage": 200, "kink": 296},
        "converged": {"sausage": 200, "kink": 296},
        "seeds_accepted": {
            "sausage": (
                "eNpjYBjqoEVxSNjLzMBQ8R8EUIUNaGcvDzLnAHY19v9RwP2HD6B6gc5lAAAG"
                "ARlC"),
            "kink": (
                "eNpjYBjCwGBQuYYZr6z9fyigg0s8iFYJdxUm+MMAAI/hI9Q="),
        },
        "seeds_converged": {
            "sausage": (
                "eNpjYBjqoEVxSNjLzMBQ8R8EUIUNaGcvDzLnAHY19v9RwP2HD6B6gc5lAAAG"
                "ARlC"),
            "kink": (
                "eNpjYBjCwGBQuYYZr6z9fyigg0s8iFYJdxUm+MMAAI/hI9Q="),
        },
        # JAX 0.9.0, x64, on a CPU: the sweep 919 s, with the verdicts 1604 s
    },
    "cx_twist_v01_p1": {
        "counts": {"kink": 18},
        "counts_off_axis": {"kink": 0},
        "completeness": {"cells": 50, "checked": 50, "agree": 50, "missed": 0, "fraction": 1.0},
        "candidates": 6000,
        "k_stride": 6,
        "counts_converged": {"kink": 18},
        "accepted": {"kink": 5520},
        "converged": {"kink": 5520},
        "seeds_accepted": {
            "kink": (
                "eNrjYWY4YMBDFeL/KBgFgxsAAIIVr20="),
        },
        "seeds_converged": {
            "kink": (
                "eNrjYWY4YMBDFeL/KBgFgxsAAIIVr20="),
        },
        # JAX 0.9.0, x64, on a CPU: the sweep 394 s, with the verdicts 785 s
    },
}


def configure(name: str, cases, **case_kw):
    """(case, run_case_complex's keyword arguments) of `name` with one
    package's `cases` module; `case_kw` replaces case fields (a test's
    reduced k grid); `n_interior`, `n_axis_log`, `n_exterior` and
    `exterior_method` there set the grid's."""
    fac, fac_kw, fields, exterior = CONFIGS[name]
    case = getattr(cases, fac)(**fac_kw)
    grid_kw = {key: case_kw.pop(key) for key in
               ("n_interior", "n_axis_log", "n_exterior", "exterior_method")
               if key in case_kw}
    grid_kw.setdefault("exterior_method", exterior)
    case = dataclasses.replace(
        case, **fields, **case_kw,
        grid=dataclasses.replace(case.grid, **grid_kw))
    return case, dict(RUN_KW)


def strided(case, k_stride: int):
    """The case on every k_stride-th k of its grid (the case itself at 1)."""
    if k_stride == 1:
        return case
    return dataclasses.replace(
        case, k_values=tuple(float(k) for k in case.k_grid()[::k_stride]))


def subset_seeds(case, k_stride: int, n_re: int = 12,
                 n_im: int = 10) -> np.ndarray:
    """The indices, in the full sweep's seed order (per k, per band, n_re
    x n_im), of the seeds of every k_stride-th k: the seeds of the strided
    case's sweep, in its order."""
    n_cell = n_re * n_im * (len(case.speeds) - 1)
    ks = np.arange(0, case.n_k, k_stride)
    return (ks[:, None] * n_cell + np.arange(n_cell)[None, :]).reshape(-1)
