"""The profile paths that no shipped case takes, as data.

`cases.py` mirrors the JAX package's cases, and none of them has a
power-law density or flow, or a twist profile other than a power law. A
user reaches those through `CaseConfig`; these six configurations do, each
a `dataclasses.replace` of a shipped case at its full grid:

- `pl_slab_flow`: `slab_flow_gaussian_coronal()` with the flow
  `POWER_LAW(amplitude=0.9, power=2)`: the shear form, U = 0.9 x^2;
- `pl_cyl_flow`: `cylinder_flow_coronal()` with the axial flow
  `POWER_LAW(1.0, 2.0)`;
- `pl_cyl_density`: `cylinder_density_coronal(0.9)` with the density
  `POWER_LAW(1.0, -0.5)` (rho = r^-1/2; its derivatives take `pow` at
  -1.5 and -2.5);
- `tw_gauss`: `cylinder_twisted_photospheric()` with a Gaussian (width
  0.5) `twist_profile`. The JAX package builds it with f0 = fe = 0, so
  v_phi is identically zero, while P_i still takes the profile's
  `amplitude` and `power` (their defaults, 1 and 1);
- `tw_epstein_b`: `cylinder_twisted_magnetic()` with an Epstein (width
  0.5) `b_twist_profile`: B_phi identically zero, likewise;
- `pl_slab_density`: `slab_density_photospheric(0.9)` with the density
  `POWER_LAW(1.0, 2.0)`: rho(0) = 0 at the slab's centre, so every
  determinant is non-finite and the sweep finds no root (in the JAX
  package too).

Each is swept by `run_case` with `SearchConfig(n_omega=256, n_bisect=18)`
at the dtype of the target. `TARGETS` holds the JAX package's counts per
branch on a CPU (JAX 0.9.0, x64): float64 as XLA compiles it
("float64"), and float32 compiled to round every operation once as the
port's kernels do ("float32_ieee": XLA_FLAGS="--xla_cpu_max_isa=AVX
--xla_disable_hlo_passes=algsimp"), from

    python tests/test_torch_profiles_paths.py jax-counts NAME float64
    python tests/test_torch_profiles_paths.py jax-counts NAME float32 --ieee

tw_gauss's f32 count is also held to the port's own CPU run
("float32_port_cpu", `python tests/test_torch_profiles_paths.py
port-counts tw_gauss float32`), see there.

`COMPLEX` names the two configurations also swept at complex omega
(`run_case_complex` at the CLI's defaults, on every `k_stride`-th k), and
`COMPLEX_TARGETS` holds the JAX package's float64 run there with its
per-seed verdicts (`kh.seed_verdicts`, packed by `kh.pack_mask`), from

    python tests/test_torch_profiles_paths.py jax-complex NAME

Nothing here imports torch or jax.
"""
from __future__ import annotations

import dataclasses

SEARCH_KW = dict(n_omega=256, n_bisect=18)
COMPLEX_RUN_KW = dict(n_re=12, n_im=10, newton_iters=30)

# name: (case factory, its keyword arguments, {field: (ProfileKind name,
# ProfileConfig keyword arguments)})
CONFIGS = {
    "pl_slab_flow": ("slab_flow_gaussian_coronal", {},
                     {"flow_profile": ("POWER_LAW",
                                       dict(amplitude=0.9, power=2.0))}),
    "pl_cyl_flow": ("cylinder_flow_coronal", {},
                    {"flow_profile": ("POWER_LAW",
                                      dict(amplitude=1.0, power=2.0))}),
    "pl_cyl_density": ("cylinder_density_coronal", dict(width=0.9),
                       {"density_profile": ("POWER_LAW",
                                            dict(amplitude=1.0,
                                                 power=-0.5))}),
    "tw_gauss": ("cylinder_twisted_photospheric", {},
                 {"twist_profile": ("GAUSSIAN", dict(width=0.5))}),
    "tw_epstein_b": ("cylinder_twisted_magnetic", {},
                     {"b_twist_profile": ("EPSTEIN", dict(width=0.5))}),
    "pl_slab_density": ("slab_density_photospheric", dict(width=0.9),
                        {"density_profile": ("POWER_LAW",
                                             dict(amplitude=1.0,
                                                  power=2.0))}),
}

# the configurations swept at complex omega: name -> k_stride
COMPLEX = {"pl_slab_flow": 7, "pl_cyl_density": 30}

# per configuration: run_case's counts per branch at float64 and at
# float32 compiled as IEEE rounds, its candidates, and the JAX
# package's wall on a CPU (JAX 0.9.0) at float64 and float32
TARGETS = {
    "pl_slab_flow": dict(
        float64={"sausage": 444, "kink": 357},
        float32_ieee={"sausage": 260, "kink": 217},
        candidates=179200, jax_wall_s=(36, 13)),
    "pl_cyl_flow": dict(
        float64={"sausage": 2153, "kink": 2879},
        float32_ieee={"sausage": 1191, "kink": 1629},
        candidates=599040, jax_wall_s=(506, 452)),
    "pl_cyl_density": dict(
        float64={"sausage": 1011, "kink": 3179},
        float32_ieee={"sausage": 658, "kink": 1460},
        candidates=552960, jax_wall_s=(490, 396)),
    "tw_gauss": dict(
        float64={"kink": 769},
        float32_ieee={"kink": 605},
        # the port's own f32 sweep on a CPU (port-counts): the twisted
        # chain's tangents (dual.py, closed-form profile derivatives) are
        # ordered otherwise than jax.jvp's, and with P_i's steep gradient
        # (amplitude 1) that moves the f32 count 1.5% from the
        # IEEE-compiled JAX package's; the card's f32 is held to this
        float32_port_cpu={"kink": 614},
        candidates=76800, jax_wall_s=(80, 65)),
    "tw_epstein_b": dict(
        float64={"kink": 142},
        float32_ieee={"kink": 142},
        candidates=76800, jax_wall_s=(112, 80)),
    "pl_slab_density": dict(
        float64={"sausage": 0, "kink": 0},
        float32_ieee={"sausage": 0, "kink": 0},
        candidates=161280, jax_wall_s=(8, 6)),
}

COMPLEX_TARGETS = {
    "pl_slab_flow": {
        "counts": {"sausage": 8, "kink": 6},
        "counts_off_axis": {"sausage": 0, "kink": 0},
        "completeness": {"cells": 100, "checked": 100, "agree": 100, "missed": 0, "fraction": 1.0},
        "candidates": 12000,
        "k_stride": 7,
        "counts_converged": {"sausage": 8, "kink": 6},
        "accepted": {"sausage": 3456, "kink": 4522},
        "converged": {"sausage": 3456, "kink": 4522},
        "seeds_accepted": {
            "sausage": (
                "eNpjYBgFxIL/owA7OH9giIQVACKSrvA="),
            "kink": (
                "eNpjYBiM4P8oQAb3Hz4YDStKwAdoWAEAayc0fA=="),
        },
        "seeds_converged": {
            "sausage": (
                "eNpjYBgFxIL/owA7OH9giIQVACKSrvA="),
            "kink": (
                "eNpjYBiM4P8oQAb3Hz4YDStKwAdoWAEAayc0fA=="),
        },
        # JAX 0.9.0, x64, on a CPU: the sweep 332 s, with the verdicts 772 s
    },
    "pl_cyl_density": {
        "counts": {"sausage": 8, "kink": 16},
        "counts_off_axis": {"sausage": 0, "kink": 0},
        "completeness": {"cells": 72, "checked": 72, "agree": 72, "missed": 0, "fraction": 1.0},
        "candidates": 8640,
        "k_stride": 30,
        "counts_converged": {"sausage": 8, "kink": 16},
        "accepted": {"sausage": 1294, "kink": 568},
        "converged": {"sausage": 1294, "kink": 568},
        "seeds_accepted": {
            "sausage": (
                "eNpjYBiCwP4/AvwZHM7ACz5/wFD8588ZBjn2BgaG+v1ASQZmZhDJwMR44P57"
                "bCb8YUhcIACxtUKO//CHP/YgQo698UGFHDOmy/7///4DymRv/lDBwMDBbvzw"
                "z39SwMcHDACGPKKF"),
            "kink": (
                "eNpjYBgFxABmLGL8Bx8Qb4D9fxRwAGLoQSYGBkYFIJPxAYMiEaYoCDBUyAHt"
                "rZBjZjhggBB3aECwGRVaIGILBA4Y8IAcLsTAALKPT/4/CeAPAwCBPUew"),
        },
        "seeds_converged": {
            "sausage": (
                "eNpjYBiCwP4/AvwZHM7ACz5/wFD8588ZBjn2BgaG+v1ASQZmZhDJwMR44P57"
                "bCb8YUhcIACxtUKO//CHP/YgQo698UGFHDOmy/7///4DymRv/lDBwMDBbvzw"
                "z39SwMcHDACGPKKF"),
            "kink": (
                "eNpjYBgFxABmLGL8Bx8Qb4D9fxRwAGLoQSYGBkYFIJPxAYMiEaYoCDBUyAHt"
                "rZBjZjhggBB3aECwGRVaIGILBA4Y8IAcLsTAALKPT/4/CeAPAwCBPUew"),
        },
        # JAX 0.9.0, x64, on a CPU: the sweep 1457 s, with the verdicts 3412 s
    },
}


def configure(name: str, cases, config, **grid):
    """The case `name` built with one package's `cases` and `config`
    modules; `grid` replaces fields of its GridConfig (a test's reduced
    depth)."""
    fac, fac_kw, fields = CONFIGS[name]
    case = getattr(cases, fac)(**fac_kw)
    profiles = {f: config.ProfileConfig(kind=getattr(config.ProfileKind, kind),
                                        **kw)
                for f, (kind, kw) in fields.items()}
    return dataclasses.replace(
        case, **profiles, grid=dataclasses.replace(case.grid, **grid))


def search_config(search_cls, dtype: str):
    """The sweep's SearchConfig at `dtype` (one package's class)."""
    return search_cls(**SEARCH_KW, scan_dtype=dtype, polish_dtype=dtype)


def complex_case(name: str, cases, config, k_stride: int = None, **grid):
    """The case `name` made complex, on every k_stride-th k of its grid
    (default: COMPLEX's), and run_case_complex's keyword arguments."""
    case = dataclasses.replace(configure(name, cases, config, **grid),
                               complex_omega=True)
    k_stride = COMPLEX[name] if k_stride is None else k_stride
    if k_stride > 1:
        case = dataclasses.replace(
            case, k_values=tuple(float(k) for k in case.k_grid()[::k_stride]))
    return case, dict(COMPLEX_RUN_KW)
