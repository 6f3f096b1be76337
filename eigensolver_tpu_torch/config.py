"""Declarative configuration of the MHD eigensolver (PyTorch port).

A copy of `eigensolver_tpu.config`, field for field: importing that module
runs `eigensolver_tpu/__init__.py`, which imports jax, and this package must
import without jax. `tests/test_torch_config.py` holds the two equal;
`from_jax` converts a JAX-package config into this one.

The reference (samuelskirvin/EIGENSOLVER) hard-codes every physical constant,
profile choice, grid range, tolerance and output filename per script, keeping
alternatives as commented-out blocks (e.g. `Slab/Non uniform density/Photospheric/
Solvers/multiprocessor_Inhomogeneous_method.py:71-141`). Here the whole case space
is one declarative config: {geometry, regime constants, profile family + params,
search grid, tolerances}.

Six reference physics configurations (SURVEY.md section 0) are exposed as
constructors in `eigensolver_tpu.cases`.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple


class Geometry(enum.Enum):
    SLAB = "slab"
    CYLINDER = "cylinder"


class ProfileKind(enum.Enum):
    """Equilibrium 1-D profile families (reference keeps these as commented
    alternatives; see `multiprocessor_Inhomogeneous_method.py:99-141`)."""

    UNIFORM = "uniform"
    GAUSSIAN = "gaussian"        # f_e + (f_0 - f_e) exp(-(x-x0)^2 / W^2)
    EPSTEIN = "epstein"          # (f_0 - f_e)/cosh(x/a)^4 ... (+ f_e)
    POWER_LAW = "power_law"      # v_twist * r^power (rotational flow)


@dataclasses.dataclass(frozen=True)
class ProfileConfig:
    """One 1-D profile: family + parameters."""

    kind: ProfileKind = ProfileKind.GAUSSIAN
    width: float = 1e5           # Gaussian std-dev W ("dx"/"dr" in the reference)
    center: float = 0.0          # Gaussian mean x0/r0
    amplitude: float = 1.0       # power-law amplitude (v_twist) when POWER_LAW
    power: float = 1.0           # power-law exponent when POWER_LAW


@dataclasses.dataclass(frozen=True)
class Regime:
    """Characteristic speeds of the internal/external plasma.

    All speeds are in units of the internal sound speed c_i0 = 1 unless noted.
    External density rho_e follows from total-pressure balance:
      rho_e = rho_i0 (c_i0^2 + g/2 vA_i0^2) / (c_e^2 + g/2 vA_e^2),  g = 5/3
    (reference: `multiprocessor_Inhomogeneous_method.py:79-80`).
    """

    c_i0: float = 1.0
    vA_i0: float = 1.9
    c_e: float = 1.3
    vA_e: float = 0.8
    rho_i0: float = 1.0
    gamma: float = 5.0 / 3.0
    # Background flow (slab: longitudinal U; cylinder: axial v_z, azimuthal twist)
    U_i0: float = 0.0
    U_e: float = 0.0
    v_z: float = 0.0
    # Some reference cases fix rho_e independently of pressure balance
    # (e.g. the complex KH file hard-codes rho_i=9, rho_e=5,
    # `flow_multiprocessor_complex_coronal.py:111-112`).
    rho_e_override: Optional[float] = None

    @property
    def rho_e(self) -> float:
        if self.rho_e_override is not None:
            return self.rho_e_override
        g = self.gamma
        return (
            self.rho_i0
            * (self.c_i0 ** 2 + g * 0.5 * self.vA_i0 ** 2)
            / (self.c_e ** 2 + g * 0.5 * self.vA_e ** 2)
        )

    @property
    def cT_i0(self) -> float:
        c2, a2 = self.c_i0 ** 2, self.vA_i0 ** 2
        return math.sqrt(c2 * a2 / (c2 + a2))

    @property
    def cT_e(self) -> float:
        c2, a2 = self.c_e ** 2, self.vA_e ** 2
        if c2 + a2 == 0.0:
            return 0.0
        return math.sqrt(c2 * a2 / (c2 + a2))

    @property
    def c_kink(self) -> float:
        num = self.rho_i0 * self.vA_i0 ** 2 + self.rho_e * self.vA_e ** 2
        return math.sqrt(num / (self.rho_i0 + self.rho_e))

    @property
    def B_0(self) -> float:
        return self.vA_i0 * math.sqrt(self.rho_i0)

    @property
    def B_e(self) -> float:
        return self.vA_e * math.sqrt(self.rho_e)

    @property
    def P_0(self) -> float:
        return self.c_i0 ** 2 * self.rho_i0 / self.gamma

    @property
    def P_e(self) -> float:
        return self.c_e ** 2 * self.rho_e / self.gamma


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Numerical discretisation of the integration domain and search plane."""

    n_interior: int = 2048       # fixed RK4 steps across the non-uniform layer
    n_exterior: int = 512        # fixed RK4 steps in the exterior region (cylinder)
    exterior_wavelengths: float = 3.0  # domain extent in units of 2*pi/k
    axis_epsilon: float = 1e-3   # cylinder axis cutoff (reference: r=0.001)
    # Log-spaced RK4 tail continuing the interior integration from
    # axis_epsilon down to axis_epsilon_final in t = ln r (regular: the 1/r
    # coefficient terms become O(1) in t) before imposing the axis BC.
    # Imposing P(eps)=0 / P'(eps)=0 at the reference's eps=1e-3 carries an
    # O(eps^2) eigenvalue bias - measured 4.9e-6 relative at the fast-band
    # top (ACCURACY_r04 worst roots; eps-scaling verified 1e-2 -> 4.8e-4,
    # 3e-3 -> 4.4e-5, 1e-3 -> 4.9e-6); the 1e-5 tail puts it at ~1e-10.
    # Twisted (rotational-flow) cases skip the tail: v_phi ~ r^(p-1) makes
    # the axis cutoff genuine physics there and the reference's eps=1e-3 is
    # part of the problem definition. Set axis_epsilon_final >=
    # axis_epsilon to disable.
    axis_epsilon_final: float = 1e-5
    n_axis_log: int = 128        # RK4 steps of the log-spaced axis tail
    # lax.scan unroll factor of the fixed-step RK4 integrators: several RK4
    # steps fuse into one loop iteration, amortising the TPU's fixed
    # per-iteration sequential overhead (which dominates a 2048-step scan of
    # a small elementwise body). Root positions are bit-identical - unrolling
    # changes scheduling, not arithmetic.
    scan_unroll: int = 1
    # cylinder exterior treatment: "bessel" evaluates the exact K_m logarithmic
    # derivative (special.kve_ratio - faster and exact); "numeric" integrates
    # the exterior ODE like the reference (`Density_cylinder.py:628-634`).
    exterior_method: str = "bessel"
    n_omega_ladder: int = 256    # omega seeds per (k, band) cell
    n_bisect: int = 60           # bisection iterations per bracket
    n_newton: int = 12           # Newton polish iterations (complex path)
    # omega-seed placement within each speed band:
    #   "uniform"   - even spacing (the reference's linspace seeding,
    #                 `multiprocessor_Inhomogeneous_method.py:793`)
    #   "chebyshev" - cos-map clustering toward BOTH band edges. Band edges
    #                 are characteristic speeds (cT, c, vA, c_kink) where
    #                 body-mode branches accumulate geometrically; quadratic
    #                 edge clustering resolves the high-order members of those
    #                 families at the same seed count (near-edge spacing
    #                 ~ width/n^2 instead of width/n).
    ladder_shape: str = "uniform"
    # Fraction of each speed band's width shaved off both band edges before
    # seeding the omega ladder (band edges sit on characteristic-speed
    # singularities; evaluating exactly there produces inf/NaN dets). 1e-3
    # is safe everywhere, but band edges that are NOT poles (e.g. c_kink in
    # the cylinder-flow band lists) can hide zeros inside the shaved margin:
    # the k=0.01 principal kink hugs c_kink at ~2.7e-4 of band width
    # (PARITY r04/r05 cyl_flow k=0.01 misses). Lower per-case when an
    # accumulation speed is a band edge.
    ladder_edge_shrink: float = 1e-3


@dataclasses.dataclass(frozen=True)
class Tolerances:
    p_tol: float = 3.0           # percent residual acceptance (reference p_tol)
    dedup_rel: float = 1e-4      # relative omega distance for dedup
    root_rel: float = 1e-7       # target relative accuracy of polished roots


@dataclasses.dataclass(frozen=True)
class CaseConfig:
    """A complete physics case: everything needed to produce an omega-k diagram."""

    name: str
    geometry: Geometry
    regime: Regime
    density_profile: ProfileConfig = ProfileConfig(kind=ProfileKind.UNIFORM)
    flow_profile: ProfileConfig = ProfileConfig(kind=ProfileKind.UNIFORM)
    twist_profile: Optional[ProfileConfig] = None   # POWER_LAW v_phi(r), cylinder only
    b_twist_profile: Optional[ProfileConfig] = None  # azimuthal field B_phi(r)
    # Search plane
    k_min: float = 0.01
    k_max: float = 3.5
    n_k: int = 35
    k_values: Optional[Tuple[float, ...]] = None  # explicit grid overrides linspace
    speeds: Tuple[float, ...] = ()       # phase-speed band edges (v = omega/k)
    modes: Tuple[int, ...] = (0, 1)      # azimuthal orders / parities to scan
    grid: GridConfig = GridConfig()
    tol: Tolerances = Tolerances()
    complex_omega: bool = False          # KH growth-rate search in complex omega
    imag_band: float = 0.25              # +/- range of Im(omega) seeds (reference
    #                                      `flow_multiprocessor_complex_coronal.py:1127`)
    # Shear-coefficient form for the non-uniform-flow slab. The reference keeps
    # TWO algebraic forms of D(x): the real Gaussian-flow solver ships the
    # legacy form (`flow_multiprocessor_coronal.py:317-318`), while the complex
    # KH solver replaced it (legacy kept commented out) with the corrected form
    # (`flow_multiprocessor_complex_coronal.py:381-385`). They differ (ratio
    # ~2.3 at typical points), displacing backward slow-band roots; pickle
    # parity requires matching the generating file's form.
    shear_D_legacy: bool = False

    def k_grid(self):
        import numpy as np
        if self.k_values is not None:
            return np.asarray(self.k_values, dtype=float)
        return np.linspace(self.k_min, self.k_max, self.n_k)

    def sorted_speeds(self) -> Tuple[float, ...]:
        return tuple(sorted(self.speeds))


def _convert(cls, value):
    """Rebuild `value` (a dataclass or enum of the JAX package, or plain
    data) as the port's `cls`, by duck typing: dataclasses field by field,
    enums by `.value`."""
    if isinstance(cls, type) and issubclass(cls, enum.Enum):
        return cls(value.value if isinstance(value, enum.Enum) else value)
    if dataclasses.is_dataclass(cls):
        kwargs = {}
        for f in dataclasses.fields(cls):
            v = getattr(value, f.name)
            sub = _FIELD_TYPES.get((cls, f.name))
            kwargs[f.name] = v if v is None or sub is None else _convert(sub, v)
        return cls(**kwargs)
    return value


# nested config types by (owner, field); every other field is plain data
_FIELD_TYPES = {
    (ProfileConfig, "kind"): ProfileKind,
    (CaseConfig, "geometry"): Geometry,
    (CaseConfig, "regime"): Regime,
    (CaseConfig, "density_profile"): ProfileConfig,
    (CaseConfig, "flow_profile"): ProfileConfig,
    (CaseConfig, "twist_profile"): ProfileConfig,
    (CaseConfig, "b_twist_profile"): ProfileConfig,
    (CaseConfig, "grid"): GridConfig,
    (CaseConfig, "tol"): Tolerances,
}


def from_jax(case) -> CaseConfig:
    """The port's `CaseConfig` equal to a JAX-package `CaseConfig`."""
    return _convert(CaseConfig, case)
