"""The reference's physics configurations as declarative configs.

Each constructor mirrors one reference solver script's hard-coded constants
(regime speeds, profile, k grid, speed bands); see the per-case citations.
The reference keeps these as whole-file copies - here they are data.
"""
from __future__ import annotations

from .config import (
    CaseConfig,
    Geometry,
    GridConfig,
    ProfileConfig,
    ProfileKind,
    Regime,
)


def slab_density_photospheric(width: float = 0.9) -> CaseConfig:
    """`Slab/Non uniform density/Photospheric/Solvers/
    multiprocessor_Inhomogeneous_method.py:70-103` - vA_i0=1.9, vA_e=0.8,
    c_e=1.3, Gaussian density of std-dev `width`; k in [0.01, 3.5] x 35.
    Phase-speed window: slow-body band [cT_i0, c_i0] widened to the boundary
    speeds for non-uniform widths (`:174-186`)."""
    rg = Regime(c_i0=1.0, vA_i0=1.9, c_e=1.3, vA_e=0.8)
    return CaseConfig(
        name=f"slab_density_photospheric_w{width:g}",
        geometry=Geometry.SLAB,
        regime=rg,
        density_profile=ProfileConfig(kind=ProfileKind.GAUSSIAN, width=width),
        k_min=0.01, k_max=3.5, n_k=35,
        speeds=(0.845, 0.88, 0.92, 0.96, 1.0, 1.05, 1.1, 1.16, 1.22, 1.3),
        modes=(0, 1),
    )


def slab_density_coronal(width: float = 0.9) -> CaseConfig:
    """`Slab/Non uniform density/Coronal/Solvers/
    multiprocessor_Inhomogeneous_method_coronal.py` - vA_e=3, c_e=0.4 regime."""
    rg = Regime(c_i0=1.0, vA_i0=1.2, c_e=0.4, vA_e=3.0)
    return CaseConfig(
        name=f"slab_density_coronal_w{width:g}",
        geometry=Geometry.SLAB,
        regime=rg,
        density_profile=ProfileConfig(kind=ProfileKind.GAUSSIAN, width=width),
        k_min=0.045, k_max=3.5, n_k=35,
        speeds=(0.72, 0.78, 0.85, 0.92, 1.0, 1.1, 1.2, 1.5, 2.0, 2.5, 2.99),
        modes=(0, 1),
    )


def slab_flow_uniform_photospheric() -> CaseConfig:
    """`Slab/Non uniform flow/Solver/flow_multiprocessor.py:60-100` - uniform
    slab with external flow U_e = -0.15 vA_i (validated against the analytic
    tanh/tan relations `:117-127`)."""
    rg = Regime(c_i0=2.0 / 3.0, vA_i0=1.0, c_e=3.0 / 4.0, vA_e=1e-12,
                U_i0=0.0, U_e=-0.15)
    return CaseConfig(
        name="slab_flow_uniform_photospheric",
        geometry=Geometry.SLAB,
        regime=rg,
        density_profile=ProfileConfig(kind=ProfileKind.UNIFORM),
        flow_profile=ProfileConfig(kind=ProfileKind.UNIFORM),
        k_min=0.01, k_max=3.5, n_k=35,
        speeds=(0.3, 0.45, 0.56, 0.66, 0.75, 0.9, 1.0),
        modes=(0, 1),
    )


def slab_flow_gaussian_coronal(width: float = 1.0, U_i0: float = 0.9) -> CaseConfig:
    """`Slab/Non uniform flow/Solver/flow_multiprocessor_coronal.py:60-126` -
    coronal uniform-density slab with internal Gaussian flow U_i(x)."""
    rg = Regime(c_i0=0.3, vA_i0=1.0, c_e=0.2, vA_e=2.5, U_i0=U_i0, U_e=0.0)
    return CaseConfig(
        name=f"slab_flow_gaussian_coronal_w{width:g}",
        geometry=Geometry.SLAB,
        regime=rg,
        density_profile=ProfileConfig(kind=ProfileKind.UNIFORM),
        flow_profile=ProfileConfig(kind=ProfileKind.GAUSSIAN, width=width),
        k_min=0.01, k_max=3.5, n_k=35,
        speeds=(0.21, 0.28, 0.35, 0.5, 0.7, 0.9, 1.1, 1.4, 1.8, 2.2, 2.49),
        modes=(0, 1),
    )


def slab_flow_complex_coronal(width: float = 1e5, U_i0: float = 1.4) -> CaseConfig:
    """`Slab/Non uniform flow/COMPLEX ANALYSIS/flow_multiprocessor_complex_
    coronal.py:104-120` - Kelvin-Helmholtz growth-rate search in complex omega:
    vA_i=1, c_i=1.3, vA_e=0, rho_i=9, rho_e=5 (independent of balance),
    c_e = sqrt((rho_i/rho_e) c_i^2 + g/2 vA_i^2) (the file's own expression),
    U_i0=1.4, Gaussian width 1e5 (`:165`); imag seed band +-0.25 (`:1127`);
    k in [0.01, 2.5] x 20, speeds [-0.5, 0, 0.5, 1] (`:231`)."""
    import math
    c_i, vA_i = 1.3, 1.0
    rho_i, rho_e = 9.0, 5.0
    g = 5.0 / 3.0
    c_e = math.sqrt((rho_i / rho_e) * c_i**2 + g * 0.5 * vA_i**2)
    rg = Regime(c_i0=c_i, vA_i0=vA_i, c_e=c_e, vA_e=1e-12, rho_i0=rho_i,
                rho_e_override=rho_e, U_i0=U_i0, U_e=0.0)
    return CaseConfig(
        name=f"slab_flow_complex_coronal_w{width:g}",
        geometry=Geometry.SLAB,
        regime=rg,
        density_profile=ProfileConfig(kind=ProfileKind.UNIFORM),
        flow_profile=ProfileConfig(kind=ProfileKind.GAUSSIAN, width=width),
        k_min=0.01, k_max=2.5, n_k=20,
        speeds=(-0.5, 0.0, 0.5, 1.0),
        modes=(1,),
        complex_omega=True,
        imag_band=0.25,
    )


def cylinder_density_coronal(width: float = 0.9) -> CaseConfig:
    """`Cylinder/Non-uniform density/Coronal/solvers/Density_cylinder.py:68-80`
    - vA_e=5, vA_i0=2, c_e=0.5; k in [0.01, 4.5] x 90; band edges at the
    characteristic speeds incl. backward branches (`:225`)."""
    rg = Regime(c_i0=1.0, vA_i0=2.0, c_e=0.5, vA_e=5.0)
    return CaseConfig(
        name=f"cylinder_density_coronal_w{width:g}",
        geometry=Geometry.CYLINDER,
        regime=rg,
        density_profile=ProfileConfig(kind=ProfileKind.GAUSSIAN, width=width),
        k_min=0.01, k_max=4.5, n_k=90,
        speeds=(-5.0, -2.0, -1.0, -0.5, 0.5, 0.9, 0.95, 1.0, 1.5, 2.0, 3.0,
                4.0, 5.0),
        modes=(0, 1),
    )


def cylinder_density_photospheric(width: float = 0.9) -> CaseConfig:
    """`Cylinder/Non-uniform density/Photospheric/Solvers/
    Density_cylinder_photospheric.py` - vA_e=0.5, vA_i0=2(?), c_e=1.5 regime
    with slow-mode bands."""
    rg = Regime(c_i0=1.0, vA_i0=2.0, c_e=1.5, vA_e=0.5)
    return CaseConfig(
        name=f"cylinder_density_photospheric_w{width:g}",
        geometry=Geometry.CYLINDER,
        regime=rg,
        density_profile=ProfileConfig(kind=ProfileKind.GAUSSIAN, width=width),
        k_min=0.01, k_max=4.5, n_k=90,
        speeds=(0.85, 0.89, 0.92, 0.95, 1.0, 1.1, 1.2, 1.35, 1.49),
        modes=(0, 1),
    )


def cylinder_flow_coronal(U: float = 1.0, width: float = 0.9) -> CaseConfig:
    """`Cylinder/Non-uniform flow/Coronal/solvers/Cylinder_method_flow_testing.py`
    - coronal tube, UNIFORM density (`:145-146`), Gaussian axial flow v_z(r)
    of amplitude U (`:134-135`), shift_freq = omega - m v_phi/r - k v_z(r)
    (`:577-578`)."""
    rg = Regime(c_i0=1.0, vA_i0=2.0, c_e=0.5, vA_e=5.0, U_i0=U, U_e=0.0)
    return CaseConfig(
        name=f"cylinder_flow_coronal_U{U:g}",
        geometry=Geometry.CYLINDER,
        regime=rg,
        density_profile=ProfileConfig(kind=ProfileKind.UNIFORM),
        flow_profile=ProfileConfig(kind=ProfileKind.GAUSSIAN, width=width),
        k_min=0.01, k_max=4.0, n_k=90,
        speeds=(-5.0, -2.0, -1.0, -0.5, 0.5, 0.9, 1.0, 1.2, 1.6, 2.0, 2.6,
                3.2, 4.0, 5.0),
        modes=(0, 1),
    )


def cylinder_twisted_photospheric(v_twist: float = 0.1, power: float = 1.0,
                                  mode: int = 1) -> CaseConfig:
    """`Cylinder/Rotational flow/Photospheric/Solvers/Twisted_photospheric_*`
    - photospheric tube (vA_e=0.5, c_e=1.5, vA_i0=2) with rotational flow
    v_phi = v_twist r^power; variants differ only in (m, v_twist, power,
    speed windows) per the 4-file diff (SURVEY.md S10)."""
    rg = Regime(c_i0=1.0, vA_i0=2.0, c_e=1.5, vA_e=0.5)
    return CaseConfig(
        name=f"cylinder_twisted_photospheric_v{v_twist:g}_p{power:g}_m{mode}",
        geometry=Geometry.CYLINDER,
        regime=rg,
        density_profile=ProfileConfig(kind=ProfileKind.UNIFORM),
        twist_profile=ProfileConfig(kind=ProfileKind.POWER_LAW,
                                    amplitude=v_twist, power=power),
        k_min=0.15, k_max=4.0, n_k=60,
        speeds=(0.9, 1.0, 1.1, 1.2, 1.3, 1.4),
        modes=(mode,),
        grid=GridConfig(axis_epsilon=0.01,
                        n_interior=1536 if v_twist < 0.2 else 2048),
        # Resolution policy (measured r05): at v_twist <= 0.15 the 1536-step
        # interior gives refined parity rates/medians IDENTICAL to 2048
        # (twist_v01_p1 101/102 med 2.005e-3; v015 sfast 160/160) at -25%
        # wall; at v_twist = 0.25 the sausage slow branches LOSE 11 matched
        # roots at 1536 (sharper v_phi^2 pressure gradient), so strong
        # twists keep the full 2048 steps.
    )


def cylinder_twisted_magnetic(B_twist: float = 0.1, v_twist: float = 0.0,
                              power: float = 1.0, mode: int = 1) -> CaseConfig:
    """Magnetic-twist variant of the rotational-flow tube: azimuthal field
    B_phi(r) = B_twist * r with pressure-balanced longitudinal field
    B_z = B_0 sqrt(1 - 2 B_phi^2/B_0^2) (`Twisted_photospheric_flow_sausage.py:
    167-173`, the file's kept-but-disabled `B_twist*r` branch). A LINEAR
    B_phi makes the magnetic terms of the radial force balance cancel
    identically (-B_phi B_phi' + B_phi^2/r = 0), so the equilibrium stays
    exact with the flow-balanced P_i(r). Optional rotational flow v_phi =
    v_twist r^power on top reproduces the combined twist configuration."""
    rg = Regime(c_i0=1.0, vA_i0=2.0, c_e=1.5, vA_e=0.5)
    return CaseConfig(
        name=(f"cylinder_twisted_magnetic_B{B_twist:g}_v{v_twist:g}"
              f"_p{power:g}_m{mode}"),
        geometry=Geometry.CYLINDER,
        regime=rg,
        density_profile=ProfileConfig(kind=ProfileKind.UNIFORM),
        twist_profile=ProfileConfig(kind=ProfileKind.POWER_LAW,
                                    amplitude=v_twist, power=power),
        b_twist_profile=ProfileConfig(kind=ProfileKind.POWER_LAW,
                                      amplitude=B_twist, power=1.0),
        k_min=0.15, k_max=4.0, n_k=60,
        speeds=(0.9, 1.0, 1.1, 1.2, 1.3, 1.4),
        modes=(mode,),
        grid=GridConfig(axis_epsilon=0.01,
                        n_interior=1536 if v_twist < 0.2 else 2048),
        # same resolution policy as cylinder_twisted_photospheric
    )


ALL_CASES = {
    "slab_density_photospheric": slab_density_photospheric,
    "slab_density_coronal": slab_density_coronal,
    "slab_flow_uniform_photospheric": slab_flow_uniform_photospheric,
    "slab_flow_gaussian_coronal": slab_flow_gaussian_coronal,
    "slab_flow_complex_coronal": slab_flow_complex_coronal,
    "cylinder_density_coronal": cylinder_density_coronal,
    "cylinder_density_photospheric": cylinder_density_photospheric,
    "cylinder_flow_coronal": cylinder_flow_coronal,
    "cylinder_twisted_photospheric": cylinder_twisted_photospheric,
    "cylinder_twisted_magnetic": cylinder_twisted_magnetic,
}
