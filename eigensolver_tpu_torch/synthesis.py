"""Wave-field synthesis (L5): radial eigenfunction -> 3-D/4-D fields (a copy
of `eigensolver_tpu.synthesis`, host-side numpy).

Replaces the reference's quadruple Python loop
(`Gaussian_flow_Cylinder_movie.py:836-858`) with broadcasting outer products
(one vectorised expression per component - the einsum form of
f(t,r,theta,z) = fhat(r) trig(m theta) trig(k z) trig(omega t)).

Phase conventions follow the reference exactly (`:839-846`):
  xi_r, PT, xi_z ~ cos(m theta);  xi_phi, v_phi ~ -sin(m theta);
  z-dependence cos(k z); time dependence cos(omega t) for displacements,
  sin(omega t) for velocities (v = d xi/dt with xi ~ cos(omega t) gives
  +omega sin phases - the reference folds this into radial_vr[t, i]).
Cartesian conversion per `:850-855`; boundary-surface advection per
`:866-875`; vorticity diagnostics per `Vorticity_gaussian_flow_3D.py:1004-1010`
(np.gradient curl).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .eigenfunctions import RadialEigenfunction


@dataclasses.dataclass
class FieldGrid:
    t: np.ndarray
    r: np.ndarray
    theta: np.ndarray
    z: np.ndarray

    @classmethod
    def standard(cls, omega: float, n_t: int = 20, r: Optional[np.ndarray] = None,
                 n_theta: int = 50, n_z: int = 19, z_max: float = 6.0):
        period = 2 * np.pi / abs(omega)
        return cls(
            t=np.linspace(0.0, period, n_t, endpoint=False),
            r=r if r is not None else np.linspace(0.01, 2.0, 100),
            theta=np.linspace(0, 2 * np.pi, n_theta),
            z=np.linspace(0.01, z_max, n_z),
        )


def _outer4(t_f, r_f, th_f, z_f):
    """(t,r,theta,z) = t x r x theta x z broadcast product."""
    return (t_f[:, None, None, None] * r_f[None, :, None, None]
            * th_f[None, None, :, None] * z_f[None, None, None, :])


def synthesize(ef: RadialEigenfunction, grid: FieldGrid,
               components: Sequence[str] = ("xi_r", "xi_phi", "xi_z", "P_T",
                                            "v_r", "v_phi", "v_z"),
               ) -> Dict[str, np.ndarray]:
    """4-D (t, r, theta, z) fields for the requested components, resampled
    onto grid.r by linear interpolation of the radial eigenfunction."""
    m, k, om = ef.mode, ef.k, ef.omega
    th, z, t = grid.theta, grid.z, grid.t

    cos_m = np.cos(m * th)
    msin_m = -np.sin(m * th)
    cos_kz = np.cos(k * z)
    sin_kz = np.sin(k * z)
    cos_wt = np.cos(om * t)
    sin_wt = np.sin(om * t)

    # (angular phase, z phase, t phase) per component, reference conventions
    phases = {
        "xi_r": (cos_m, cos_kz, cos_wt),
        "P_T": (cos_m, cos_kz, cos_wt),
        "xi_phi": (msin_m, cos_kz, cos_wt),
        "xi_z": (cos_m, sin_kz, cos_wt),
        "v_r": (cos_m, cos_kz, sin_wt),
        "v_phi": (msin_m, cos_kz, sin_wt),
        "v_z": (cos_m, sin_kz, sin_wt),
    }

    out: Dict[str, np.ndarray] = {}
    for name in components:
        prof = getattr(ef, name if name != "P_T" else "P_T")
        if prof is None:
            continue
        fr = np.interp(grid.r, ef.x, prof)
        thf, zf, tf = phases[name]
        out[name] = _outer4(tf, fr, thf, zf)
    return out


def add_background_flow(fields: Dict[str, np.ndarray], grid: FieldGrid,
                        v_phi0=None, v_z0=None) -> Dict[str, np.ndarray]:
    """Full-field variant: add the equilibrium rotation/axial flow to the
    velocity perturbations (the reference's 'full-field incl. background
    rotation' panels, `v01_p1_2D_kink_visualisation.py:2467-2559`).

    v_phi0 / v_z0: callables of r (e.g. eq.v_phi / eq.U_i as numpy-compatible
    functions) evaluated on grid.r and broadcast over (t, theta, z).
    """
    out = dict(fields)
    for name, prof_fn in (("v_phi", v_phi0), ("v_z", v_z0)):
        if prof_fn is None or name not in fields:
            continue
        prof = np.asarray(prof_fn(grid.r)).reshape(1, -1, 1, 1)
        out[name] = fields[name] + prof
    return out


def to_cartesian(fields: Dict[str, np.ndarray], grid: FieldGrid
                 ) -> Dict[str, np.ndarray]:
    """Add Cartesian components (`Gaussian_flow_Cylinder_movie.py:850-855`)."""
    cth = np.cos(grid.theta)[None, None, :, None]
    sth = np.sin(grid.theta)[None, None, :, None]
    out = dict(fields)
    for pre in ("xi", "v"):
        r_c, p_c = f"{pre}_r", f"{pre}_phi"
        if r_c in fields and p_c in fields:
            out[f"{pre}_x"] = fields[r_c] * cth - fields[p_c] * sth
            out[f"{pre}_y"] = fields[r_c] * sth + fields[p_c] * cth
    if "P_T" in fields:
        out["P_x"] = fields["P_T"] * cth
        out["P_y"] = fields["P_T"] * sth
    return out


def boundary_surface(fields: Dict[str, np.ndarray], grid: FieldGrid,
                     r0: float = 1.0, amplitude: float = 1.0):
    """Advected tube-boundary surface (x, y)(t, theta, z)
    (`Gaussian_flow_Cylinder_movie.py:866-875`)."""
    i_b = int(np.argmin(np.abs(grid.r - r0)))
    cth = np.cos(grid.theta)[None, :, None]
    sth = np.sin(grid.theta)[None, :, None]
    xi_x = fields["xi_x"][:, i_b]      # (t, theta, z)
    xi_y = fields["xi_y"][:, i_b]
    x = r0 * cth + amplitude * xi_x
    y = r0 * sth + amplitude * xi_y
    return x, y


def vorticity_3d(v_x: np.ndarray, v_y: np.ndarray, v_z: np.ndarray,
                 x: np.ndarray, y: np.ndarray, z: np.ndarray):
    """curl(v) on a regular Cartesian grid via central differences
    (`Vorticity_gaussian_flow_3D.py:1004-1010`). Inputs (x, y, z)-ordered."""
    dvz_dy = np.gradient(v_z, y, axis=1)
    dvy_dz = np.gradient(v_y, z, axis=2)
    dvx_dz = np.gradient(v_x, z, axis=2)
    dvz_dx = np.gradient(v_z, x, axis=0)
    dvy_dx = np.gradient(v_y, x, axis=0)
    dvx_dy = np.gradient(v_x, y, axis=1)
    return dvz_dy - dvy_dz, dvx_dz - dvz_dx, dvy_dx - dvx_dy


def cylindrical_to_cartesian_grid(fields: Dict[str, np.ndarray], grid: FieldGrid,
                                  n_xy: int = 64, t_index: int = 0,
                                  components: Sequence[str] = ("v_x", "v_y", "v_z")):
    """Resample one time slice onto a regular Cartesian grid (the reference
    uses scipy.interpolate.griddata cubic, `Vorticity_gaussian_flow_3D.py`;
    here bilinear in (r, theta) - adequate for the diagnostics)."""
    r_max = grid.r[-1]
    xs = np.linspace(-r_max, r_max, n_xy)
    ys = np.linspace(-r_max, r_max, n_xy)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    R = np.hypot(X, Y)
    TH = np.mod(np.arctan2(Y, X), 2 * np.pi)
    ir = np.clip(np.searchsorted(grid.r, R) - 1, 0, len(grid.r) - 2)
    it = np.clip(np.searchsorted(grid.theta, TH) - 1, 0, len(grid.theta) - 2)
    wr = (R - grid.r[ir]) / (grid.r[ir + 1] - grid.r[ir])
    wt = (TH - grid.theta[it]) / (grid.theta[it + 1] - grid.theta[it])
    wr = np.clip(wr, 0, 1)
    wt = np.clip(wt, 0, 1)

    out = {}
    for name in components:
        f = fields[name][t_index]       # (r, theta, z)
        interp = ((1 - wr)[..., None] * ((1 - wt)[..., None] * f[ir, it]
                                         + wt[..., None] * f[ir, it + 1])
                  + wr[..., None] * ((1 - wt)[..., None] * f[ir + 1, it]
                                     + wt[..., None] * f[ir + 1, it + 1]))
        interp[R > r_max] = 0.0
        out[name] = interp              # (x, y, z)
    return xs, ys, out


def vorticity_pipeline(ef: RadialEigenfunction, grid: Optional[FieldGrid] = None,
                       n_xy: int = 96, t_index: int = 0,
                       background_v_phi=None, background_v_z=None):
    """Eigenfunction -> regular-Cartesian velocity + vorticity snapshot.

    The one-call equivalent of the reference's vorticity scripts' data stage
    (`Vorticity_gaussian_flow_3D.py`: 4-D synthesis -> griddata resample ->
    np.gradient curl, `:1004-1010`): synthesize the 4-D fields, optionally add
    the background flow, convert to Cartesian components, resample the
    t_index snapshot onto a regular (x, y, z) grid, and take the
    central-difference curl.

    Returns (xs, ys, zs, vel, vort, PT) ready for
    `viz.vorticity_cut_figure`: vel = {"v_x","v_y","v_z"} on (x, y, z),
    vort = (vort_x, vort_y, vort_z), PT the resampled total pressure.
    """
    grid = grid or FieldGrid.standard(ef.omega)
    fields = synthesize(ef, grid)
    if background_v_phi is not None or background_v_z is not None:
        fields = add_background_flow(fields, grid, v_phi0=background_v_phi,
                                     v_z0=background_v_z)
    fields = to_cartesian(fields, grid)
    xs, ys, interp = cylindrical_to_cartesian_grid(
        fields, grid, n_xy=n_xy, t_index=t_index,
        components=("v_x", "v_y", "v_z", "P_T"))
    vel = {k: interp[k] for k in ("v_x", "v_y", "v_z")}
    vort = vorticity_3d(vel["v_x"], vel["v_y"], vel["v_z"], xs, ys, grid.z)
    return xs, ys, grid.z, vel, vort, interp["P_T"]
