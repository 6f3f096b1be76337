"""Visualization (L6): dispersion diagrams, eigenfunction profiles, 2-D
cross-section animations and mp4 export (a copy of `eigensolver_tpu.viz`).

Capability parity with the reference's matplotlib layers: dispersion plots
with characteristic-speed lines (`multiprocessor_Inhomogeneous_method.py:
838-1087`), multi-panel eigenfunction figures (`analysis_compare_coronal_
eigenfunctions_coronal.py`), contourf+quiver cross-section animations with
boundary tracking (`v01_p1_2D_kink_visualisation.py:2444-2559`) and
FuncAnimation+ffmpeg movies (`Gaussian_flow_Cylinder_movie.py:1166-1232`).

Everything here is host-side matplotlib on already-computed arrays; headless
(Agg) by default.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from .analysis import BranchFit
from .config import Regime
from .eigenfunctions import RadialEigenfunction
from .roots import RootSet
from .synthesis import FieldGrid


SPEED_STYLES = {
    "c_i0": ("k", "dashdot"), "cT_i0": ("k", "dotted"),
    "c_e": ("b", "dashdot"), "vA_e": ("b", "dotted"), "c_kink": ("r", "dashed"),
}


def dispersion_diagram(rs: RootSet, rg: Regime, path: Optional[str] = None,
                       fits: Optional[Dict[str, Dict[str, Sequence[BranchFit]]]] = None,
                       v_lim: Optional[tuple] = None, title: str = "",
                       analytic: Optional[Dict] = None):
    """omega/k vs k scatter per mode family + characteristic-speed lines
    (the reference's headline figure). `analytic`: {branch: RootBranch} from
    `analytic.analytic_curves`, drawn as the "known dispersion" underlay
    exactly like the reference's validation figures
    (`flow_multiprocessor.py:356,904,937`)."""
    fig, ax = plt.subplots(figsize=(8, 6))
    colors = {"sausage": "r", "kink": "b"}
    if analytic:
        for name, br in analytic.items():
            if len(br) == 0:
                continue
            ax.plot(br.ks, br.phase_speeds(), "x", ms=3, mew=0.6, color="0.6",
                    label=f"{name} (analytic)", zorder=1)
    for name, br in rs.branches.items():
        if len(br) == 0:
            continue
        ax.plot(br.ks, br.phase_speeds(), ".", ms=3,
                color=colors.get(name, "g"), label=name)
    for sname, (c, ls) in SPEED_STYLES.items():
        v = getattr(rg, sname, None)
        if v:
            ax.axhline(y=v, color=c, linestyle=ls, lw=0.8)
            ax.annotate(f"${sname}$", xy=(ax.get_xlim()[1], v), fontsize=9)
    if fits:
        for mode_fits in fits.values():
            for wfits in mode_fits.values():
                for bf in wfits:
                    kk = np.linspace(*bf.k_range, 100)
                    ax.plot(kk, bf(kk), "-", lw=0.8, color="0.4")
    ax.set_xlabel("$k x_0$")
    ax.set_ylabel(r"$\omega / k$")
    if v_lim:
        ax.set_ylim(*v_lim)
    if title:
        ax.set_title(title)
    ax.legend(loc="best", fontsize=8)
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def multi_width_overlay(root_sets: Dict[str, RootSet], rg: Regime,
                        path: Optional[str] = None, branch: str = "kink",
                        continuum: Optional[Sequence[tuple]] = None,
                        title: str = ""):
    """Overlay dispersion diagrams of several profile widths with shaded
    continuum bands (the reference analysis headline figure:
    `analysis_photospheric.py:336-344` multi-width overlays;
    `analysis_cylinder_coronal_09.py` tail `fill_between` of the
    boundary-value speed ranges).

    root_sets: {label: RootSet}; continuum: [(v_lo, v_hi, label), ...] bands
    (e.g. the cusp continuum [cT_bound, cT_i0]).
    """
    fig, ax = plt.subplots(figsize=(8, 6))
    cyc = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    k_max = 0.0
    for i, (label, rs) in enumerate(root_sets.items()):
        br = rs.branches.get(branch)
        if br is None or len(br) == 0:
            continue
        ax.plot(br.ks, br.phase_speeds(), ".", ms=3, color=cyc[i % len(cyc)],
                label=label)
        k_max = max(k_max, float(np.max(br.ks)))
    if continuum:
        for v_lo, v_hi, lbl in continuum:
            ax.fill_between([0, k_max or 1.0], v_lo, v_hi, color="0.85",
                            zorder=0)
            ax.annotate(lbl, xy=(0.02 * (k_max or 1.0), 0.5 * (v_lo + v_hi)),
                        fontsize=8, color="0.4")
    for sname, (c, ls) in SPEED_STYLES.items():
        v = getattr(rg, sname, None)
        if v:
            ax.axhline(y=v, color=c, linestyle=ls, lw=0.8)
    ax.set_xlabel("$k x_0$")
    ax.set_ylabel(r"$\omega / k$")
    if title:
        ax.set_title(title)
    ax.legend(loc="best", fontsize=8)
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def growth_rate_diagram(rs: RootSet, rg: Regime, path: Optional[str] = None,
                        title: str = "", kh_threshold: Optional[float] = None):
    """Two-panel Kelvin-Helmholtz figure: Re(omega)/k vs k (phase speed) and
    Im(omega) vs k (growth rate), unstable roots highlighted - the capability
    of the reference's complex-analysis plots
    (`complex_imag_flow_analysis.py:224-230` loads real+imag pickle arrays and
    plots growth rates vs k).

    kh_threshold: optional analytic KH-onset shear speed; drawn as an
    annotation on the growth panel.
    """
    fig, (ax_re, ax_im) = plt.subplots(
        2, 1, figsize=(8, 8), sharex=True,
        gridspec_kw={"height_ratios": [2, 1]})
    colors = {"sausage": "r", "kink": "b"}
    for name, br in rs.branches.items():
        if len(br) == 0:
            continue
        c = colors.get(name, "g")
        im = br.omegas_imag if br.omegas_imag is not None else np.zeros_like(br.omegas)
        stable = np.abs(im) <= 1e-12
        ax_re.plot(br.ks[stable], br.omegas[stable] / br.ks[stable], ".",
                   ms=3, color=c, label=f"{name} (stable)")
        ax_re.plot(br.ks[~stable], br.omegas[~stable] / br.ks[~stable], "o",
                   ms=4, mfc="none", color=c, label=f"{name} (unstable)")
        ax_im.plot(br.ks, im, ".", ms=3, color=c)
    for sname, (c, ls) in SPEED_STYLES.items():
        v = getattr(rg, sname, None)
        if v:
            ax_re.axhline(y=v, color=c, linestyle=ls, lw=0.8)
    ax_im.axhline(y=0.0, color="k", lw=0.6)
    if kh_threshold is not None:
        ax_im.annotate(f"KH onset $U > {kh_threshold:.3g}$",
                       xy=(0.02, 0.9), xycoords="axes fraction", fontsize=8)
    ax_re.set_ylabel(r"$\mathrm{Re}\,\omega / k$")
    ax_im.set_ylabel(r"$\mathrm{Im}\,\omega$  (growth rate)")
    ax_im.set_xlabel("$k x_0$")
    if title:
        ax_re.set_title(title)
    ax_re.legend(loc="best", fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def eigenfunction_figure(efs: Sequence[RadialEigenfunction],
                         labels: Optional[Sequence[str]] = None,
                         components: Sequence[str] = ("P_T", "xi_r"),
                         path: Optional[str] = None):
    """Multi-panel radial eigenfunction overlay (one panel per component, one
    curve per eigenfunction - the reference's multi-width comparison layout)."""
    n = len(components)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), squeeze=False)
    for j, comp in enumerate(components):
        ax = axes[0][j]
        for i, ef in enumerate(efs):
            y = getattr(ef, comp)
            if y is None:
                continue
            norm = np.max(np.abs(y)) or 1.0
            lbl = labels[i] if labels else f"v={ef.omega/ef.k:.4f}"
            ax.plot(ef.x, y / norm, lw=1.0, label=lbl)
        ax.axvline(x=1.0, color="k", lw=0.6, linestyle="dashed")
        ax.set_xlabel("$r/x_0$")
        ax.set_ylabel(rf"$\hat{{{comp}}}$".replace("P_T", "P_T").replace("_", r"\_"))
        if j == 0:
            ax.legend(fontsize=7)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def cross_section_frame(fields: Dict[str, np.ndarray], grid: FieldGrid,
                        t_index: int = 0, z_index: int = 0,
                        boundary: Optional[tuple] = None, ax=None,
                        quiver_stride: int = 4):
    """contourf(P_T) + quiver(v) polar cross-section at fixed (t, z)
    (`v01_p1_2D_kink_visualisation.py:2467-2559`)."""
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(6, 6))
    R, TH = np.meshgrid(grid.r, grid.theta, indexing="ij")
    X = R * np.cos(TH)
    Y = R * np.sin(TH)
    PT = fields["P_T"][t_index, :, :, z_index]
    ax.contourf(X, Y, PT, levels=25, cmap="RdBu_r")
    if "v_x" in fields:
        s = quiver_stride
        ax.quiver(X[::s, ::s], Y[::s, ::s],
                  fields["v_x"][t_index, ::s, ::s, z_index],
                  fields["v_y"][t_index, ::s, ::s, z_index],
                  scale=None, width=0.003)
    if boundary is not None:
        bx, by = boundary
        ax.plot(bx[t_index, :, z_index], by[t_index, :, z_index], "k-", lw=1.2)
    ax.set_aspect("equal")
    return ax.figure


def animate_cross_section(fields: Dict[str, np.ndarray], grid: FieldGrid,
                          path: str, z_index: int = 0, fps: int = 10,
                          boundary: Optional[tuple] = None) -> str:
    """mp4 (ffmpeg; falls back to .gif via Pillow when ffmpeg is missing)."""
    from matplotlib import animation

    fig, ax = plt.subplots(figsize=(6, 6))
    n_t = fields["P_T"].shape[0]

    def frame(ti):
        ax.clear()
        cross_section_frame(fields, grid, t_index=ti, z_index=z_index,
                            boundary=boundary, ax=ax)
        return []

    ani = animation.FuncAnimation(fig, frame, frames=n_t, blit=False)
    try:
        writer = animation.FFMpegWriter(fps=fps)
        ani.save(path, writer=writer)
    except (FileNotFoundError, RuntimeError):
        path = path.rsplit(".", 1)[0] + ".gif"
        ani.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path


def vorticity_cut_figure(xs: np.ndarray, ys: np.ndarray, zs: np.ndarray,
                         vel: Dict[str, np.ndarray],
                         vort: tuple, PT: Optional[np.ndarray] = None,
                         cut: str = "z", index: Optional[int] = None,
                         path: Optional[str] = None, quiver_stride: int = 3,
                         title: Optional[str] = None):
    """Velocity + vorticity cut-plane panels on a regular Cartesian grid.

    Reproduces the reference's vorticity figure class
    (`Vorticity_gaussian_flow_vert_cut.py:1007-1078`: contourf(P_T) +
    quiver(v) beside contourf(transverse vorticity) + quiver(in-plane
    vorticity); horizontal-cut variant `Vorticity_gaussian_flow.py`;
    y-vertical variant `Vorticity_gaussian_flow_yvert_cut.py`; the 3-D
    all-components view `Vorticity_gaussian_flow_3D.py:993-1042`).

    xs, ys, zs: 1-D grid axes; vel: {"v_x","v_y","v_z"} arrays (x, y, z);
    vort: (vort_x, vort_y, vort_z) from `synthesis.vorticity_3d`;
    PT: optional total-pressure array for the velocity panel background;
    cut: "z" = horizontal x-y plane (contour vort_z), "y" = vertical x-z
    plane (contour vort_y), "x" = vertical y-z plane (contour vort_x);
    index: slice index along the cut axis (default: mid-plane).
    """
    wx, wy, wz = vort
    axis = {"x": 0, "y": 1, "z": 2}[cut]
    n = (len(xs), len(ys), len(zs))[axis]
    i = n // 2 if index is None else int(index)
    s = quiver_stride

    def sl(a):
        return np.take(a, i, axis=axis)

    if cut == "z":
        A, B = np.meshgrid(xs, ys, indexing="ij")
        la, lb = "x", "y"
        v_a, v_b = sl(vel["v_x"]), sl(vel["v_y"])
        w_a, w_b, w_c = sl(wx), sl(wy), sl(wz)
    elif cut == "y":
        A, B = np.meshgrid(xs, zs, indexing="ij")
        la, lb = "x", "z"
        v_a, v_b = sl(vel["v_x"]), sl(vel["v_z"])
        w_a, w_b, w_c = sl(wx), sl(wz), sl(wy)
    elif cut == "x":
        A, B = np.meshgrid(ys, zs, indexing="ij")
        la, lb = "y", "z"
        v_a, v_b = sl(vel["v_y"]), sl(vel["v_z"])
        w_a, w_b, w_c = sl(wy), sl(wz), sl(wx)
    else:
        raise ValueError(f"cut must be x, y or z, got {cut!r}")

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 5))
    if PT is not None:
        ax1.contourf(A, B, sl(PT), levels=25, cmap="RdBu_r", alpha=0.5,
                     extend="both")
    ax1.quiver(A[::s, ::s], B[::s, ::s], v_a[::s, ::s], v_b[::s, ::s],
               pivot="tail", width=0.003)
    ax1.set_xlabel(la)
    ax1.set_ylabel(lb)
    ax1.set_title("velocity" + (" + $P_T$" if PT is not None else ""))

    cf = ax2.contourf(A, B, w_c, levels=25, cmap="bwr", alpha=0.6,
                      extend="both")
    ax2.quiver(A[::s, ::s], B[::s, ::s], w_a[::s, ::s], w_b[::s, ::s],
               pivot="tail", width=0.003)
    fig.colorbar(cf, ax=ax2, shrink=0.85)
    comp = {"z": r"$\omega_z$", "y": r"$\omega_y$", "x": r"$\omega_x$"}[cut]
    ax2.set_xlabel(la)
    ax2.set_ylabel(lb)
    ax2.set_title(f"vorticity ({comp} contours)")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def vorticity_3d_figure(xs: np.ndarray, ys: np.ndarray, zs: np.ndarray,
                        vel: Dict[str, np.ndarray], vort: tuple,
                        boundary: Optional[tuple] = None,
                        path: Optional[str] = None,
                        quiver_stride: tuple = (8, 8, 3),
                        title: Optional[str] = None):
    """Native 3-D all-components vorticity view.

    Reproduces `Vorticity_gaussian_flow_3D.py:993-1042`: one 3-D axes with
    the advected tube-boundary points and a subsampled 3-D velocity quiver,
    beside a second 3-D axes with the full vorticity-vector quiver (the
    reference interpolates with griddata first; our fields are already on
    the regular Cartesian grid from `synthesis.vorticity_pipeline`).

    xs, ys, zs: 1-D grid axes; vel: {"v_x","v_y","v_z"} on (x, y, z);
    vort: (vort_x, vort_y, vort_z); boundary: optional (bx, by) arrays
    (theta, z) of the advected tube surface (one time slice) plotted as
    scattered points at each z.
    """
    sx, sy, sz = quiver_stride
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    fig = plt.figure(figsize=(12, 6))
    ax1 = fig.add_subplot(1, 2, 1, projection="3d")
    ax2 = fig.add_subplot(1, 2, 2, projection="3d")

    def _bound(ax):
        if boundary is None:
            return
        bx, by = boundary
        bz = np.broadcast_to(np.asarray(zs)[None, :], bx.shape)
        ax.scatter(bx, by, bz, s=4.0, c="blue", depthshade=False)

    _bound(ax1)
    ax1.quiver(X[::sx, ::sy, ::sz], Y[::sx, ::sy, ::sz], Z[::sx, ::sy, ::sz],
               vel["v_x"][::sx, ::sy, ::sz], vel["v_y"][::sx, ::sy, ::sz],
               vel["v_z"][::sx, ::sy, ::sz], pivot="tail", length=0.025,
               normalize=False, linewidth=0.5)
    ax1.set_xlabel("$x$")
    ax1.set_ylabel("$y$")
    ax1.set_zlabel("$z$")
    ax1.set_title("velocity")

    wx, wy, wz = vort
    _bound(ax2)
    ax2.quiver(X[::sx, ::sy, ::sz], Y[::sx, ::sy, ::sz], Z[::sx, ::sy, ::sz],
               wx[::sx, ::sy, ::sz], wy[::sx, ::sy, ::sz],
               wz[::sx, ::sy, ::sz], pivot="tail", length=0.01,
               normalize=False, linewidth=0.5, color="firebrick")
    ax2.set_xlabel("$x$")
    ax2.set_ylabel("$y$")
    ax2.set_zlabel("$z$")
    ax2.set_title("vorticity (all components)")
    if title:
        fig.suptitle(title)
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def tube_3d_frame(fields: Dict[str, np.ndarray], grid: FieldGrid,
                  boundary: tuple, t_index: int = 0,
                  z_indices: tuple = (0, -1), axes=None,
                  quiver_stride: int = 6):
    """One frame of the 3-D advected-tube view: a 3-D `plot_surface` of the
    displaced boundary beside two cross-section panels (contourf(P_T) +
    quiver(v) + boundary ring) at the chosen z slices - the reference's
    movie layout (`Gaussian_flow_Cylinder_movie.py:1166-1232`: ax 3-D
    surface, ax2 z=0 cut, ax3 upper-z cut)."""
    bx, by = boundary                      # (t, theta, z)
    zi = [z if z >= 0 else len(grid.z) + z for z in z_indices]
    if axes is None:
        fig = plt.figure(figsize=(12, 6))
        ax3d = fig.add_subplot(1, 2, 1, projection="3d")
        axc = [fig.add_subplot(2, 3, 3), fig.add_subplot(2, 3, 6)]
    else:
        ax3d, axc = axes[0], list(axes[1:])
        fig = ax3d.figure
    BZ = np.broadcast_to(grid.z[None, :], bx.shape[1:])
    ax3d.plot_surface(bx[t_index], by[t_index], BZ, color="b", alpha=0.5)
    r_max = float(grid.r[-1])
    ax3d.set_xlim(-r_max, r_max)
    ax3d.set_ylim(-r_max, r_max)
    ax3d.set_xlabel("$x$")
    ax3d.set_ylabel("$y$")
    ax3d.set_zlabel("$z$")
    for ax, z_i in zip(axc, zi):
        cross_section_frame(fields, grid, t_index=t_index, z_index=z_i,
                            boundary=(bx, by), ax=ax,
                            quiver_stride=quiver_stride)
        ax.set_title(f"z = {grid.z[z_i]:.3g}")
    return fig


def animate_tube_3d(fields: Dict[str, np.ndarray], grid: FieldGrid,
                    path: str, boundary: Optional[tuple] = None,
                    z_indices: tuple = (0, -1), fps: int = 5) -> str:
    """3-D advected-tube-surface movie (mp4 via ffmpeg; .gif fallback) -
    the native reproduction of `Gaussian_flow_Cylinder_movie.py:1166-1232`."""
    from matplotlib import animation

    from .synthesis import boundary_surface

    if boundary is None:
        boundary = boundary_surface(fields, grid)
    fig = plt.figure(figsize=(12, 6))
    ax3d = fig.add_subplot(1, 2, 1, projection="3d")
    axc1 = fig.add_subplot(2, 3, 3)
    axc2 = fig.add_subplot(2, 3, 6)
    n_t = fields["P_T"].shape[0]

    def frame(ti):
        ax3d.clear()
        axc1.clear()
        axc2.clear()
        tube_3d_frame(fields, grid, boundary, t_index=ti,
                      z_indices=z_indices, axes=(ax3d, axc1, axc2))
        return []

    ani = animation.FuncAnimation(fig, frame, frames=n_t, blit=False)
    try:
        writer = animation.FFMpegWriter(fps=fps)
        ani.save(path, writer=writer)
    except (FileNotFoundError, RuntimeError):
        path = path.rsplit(".", 1)[0] + ".gif"
        ani.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path
