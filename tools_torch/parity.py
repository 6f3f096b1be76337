"""The reference-parity sweep configurations of `tools/reproduce.py`, as data.

`tools/reproduce.py` sweeps each target at the reference pickle's own k grid
(the pickles are not in the repository, so these take the case's own) with:
the numeric exterior (7 wavelengths for the slabs, 3 for the cylinder flow
tubes, `tools/targets_auto.py:135-136, 224-235`), the genuine continua
masked for bracket formation (`exclude_v_ranges`), reference-parity fuzz
acceptance, and `n_omega=384`, 24 brackets a row and `n_bisect=18` (f32,
refined in f64 with `accept_pct_refined=3.0`) or 50 (f64)
(reproduce.py:230-231, :270-304). slab_ph_3 also takes the band-edge
(needle) pass on its positive cusp edges, mode 0, merged into the main
sweep (reproduce.py:306-319).

`configure` builds a target with either package's modules, so the port
(`chip_smoke.py`) and the JAX package (`tests/test_torch_parity.py`, which
takes the JAX counts that `chip_smoke.py` holds) sweep the same
configuration. Nothing here imports torch or jax.
"""
from __future__ import annotations

import dataclasses

EXT7 = dict(exterior_method="numeric", exterior_wavelengths=7.0)
EXT3 = dict(exterior_method="numeric", exterior_wavelengths=3.0)

TARGETS = {
    # reproduce.py:26-32: windows above the cusp continuum, 0.9995/1.0005
    # around the c_i0 band edge
    "slab_ph_09": dict(
        case=("slab_density_photospheric", dict(width=0.9)),
        speeds=(0.8855, 0.905, 0.925, 0.945, 0.965, 0.985, 0.9995, 1.0005,
                1.04, 1.08, 1.12, 1.17, 1.23, 1.2999),
        grid=EXT7),
    # reproduce.py:100-108 (the band edges are the generating file's
    # characteristic speeds, +-0.51 ladder guards; the strided fuzz grid is
    # its 70-seed scan); the exterior as its sibling flow tubes take it
    # (targets_auto.py:224-235: the reference's finite 3-wavelength domain)
    "cyl_flow_1": dict(
        case=("cylinder_flow_coronal", dict(U=0.05, width=1.0)),
        speeds=(-4.999, -2.75325, -2.0, -1.0, -0.8944, -0.51,
                0.51, 0.8944, 1.0, 2.0, 2.75325, 4.999),
        grid=EXT3, n_omega=1519, fuzz_stride=22, fuzz_pct=6.0,
        max_brackets=24, fuzz_v_ranges=((0.8944, 4.999),),
        refine_scan_accept=2.0),
    # targets_auto.py:138-141 and reproduce.py:306-319 (its speeds come
    # from the pickle there; the case's own here)
    "slab_ph_3": dict(
        case=("slab_density_photospheric", dict(width=3.0)),
        grid=EXT7, needle=dict(modes=(0,), positive_only=True)),
}


def configure(name: str, cases, search_config, genuine_continua,
              dtype: str = "float64", k_stride: int = 1):
    """(case, SearchConfig, refine_f64) of target `name` at `dtype` with the
    modules of one package: `cases` its case module, `search_config` its
    SearchConfig class, `genuine_continua` its equilibrium function. f32
    sweeps are refined in f64 (reproduce.py --refine); every k_stride-th k
    of the case's grid."""
    spec = TARGETS[name]
    fac, kw = spec["case"]
    case = getattr(cases, fac)(**kw)
    case = dataclasses.replace(
        case, speeds=spec.get("speeds", case.speeds),
        grid=dataclasses.replace(case.grid, **spec["grid"]))
    if k_stride > 1:
        case = dataclasses.replace(
            case, k_values=tuple(float(k) for k in case.k_grid()[::k_stride]))
    refine = dtype == "float32"
    excl = tuple((lo, hi) for lo, hi, _ in genuine_continua(case))
    cfg = search_config(
        n_omega=spec.get("n_omega", 384),
        n_bisect=50 if dtype == "float64" else 18,
        scan_dtype=dtype, polish_dtype=dtype,
        max_brackets_per_row=spec.get("max_brackets", 24),
        exclude_v_ranges=excl or None,
        fuzz_accept_pct=spec.get("fuzz_pct", 3.0),
        fuzz_stride=spec.get("fuzz_stride", 1),
        fuzz_v_ranges=spec.get("fuzz_v_ranges"),
        accept_pct=spec.get("refine_scan_accept", 25.0) if refine else 1.0,
        accept_pct_refined=3.0 if refine else None)
    return case, cfg, refine


def needle_edges(name: str, case, needle_edges_fn):
    """The needle pass's edges of target `name` (its positive ones where
    the target says so), from either package's `sweep.needle_edges`."""
    edges = needle_edges_fn(case)
    if TARGETS[name]["needle"].get("positive_only"):
        edges = tuple(e for e in edges if e[0] > 0)
    return edges
