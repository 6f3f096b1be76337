"""Hand-written CUDA kernels (sources in ../csrc) and their wrappers."""
from . import bessel  # noqa: F401


def launch_counts() -> dict:
    """Each wrapper's count of kernel launches since its module's counter
    was last set to 0 (`slab_paired`: the candidates through the paired
    scan; `slab_complex_flux`, `slab_complex_numeric`: the complex-omega
    kernel's launches in the flux form, with the numeric exterior, of
    those counted under `slab_disp_complex` and `slab_newton`;
    `cylinder_complex_twisted`, `cylinder_complex_numeric`: the cylinder's
    complex-omega launches of the twisted chain, with the numeric
    exterior, of those counted under `cylinder_disp_complex` and
    `cylinder_newton`)."""
    from . import bessel, cylinder, slab
    return {"cylinder_disp": cylinder.launches,
            "cylinder_disp_small": cylinder.small_launches,
            "cylinder_bisect": cylinder.bisect_launches,
            "cylinder_disp_complex": cylinder.complex_launches,
            "cylinder_newton": cylinder.newton_launches,
            "cylinder_complex_twisted": cylinder.complex_twisted_launches,
            "cylinder_complex_numeric": cylinder.complex_numeric_launches,
            "slab_disp": slab.launches, "slab_bisect": slab.bisect_launches,
            "slab_paired": slab.paired,
            "slab_disp_complex": slab.complex_launches,
            "slab_newton": slab.newton_launches,
            "slab_complex_flux": slab.complex_flux_launches,
            "slab_complex_numeric": slab.complex_numeric_launches,
            "kve_ratio": bessel.launches,
            "kve_ratio_complex": bessel.complex_launches}
