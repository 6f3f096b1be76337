"""Hand-written CUDA kernels (sources in ../csrc) and their wrappers."""


def launch_counts() -> dict:
    """Each wrapper's count of kernel launches since its module's counter
    was last set to 0 (`slab_paired`: the candidates through the paired
    scan)."""
    from . import bessel, cylinder, slab
    return {"cylinder_disp": cylinder.launches,
            "cylinder_disp_small": cylinder.small_launches,
            "cylinder_bisect": cylinder.bisect_launches,
            "slab_disp": slab.launches, "slab_bisect": slab.bisect_launches,
            "slab_paired": slab.paired,
            "slab_disp_complex": slab.complex_launches,
            "slab_newton": slab.newton_launches,
            "kve_ratio": bessel.launches}
