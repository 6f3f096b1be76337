"""PyTorch/CUDA port of the MHD eigensolver, for an NVIDIA H100.

The JAX package `eigensolver_tpu` stays the reference; this package mirrors
its module names and imports torch, numpy, scipy and (for figures only)
matplotlib, never jax.

Ported, every compute entry on an explicit device:

- the real-omega sweeps (`sweep.run_case`) of every slab case (flux and
  shear forms), the cylinder density and axial-flow tubes and the twisted
  tubes, with the f64 refinement, the reference-parity options (numeric
  exteriors, continuum masks, fuzz acceptance, the pole pre-filter) and the
  band-edge (needle) pass;
- the complex-omega sweeps (`sweep.run_case_complex`) of every slab and
  cylinder case: the Kelvin-Helmholtz growth rates, the density slabs,
  the density, axial-flow and twisted cylinders, with the exact or the
  numeric exterior, with the argument-principle audit;
- the sharded sweep (`parallel.run_case_sharded`): a real-omega sweep's
  rows split over several devices, and over processes joined by
  `parallel.init_distributed`;
- the crash-safe sweeps (`sweep.run_case_checkpointed`,
  `run_case_complex_checkpointed`) over the checkpoint store
  (`native.store`), and the reference pickles (`roots.save_pickle`,
  `load_pickle`);
- eigenfunctions (`eigenfunctions`, on `ode.rk4_trajectory`), analysis
  (`analysis`, `analytic`), field synthesis (`synthesis`), figures and
  movies (`viz`), VTK export (`io.vtk`, `native.vtk_native`) and the CLI
  (`python -m eigensolver_tpu_torch`, `cli`).

The hand-written CUDA kernels for sm_90a (`csrc/`, built at first use by
`kernels._build`): `kve_ratio` (port of the Pallas kernel
`kve_ratio_pallas`, `kernels.bessel`), the cylinder scan `cylinder_disp`
with its twisted variant and the fused bisection `cylinder_bisect`
(`kernels.cylinder`), the slab scan `slab_disp` (paired, and its numeric-
exterior variants) and the fused bisection `slab_bisect` (`kernels.slab`),
the complex-omega kernel behind `slab_newton` and `slab_disp_complex`
(the shear and the flux form, either exterior), and the cylinder's behind
`cylinder_newton` and `cylinder_disp_complex` (every chain, the K_m ratio
at complex z or the numeric exterior). On a CPU tensor each wrapper runs
its kernel's plain PyTorch version.

Not ported to the card: power-law density or flow profiles and twist
profiles other than power laws, which no case uses (ROADMAP A 2; the
plain versions run them on the CPU).
"""
