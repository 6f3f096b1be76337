"""PyTorch/CUDA port of the MHD eigensolver, for an NVIDIA H100.

The JAX package `eigensolver_tpu` stays the reference; this package mirrors
its module names (`config`, `cases`, `profiles`, `equilibrium`, `special`,
`kernels.bessel`, `physics.cylinder`, `search`, `roots`, `sweep`, `utils`).
It imports torch and numpy and never jax.

Ported so far: the cylinder omega-k sweep for the density and axial-flow
tubes (`sweep.run_case` on e.g. `cases.cylinder_density_coronal`), with two
hand-written CUDA kernels for sm_90a in `csrc/`: the K_m-ratio kernel
(`kernels.bessel`, port of the Pallas kernel `kve_ratio_pallas`) and the
fused cylinder dispersion kernel (`kernels.cylinder`). What is not ported
yet raises NotImplementedError naming its ROADMAP item.
"""
