"""PyTorch/CUDA port of the MHD eigensolver, for an NVIDIA H100.

The JAX package `eigensolver_tpu` stays the reference; this package mirrors
its module names (`config`, `cases`, `profiles`, `equilibrium`, `special`,
`kernels.bessel`, `physics.slab`, `physics.cylinder`, `search`, `roots`,
`sweep`, `utils`). It imports torch and numpy and never jax.

Ported so far: the real-omega sweeps (`sweep.run_case`) of every slab case
and of the cylinder density and axial-flow tubes, and the f64 refinement of
f32 roots on the sweep's device, with three hand-written CUDA kernels for
sm_90a in `csrc/`: the K_m-ratio kernel (`kernels.bessel`, port of the
Pallas kernel `kve_ratio_pallas`), the fused cylinder dispersion kernel
(`kernels.cylinder`) and the fused slab dispersion kernel (`kernels.slab`).
What is not ported yet raises NotImplementedError naming its ROADMAP item.
"""
