#!/usr/bin/env python3
"""Smoke run of the PyTorch port (eigensolver_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--json-out PATH]

Run from the repository root. Phases, one line each (9, 12 and 13 in two,
17 in five, 18 in two, 19 in four, 20 in eight or nine, 21 in
seven, 22 in six, 23 in six, 24 in fifteen, 25 in five, 26 in seven);
any failure raises and the script exits non-zero:

1. device: a CUDA card is required; its nvidia-smi name and power limit.
2. build: the CUDA kernels, compiled with nvcc from eigensolver_tpu_torch/csrc
   (one nvcc per source, in parallel).
3. kve_ratio: the standalone kernel once on the exterior arguments
   sqrt(m_e) > 0 of the cyl_co_09 ladder (552,600 of 552,960; launch
   counters reset just before), then, at float32 and float64, on four
   argument sets (series only, CF2 only, 552,960 shuffled over both
   branches, and the ladder's arguments in ladder order): bit-equal to its
   plain PyTorch version on each, and timed beside the torch.special call at
   both types. No sweep launches it: its math runs inside cylinder_disp.
4. cylinder_disp kernel vs its plain PyTorch version (at a quarter of the
   depth, timed at the full one), 8,192 candidates of
   the full cyl_co_09 ladder (n_interior=2048, n_axis_log=128); at the full
   sweep's 552,960 candidates, the kernel's time and, at float32, the plain
   version's time and agreement; the sweep's own scan in ladder order,
   timed, every candidate through its block's (k, m, r) row table
   (kernels.cylinder.scan_tabled); the row layouts (tools_torch/
   batches.py::row_layout_batches:
   runs of 1519, 256, 37 and 1 candidates, a run through the continua with
   exact pole points, random draws, refine windows) bit-equal to the plain
   version at both types, with the candidates each took through the
   table; the kernel's registers and spills (ptxas), its tables' shared
   memory and, printed, the float64 det values whose bits differ from the
   plain version's.
5. the cylinder sweep: run_case(cylinder_density_coronal(0.9), n_omega=256,
   n_bisect=18, float32) on the card - once with the launch counters reset
   (exactly one cylinder_disp launch, the ladder scan, and one
   cylinder_bisect launch, the bracket stage; never the plain dispersion),
   then 3 timed runs, then once at float64; root counts per branch held
   against the JAX package's for the same configuration; a reduced sweep on
   the card held against the same sweep on the CPU.
6. slab_disp kernel vs its plain version, 8,192 candidates of the full
   slab_ph_09 ladder (flux form) and of slab_flow_gaussian_coronal (shear
   form); at each sweep's scan size (161,280 and 179,200 candidates) and
   at float32 and float64, the unpaired scan on random draws and the
   paired scan (both parities of an (omega, k) in one thread, every
   candidate counted as paired) on the sweep's whole ladder in ladder
   order, beside the unpaired scan's time there: each kernel's time, its
   bound (the paired one's beside the bound of 3 chains a step for every
   candidate), and the plain version's time and bits on the same
   candidates; the unpaired scan at the size of the refine stage's
   float64 window launch (the 1,530 window ends of the slab_ph_09 float32
   sweep's roots), none counted as paired; the launch shape of each, and
   the kernels' registers and spills (ptxas). Every set bit-equal at both
   types (the 8,192 draws, the random draws and the window ends at a
   quarter of the depth, the paired scans at the full one).
7. the slab sweep: run_case(slab_density_photospheric(0.9), n_omega=256,
   n_bisect=18, float32) with the counters reset (one slab_disp launch,
   the paired scan, every candidate counted as paired, and one
   slab_bisect launch, never the plain dispersion), 3 timed runs, one
   float64 run, float64 sweeps of the two flow cases (each scan paired),
   float32 sweeps with
   refine_f64=True (4 launches each: the scan, the bracket stage, the f64
   refine windows, unpaired, and the f64 refine bisection; once, then 3
   timed runs);
   counts per branch held against the JAX package's; reduced sweeps on the
   card (float64, and float32 refined in float64) held against the same
   sweeps on the CPU.
8. cylinder_bisect and 9. slab_bisect, the fused bracket stage
   (csrc/bisect.cuh::spec_kernel over the scans' r-only / x-only tables),
   on the full sweeps' own brackets (cyl_co_09's 17,280, slab_ph_09's 5,040
   in the flux form and slab_flow_gaussian_coronal's 5,600 in the shear
   form) at float32 and float64: (root, mismatch) bit-equal to
   search.bisect_loop over the scan kernel (n_iter + 2 launches), both
   timed; at n_iter=1 bit-equal to the same loop over the plain PyTorch
   dispersion, at both types, which is timed too (at a quarter of the
   depth, `shallower`, the kernel's bisection too). Phase 9 also takes
   the refine stage of the slab_ph_09 float32 sweep (its 153 roots' float64
   brackets, 30 iterations): at the speculative default L and at L = 0
   bit-equal to the launch loop, all three timed, and at 5 iterations
   bit-equal to the plain speculative bisection at the same L. Each
   prints the registers and spills of the fused kernel's instantiations
   over its chain (ptxas).
10. the twisted cylinder_disp (csrc/cylinder_twisted.cu, for rotational
   flow and magnetic twist) vs its plain version, 8,192 candidates of the
   full twist_v01_p1 ladder (cylinder_twisted_photospheric(0.1, 1.0, 1)) and
   of the magnetic p = 1.25 one (cylinder_twisted_magnetic(0.1, 0.15, 1.25,
   1)), float32 and float64, through both paths (the small-batch fused
   evaluation, which a batch this size takes, and the scan), bit-equal at
   a quarter of the depth (n_interior 384) and timed at the full one; each
   case's whole 76,800-candidate scan (ladder order, m = 1) timed at both
   types beside its bound, twist_v01_p1's plain version's time and bits at
   float32 (at a quarter of the depth); the refine stage's float64 window ends of the twist_v01_p1
   float32 sweep (3,090) through both paths, timed, bit-equal at a quarter
   of the depth; the
   registers, local (spill) bytes, shared memory and blocks per SM of each
   default launch shape of the twisted kernels, and the ptxas report of
   every cylinder_disp and twisted instantiation.
11. the twisted sweeps: run_case(twist_v01_p1, n_omega=256, n_bisect=18,
   float32) with the counters reset (one cylinder_disp and one
   cylinder_bisect launch, never the plain dispersion), 3 timed runs, float64
   sweeps of twist_v01_p1 and of the magnetic case, float32 runs with
   refine_f64=True (4 launches, the window launch through the small-batch
   path; once, then 3 timed runs); counts held against the JAX package's;
   a reduced magnetic sweep with the row-local continuum mask on the card
   held against the same sweep on the CPU and the JAX package's count.
12. the twisted cylinder_bisect (the speculative kernel) on twist_v01_p1's
   own 2,400 brackets, as in phase 8 (its plain loop at n_iter=1, a
   quarter of the depth), and at every level count L = 0..5 bit-equal to
   the launch loop; the refine stage's bisection of the float32 sweep's
   309 roots (float64, 30 iterations) at every L, bit-equal to its launch
   loop, timed; its default launch (L = 3) at 5 iterations and a quarter
   of the depth bit-equal to the plain speculative bisection at the same L
   over the plain dispersion. Every
   L's bound counts the evaluations the loop needs.
13. the numeric exteriors (B6, exterior_method="numeric"), the kernels'
   variants against their plain versions, bit for bit at float32 and
   float64: slab_disp in both forms and cylinder_disp on ragged batches of
   8,191 ladder draws (the parity configurations of slab_ph_09 and
   cyl_flow_1, tools_torch/parity.py; a Gaussian-flow slab at 3
   wavelengths; the unpaired scan; at a quarter of the depth,
   n_interior=512 and n_exterior=128, as the plain loops below);
   cylinder_disp on phase 4's row
   layouts of cyl_flow_1, with the candidates through the row and the
   exps' tables; each whole parity scan in ladder order (349,440 and
   3,007,620) timed beside its bound, the plain version's time and bits
   (the slab's through the paired scan, every candidate counted, beside
   the unpaired scan's time and the old bound; the cylinder's every
   candidate through both tables);
   slab_bisect and cylinder_bisect (the speculative kernel over the scans'
   tables) on the parity sweeps' own brackets (21,840 and 47,520)
   bit-equal to the launch loop, at a quarter of the depth on that
   configuration's own brackets to the plain loop (1 iteration), and
   on their first 600 at the speculative default L to the launch loop;
   cylinder_bisect with its block shape, its launch's columns through
   the row table and the tabled exps (kernels.cylinder.bisect_counts,
   held to bisect_tabled_columns: every column of the parity batches),
   its kept chains, its bound with them and with 3 chains a step, and
   the ptxas registers and spills of both SpecChain instantiations; the
   twisted scan, its small-batch path and its speculative bisection at a
   reduced depth (twist_v01_p1 at 3 wavelengths, n_interior=384, 600
   brackets; the plain loop at the default L); then the twisted variant on
   a reduced sweep of its own (its launches).
14. the reference-parity sweeps on the card: slab_ph_09 and cyl_flow_1 at
   float32 refined in float64 (5 launches) and at float64 (2), each with
   the counters reset just before it (slab_ph_09's scan paired, every
   candidate counted, its windows and re-judge not), then 3 timed runs
   (walls, stage walls); counts per branch held against the JAX package's
   (PARITY_COUNTS; cyl_flow_1 at full width at float64, and on every 9th
   k at both types); slab_ph_3's float64 sweep,
   its needle pass (2 launches, none paired; 3 timed) and their merge,
   against JAX's.
15. the Bessel/numeric oracle of tests/test_special.py:101-132 at the full
   grid: cylinder_density_coronal(1e5), k = 1, 801 points, m = 1, the
   roots of the two exteriors within rtol 1e-6.
16. the needle oracle of tests/test_needle.py:61-87: slab_ph_3 at k =
   0.43303 and slab_co_15 at k = 0.080505, each reference entry within
   3e-3 of a root of the needle pass.
17. the shear form's complex-omega kernel (csrc/slab_complex.cu: the
   producer/consumer newton_kernel behind slab_newton and
   slab_disp_complex) on the full-width
   Kelvin-Helmholtz layer (slab_flow_complex_coronal(width=1.0),
   tools_torch/kh.py: n_interior=2048, float64): slab_newton on the 7,200
   Newton seeds at n_iter=1 bit-equal to the plain loop over the dual
   shoot (both timed; every check against a plain version here at a
   quarter of the depth, n_interior 512); the main path's 30 steps as 30
   chained one-step launches (each step's ms, its non-finite omegas and
   those whose
   imaginary part has reached the bottom of the exponent range) and as one
   launch, bit-equal, timed beside its bound, and with the final
   evaluation in the same launch (timed); slab_disp_complex, the kernel's
   evaluation mode, at the main path's batches, the 7,200 Newton roots
   (those of the Newton launch at the check's depth) and the audit's
   30,720 contour points, and at float32 on a ragged 8,191 of those
   points, bit-equal to its plain version, as is the Newton launch's own
   value round at the roots (all timed); the registers and
   spills of the complex slab kernels' instantiations (ptxas).
18. the complex-omega sweeps: run_case_complex of
   slab_flow_complex_coronal at its published settings (7,200 seeds, 30
   Newton steps, the audit of 60 cells), at width 1e5 and 1.0, on the
   card in float64, each once with the counters reset (one slab_newton
   launch, the roots' evaluation its last round, and one slab_disp_complex,
   the audit; never the plain dispersion), then 3 timed runs; held to the JAX
   package's (tools_torch/kh.py): the roots off the real axis by the
   audit's margin and the audit's completeness exactly, every checked
   cell agreeing and none missed, the largest growth rate to 1e-8 at the
   same k; per seed (kh.seed_verdicts: the Newton pass again and one step
   further, after the counted run), every seed converged both here and in
   the JAX package's run accepted alike, and the converged accepted seeds'
   roots counted exactly (kh.TARGETS' counts_converged); the total count
   exactly where the JAX package's unconverged accepted seeds add no root
   to those (width 1e5), else reported beside the JAX package's (width
   1.0: its unconverged seeds near the flow continuum land by rounding);
   at width 1e5 the largest growth rate held to the Doppler-tanh relation
   within 2e-6 (tests/test_complex_kh.py:42-55).
19. the crash-safe sweeps (sweep.run_case_checkpointed, k blocks of 8, each
   on a fresh store): slab_ph_09 at float32 and float64 (5 blocks: 5
   slab_disp launches, every candidate through the paired scan, and 5
   slab_bisect), each root and count equal to run_case's at the same
   config (rtol 1e-12; bit-equal printed) and its counts to the JAX
   package's; the finished store again (no launch, no candidate, the same
   roots); the first 16 k alone, then the whole grid on that store (2,
   then 3 blocks); cyl_co_09 float32 (12 blocks: 12 cylinder_disp, 12
   cylinder_bisect); kh_w1e5 through run_case_complex_checkpointed (3
   blocks, 3 slab_newton launches, no audit; 49 roots, omega and Im omega
   equal to run_case_complex's); the store's writer and each path's wall.
20. the CLI, each command a `python -m eigensolver_tpu_torch` process on
   the default device (cuda): the slab_ph_09 sweep (the CLI's
   SearchConfig(n_omega=256), float32), without and with --checkpoint, its
   counts, launches and pickle against an in-process run_case; the KH
   sweep with --complex --checkpoint (49 roots; its pickle the kink-only
   2-array layout; its store's growth rates equal to run_case_complex's);
   analyze and eigenfunction on the slab pickle (with --plot, and
   --analytic, where matplotlib imports), vtk on it and on phase 19's
   cyl_co_09 roots, movie --frames 4 on those where matplotlib imports;
   each wall, the kernel library's load time (loaded, not built again).
21. the eigenfunctions on the card (float64, eager PyTorch shoots): slab
   roots of slab_ph_09 (kink, sausage) and slab_flow_gaussian_coronal
   (the shear form), cylinder roots of cyl_co_09 (m = 0, 1) and
   twist_v01_p1, each field within 1e-10 of its largest value of the same
   call on the CPU (1e-9 within 10 axis cutoffs of the axis, where the
   card's exp ulps are amplified); the uniform slab's kink mode cosh(m0 x)
   (rtol 1e-6);
   the wall of each reconstruction.
22. complex omega beyond the KH case (tools_torch/cx_slab.py, float64, the
   CLI's defaults: 12 x 10 seeds a cell, 30 Newton steps, the audit on):
   slab_density_photospheric(0.9) made complex (cx_ph_09: the flux form,
   B2-complex; 37,800 seeds a mode, modes 0 and 1), the same with the
   numeric exterior (cx_ph_09_num: B2-complex and B6-complex) and
   slab_flow_complex_coronal(1e5) with the numeric exterior (kh_w1e5_num:
   B6-complex in the shear form; 7,200 seeds). For each, on the sweep's
   seeds (seed i at parity i mod 2): slab_newton at n_iter=1 with its
   value round in the launch, and slab_disp_complex at its roots,
   bit-equal to the plain Newton loop over the dual shoot and to the plain
   value dispersion (both timed), at a quarter of the depth (n_interior
   512, n_exterior 128, as phase 13's plain checks); the main path's
   launches timed at full depth (30
   steps, with and without the value round; the audit's contour points in
   the evaluation mode) beside their bounds, and the roots that reach the
   real axis (|Im omega| < 1e-290, where Smith's division would leave
   CUDA's fast path but for complex.cuh::fast_div) and the warps of 32
   seeds that hold one; the form's kernel
   (csrc/slab_complex.cu: the flux form's flux_kernel, one thread a seed,
   with its launch shape, registers and spills, its kept chains by its
   own counts (thread 0 of block 0 counts the steps whose first chain it
   kept, held to kernels.slab.flux_chain_kept for every shoot of the
   phase's launches), and its time on the 8,640 seeds of a checkpointed
   block; the shear form's newton_kernel, whose consumer lane integrates
   the numeric exterior, with its block shape and ptxas lines); then
   run_case_complex with the counters reset (2 launches
   a mode: slab_newton and slab_disp_complex, each counted under its
   variant; never the plain dispersion) and 2 timed runs, held to the JAX
   package's float64 run: per seed (the Newton pass again and one step
   further) every seed converged in both runs accepted alike and the
   converged accepted seeds' roots counted exactly; each branch's total
   exactly where the JAX package's unconverged accepted seeds add no root;
   the roots off the real axis and the audit exactly.
23. the sharded sweep (parallel.run_case_sharded): slab_ph_09 float32 (and
   refined in float64), cyl_co_09 float32 and cyl_flow_1's parity
   configuration at float64, over every visible card (over [cuda:0,
   cuda:0] where there is one): each root set equal to run_case's bit
   for bit, each block's launches (a scan and a bisection a block, the
   slab's scan paired; + the refine stage's 2), the median wall of 5
   runs beside run_case's, run in turns; two processes joined by init_distributed (gloo) on the
   card(s), each holding run_case's roots of every sweep; `python -m
   eigensolver_tpu_torch sweep slab_density_photospheric --width 0.9
   --sharded` against run_case at the CLI's config.
24. the cylinder's complex-omega kernel (csrc/cylinder_complex.cu: one
   thread a seed, its block's r-only and (k, m, r) values in tables of
   shared memory, a step's first chain kept where its abscissa is the step
   before's last; behind cylinder_newton and cylinder_disp_complex) in
   each variant: the density and axial-flow chains (B4-complex) with the
   K_m ratio at complex z (B1) and the density one with the numeric
   exterior (B6-complex), the rotational and magnetic twists (B4-twisted
   at complex omega) and the rotational one with the numeric exterior, at
   float32 and float64, at a reduced depth (n_interior 256, n_axis_log 32,
   n_exterior 128; the plain versions run eagerly on the card): on 133
   random seeds (their warps form their own row values: the seeds outside
   the tables) and on a draw laid out as the sweep lays out its seeds
   (sweep.complex_seeds on the case's first 3 k, at least 200 seeds a k,
   one m: every warp through its block's row table, a block over two k
   rows, a row across a block boundary), each cylinder_newton at
   n_iter=2, so that the omega carried from one round to the next is held
   too, with its value round in the launch, and cylinder_disp_complex at
   the random seeds' roots, at the laid-out ones' and on 13 more,
   bit-equal to one plain Newton loop over the dual shoot of both draws
   and to one plain value dispersion (on the roots and the 13), with
   their launches per variant, the seeds that read a tabled row (all the
   laid-out ones) and the chains kept (kernels.cylinder.chain_kept); both
   timed on the random seeds, the kernel beside its bound. The launch
   shape of each (type, chain) with its registers, spills and blocks an
   SM, and the share of kept steps on each grid of the sweeps. B1 alone
   (kernels.bessel.kve_ratio_complex) on the exterior arguments sqrt(m_e)
   of the cx_cyl_co_09 seeds, both modes, at both types: bit-equal to
   special.kve_ratio_both_c, timed beside its bound (each argument at the
   branch it takes). The registers and spills of the kernel's
   instantiations (ptxas).
25. the complex cylinder sweeps (tools_torch/cx_cyl.py, float64, the CLI's
   defaults: 12 x 10 seeds a cell, 30 Newton steps, the audit on):
   cylinder_density_coronal(0.9) made complex (cx_cyl_co_09: 129,600 seeds
   a mode, modes 0 and 1) and cylinder_twisted_photospheric(0.1, 1.0, 1)
   made complex (cx_twist_v01_p1: 36,000 seeds, mode 1). For each, the
   main path's launches timed beside their bounds (the Newton launch of 30
   steps with and without its value round, per mode; the audit's contour
   points in the evaluation mode; each bound counted for the tables, and
   as before them); run_case_complex with the counters
   reset (2 launches a mode: cylinder_newton and cylinder_disp_complex,
   the twisted ones counted as such; never the plain dispersion), then 2
   timed runs, every audited cell agreeing, its roots' digest
   (root_digest); held to the JAX package's
   float64 run on every k_stride-th k (cx_cyl.TARGETS): the same sweep on
   those k with its counts (exactly where the JAX package's unconverged
   accepted seeds add no root), its roots off the real axis and its audit
   exactly, and per seed, of the full sweep's seeds of those k, every seed
   converged in both runs accepted alike and the converged accepted
   seeds' roots counted exactly. Then the density cylinder with the
   numeric exterior: its Newton launch on cx_cyl_co_09's seeds (m = 1)
   timed, and a sweep of its own on every 30th k (its launches).
26. the profile paths that no shipped case takes (tools_torch/
   profiles_cases.py: power-law density and flow profiles, Gaussian and
   Epstein twists; pl_slab_flow, pl_cyl_flow, pl_cyl_density, tw_gauss,
   tw_epstein_b, pl_slab_density, whose rho(0) = 0 makes every det
   non-finite), one line each and one with the phase's seconds. For each,
   at float32 and float64, every kernel bit-equal to its plain version
   (non-finite where it is; at a quarter of the depth): the scan on
   8,192 ladder candidates (the slab's unpaired and paired scans; the
   cylinder's through its row table on half of them, and with the
   numeric exterior; the twisted scan and its small-batch path), the
   fused bisection (`spec_kernel`) at one iteration on 2,048 brackets to
   the plain loop, and the complex-omega kernel (the slab's shear-form
   newton_kernel or flux_kernel, the cylinder's newton_kernel on the
   density, flow and twisted chains; n_interior 128 / 64) in its Newton
   mode at one step with its value round and in its evaluation mode, on
   96 of the sweep's seeds, to the plain Newton loop over the dual shoot
   and the plain value dispersion; then the full sweep (n_omega=256,
   n_bisect=18) counted (2 launches, the slab's scan paired; never the
   plain dispersion) at float64, held to the JAX package's counts
   exactly, and at float32, held to the IEEE-compiled JAX's within 1%
   (cylinders) or 5% (slabs); run_case_complex of pl_slab_flow and
   pl_cyl_density on their k subsets (2 launches a mode) held per seed to
   the JAX package's float64 run, as phases 22 and 25 hold theirs.

Then one JSON line of the kernels (with each one's bound: the operations
the function needs on this run's inputs over the card's peak rate, or its
bytes over the memory rate, whichever is longer), the nvidia-smi line, and
last
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

N_SWEEP = 90 * 12 * 256 * 2     # cyl_co_09 candidates per sweep: 552,960
N_SLAB = 35 * 9 * 256 * 2       # slab_ph_09 candidates per sweep: 161,280
N_FLOW = 35 * 10 * 256 * 2      # slab_flow_gaussian_coronal's: 179,200
N_DISP_CHECK = 8192
# Root counts per branch of run_case on the same case and config, each with
# the band per branch that the evidence supports (None: printed beside, not
# held). All measured with the JAX package on a CPU (JAX 0.9.0, x64):
#   python tests/test_torch_ieee.py counts      (the f32 counts)
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu');
#     jax.config.update('jax_enable_x64', True)
#     from eigensolver_tpu import cases; from eigensolver_tpu.sweep import run_case
#     from eigensolver_tpu.search import SearchConfig
#     print(run_case(CASE, SearchConfig(n_omega=256, n_bisect=18,
#       scan_dtype=DT, polish_dtype=DT))[0].counts())"     (the f64 counts)
# "jax_ieee": the JAX package compiled with XLA_FLAGS="--xla_cpu_max_isa=AVX
# --xla_disable_hlo_passes=algsimp", which rounds every f32 operation once,
# as the port's kernels (--fmad=false) and plain version do. With the same
# exp and log the two are bit-equal on every f32 dispersion value
# (tests/test_torch_ieee.py), so the card's f32 counts differ from these only
# through its exp/log ulps. Bands per branch: 1% (cylinder, ~1000 roots a
# branch) and 5% (slab, 60-95 roots: 3-4 roots); measured on an H100 (NVIDIA
# H100 80GB HBM3, 700 W): cylinder +2/+6 roots (0.2%/0.4%), slab 0/0, slab
# refined 0/0.
# "jax": the JAX package as XLA compiles it by default, with fused
# multiply-adds and algebraic rewrites; its f32 counts are printed, not held
# (slab_ph_09 kink 68 against 59 rounded as IEEE does, -13%).
# float64: only sign flips within ~1e-12 of a zero can differ: +-0.25%
# (every f64 count below is met exactly on an H100).
CYL_COUNTS = {
    "float64": [("jax", {"sausage": 1709, "kink": 2238}, 0.0025)],
    "float32": [("jax_ieee", {"sausage": 880, "kink": 1477}, 0.01),
                ("jax", {"sausage": 919, "kink": 1487}, None)],
}
SLAB_COUNTS = {
    "float64": [("jax", {"sausage": 289, "kink": 238}, 0.0025)],
    "float32": [("jax_ieee", {"sausage": 94, "kink": 59}, 0.05),
                ("jax", {"sausage": 97, "kink": 68}, None)],
    # refine_f64=True keeps the f32 roots that its f64 window brackets
    "float32_refined": [("jax_ieee", {"sausage": 94, "kink": 59}, 0.05),
                        ("jax", {"sausage": 97, "kink": 68}, None)],
}
FLOW_COUNTS = {     # float64
    "slab_flow_gaussian_coronal": [("jax", {"sausage": 452, "kink": 454},
                                    0.0025)],
    "slab_flow_uniform_photospheric": [("jax", {"sausage": 208, "kink": 183},
                                        0.0025)],
}
# reduced sweep (k in {0.5, 2}, n_interior=256, n_axis_log=32, n_omega=64,
# n_bisect=30, f64): same JAX measurement, and tests/test_torch_sweep.py
JAX_COUNTS_REDUCED = {"sausage": 29, "kink": 43}
# The twisted cases (one branch, m = 1), same commands (the f32 counts:
# python tests/test_torch_ieee.py counts --cases twist_v01_p1; JAX 0.9.0 on
# a CPU). BENCH_r05.json's count of twist_v01_p1, taken on a TPU at f32
# (306), is printed beside, not held.
TWIST_COUNTS = {
    "float64": [("jax", {"kink": 306}, 0.0025)],
    "float32": [("jax_ieee", {"kink": 308}, 0.01), ("jax", {"kink": 302}, None),
                ("tpu_bench_r05", {"kink": 306}, None)],
    "float32_refined": [("jax_ieee", {"kink": 308}, 0.01),
                        ("jax", {"kink": 302}, None)],
}
MAGNETIC_COUNTS = {"float64": [("jax", {"kink": 307}, 0.0025)]}
# reduced magnetic sweep with the row mask (k in {0.8, 1.4, 2.0},
# n_interior=128, n_omega=48, n_bisect=20, f64):
# tests/test_torch_twisted_sweep.py holds the port's CPU run equal to JAX's
JAX_COUNTS_MASKED_REDUCED = {"kink": 7}
N_TWIST = 60 * 5 * 256          # twist_v01_p1 candidates per sweep: 76,800
N_BR_TWIST = 60 * 5 * 8         # its brackets: 2,400
N_REFINE_TWIST = 309            # roots of its float32 sweep, refined in f64
N_WINDOWS = 10 * N_REFINE_TWIST  # their refine windows' ends: 3,090
N_REFINE_ITER = 30              # search.refine_roots_f64's bisection
_SMS = 132                      # SMs of an H100
TWIST_PLAIN_N_ITER = 1          # the plain loop's iterations in phase 12
# the plain speculative bisection's iterations on the refine stage's
# brackets in phases 9 and 12: two rounds at L = 3 or 4
REFINE_PLAIN_N_ITER = 5
# brackets of the full sweeps' bracket stage: rows x 8 per row
N_BR_CYL = 90 * 12 * 2 * 8      # 17,280
N_BR_SLAB = 35 * 9 * 2 * 8      # 5,040
N_BR_FLOW = 35 * 10 * 2 * 8     # slab_flow_gaussian_coronal's: 5,600
N_BISECT = 18
PLAIN_N_ITER = 1                # the plain loops' iterations in phases 8, 9

# The reference-parity sweeps (tools_torch/parity.py, tools/reproduce.py's
# targets at the case's own k grid): candidates per sweep and brackets
N_PAR_SLAB = 35 * 13 * 384 * 2          # slab_ph_09: 349,440
N_BR_PAR_SLAB = 35 * 13 * 2 * 24        # 21,840
N_PAR_CYL = 90 * 11 * 1519 * 2          # cyl_flow_1: 3,007,620
N_BR_PAR_CYL = 90 * 11 * 2 * 24         # 47,520
N_NEEDLE = 35 * 4 * 512                 # slab_ph_3's needle pass: 71,680
CYL_PAR_K_STRIDE = 9                    # cyl_flow_1's k subset for counts
N_RAGGED = 8191                         # the ragged batch of phase 13
NUM_PLAIN_N_ITER = 1                    # the plain loops of phase 13
# the depth divisor of `shallower`: the plain checks of phases 4 (its
# draws), 6 (but the paired scans), 8-10, 12, 13 (but the parity scans),
# 17 and 22 at a quarter of the depth
NUM_PLAIN_DEPTH = 4
# Root counts per branch of the parity sweeps through the JAX package on a
# CPU (JAX 0.9.0, x64), held as the IEEE counts above are:
#   python tests/test_torch_parity.py jax-counts TARGET DTYPE [--k-stride 9]
# (f32 refined in f64; "jax_ieee" with XLA_FLAGS="--xla_cpu_max_isa=AVX
# --xla_disable_hlo_passes=algsimp"). cyl_flow_1's on every 9th k (10 of
# the 90, 249 s on this CPU; f32 there only), and at full width at f64
# (1,636 s); slab_ph_3 the main sweep, the needle pass (its positive cusp
# edges, mode 0) and the merge.
PARITY_COUNTS = {
    "slab_ph_09 float64": [("jax", {"sausage": 118, "kink": 84}, 0.0025)],
    "cyl_flow_1 float64": [("jax", {"sausage": 1029, "kink": 1347},
                            0.0025)],
    "slab_ph_09 float32": [("jax_ieee", {"sausage": 118, "kink": 84}, 0.05),
                           ("jax", {"sausage": 118, "kink": 84}, None)],
    "cyl_flow_1/9 float64": [("jax", {"sausage": 105, "kink": 146}, 0.0025)],
    "cyl_flow_1/9 float32": [("jax_ieee", {"sausage": 97, "kink": 116},
                              0.03),
                             ("jax", {"sausage": 97, "kink": 118}, None)],
    "slab_ph_3 float64": [("jax", {"sausage": 339, "kink": 319}, 0.0025)],
    "slab_ph_3 needle": [("jax", {"sausage": 205}, 0.0025)],
    "slab_ph_3 merged": [("jax", {"sausage": 469, "kink": 319}, 0.0025)],
}
# the needle oracle (tests/test_needle.py:61-87): (case, k, omega)
NEEDLE_ORACLE = (("slab_density_photospheric", 3.0, 0.43303, 0.367977),
                 ("slab_density_coronal", 1.5, 0.080505, 0.0716901))

# Operations, the least each function needs, counted from the sources for
# the Gaussian density profile of slab_ph_09 and cyl_co_09 and the Gaussian
# flow of slab_flow_gaussian_coronal (uniform density, corrected D), each
# IEEE division, square root, exp and log as one operation. The chains'
# values that depend on the abscissa alone (profile, speeds, their roots;
# U, U', U'' from one exp; in the cylinder also r r, and r = exp(t) on the
# log tail) count once per RK4 step and launch ("*_x_step", "cyl_*r_step":
# 3 abscissae and their forming); per candidate (or bracket per evaluation)
# and step, the rest of the 3 chain evaluations and the state update
# ("cyl_step", "cyl_log_step"; the products of k alone, and in the slab's
# flux form, where U == 0, Omega^2, once per candidate); in the slab the
# rest of one chain evaluation ("slab_chain", "slab_shear_chain") at each
# distinct abscissa of a shoot once per distinct (omega, k) of the batch
# (`slab_chains`: 2 a step and one more where n_interior is a power of
# two), and the update per candidate and step ("slab_update",
# "slab_shear_update"), both traced from the plain version by
# tools_torch/count_ops.py; in the cylinder the chain's values that depend on
# (k, m, r) and not on omega (k U, alpha^2, cusp^2, (c^2 + vA^2)(m^2/r^2 +
# k^2)) once per distinct (k, m) row of the batch and step ("cyl_row_step",
# "cyl_log_row_step": tools_torch/count_ops.py traces them from the plain
# chain, and "cyl_step", "cyl_log_step" are the hand counts less them; for
# the fused bisection, which keeps a step's first chain where its abscissa
# is the step before's last, per candidate the rest of one evaluation,
# "cyl_chain", 3 a step or 2 where kept, and the update, "cyl_update",
# "cyl_log_update");
# per evaluation, the start state and the epilogue
# ("*_ends"), the cylinder's without the K_m ratio, which `kve_ops` counts
# from its arguments (csrc/kve_ratio.cuh: one branch per argument, the
# series up to the first term that changes none of its sums).
# The twisted cylinder chain ("cyl_tw_*": tools_torch/count_ops.py, which
# traces the plain chain that the kernel follows operation for operation):
# per abscissa the r-only values with their r-derivatives and the chain's
# r-only products, 3 abscissae per step; per candidate (or bracket per
# evaluation) and step, 3 dual-chain evaluations with (1/F, g) and the
# update; per evaluation, the values of the chain at r = 1, F(1),
# C1(1)/C3(1), the products of k and m alone and the epilogue; once per
# launch the r-only values at r = 1 and J. An operation repeated on the
# same operands is one (a dual square is 3); a negation, a product by the
# unit tangent dr/dr = 1 and one by d(1/r)/dr = -1 at r = 1 are free. With
# B_phi = 0 (twist_v01_p1) its exact zeros remove every term in B_phi
# ("cyl_tw_b0_*"). Each entry is the lower of the count of the chain, which
# multiplies by reciprocals of its r-only divisors, and that of its
# quotient form, which divides by them: the function needs no more. A
# bisection's bound counts the evaluations the loop needs (f(lo), n_iter
# midpoints, the residual), whatever the kernel speculates.
# The numeric exteriors ("slab_ext_*", "cyl_ext_*": tools_torch/count_ops.py
# traces one RK4 step of the plain version, ode._step): per candidate (or
# bracket per evaluation) and exterior step, and the slab's rescaling every
# 64th step; per candidate the set-up and the end; the cylinder's exps of
# its abscissae and its set-up, which depend on k alone, once per distinct
# k of the batch ("cyl_ext_k_step", "cyl_ext_k_ends"). They take the place of
# the exact exterior (slab) and of the K_m ratio (cylinder, `kve_ops`);
# with them "*_ends" lose the exact exterior's operations around its
# ratio ("*_exact_ext": max(m_e, floor) and its sqrt; the cylinder's also
# their product with the K_m ratio), which the numeric one does not need.
OPS = {"slab_x_step": 67, "slab_chain": 9, "slab_update": 34,
       "slab_ends": 93, "slab_shear_x_step": 40, "slab_shear_chain": 24,
       "slab_shear_update": 38, "slab_shear_ends": 64,
       "cyl_r_step": 70, "cyl_log_r_step": 73, "cyl_step": 128,
       "cyl_log_step": 134, "cyl_row_step": 27, "cyl_log_row_step": 27,
       "cyl_chain": 20, "cyl_update": 68, "cyl_log_update": 74,
       "cyl_ends": 98,
       "cyl_tw_r_step": 298, "cyl_tw_step": 590, "cyl_tw_ends": 84,
       "cyl_tw_launch": 99, "cyl_tw_b0_step": 425, "cyl_tw_b0_ends": 74,
       "kve_cf2": 491, "kve_series": 22, "kve_term": 5,
       "slab_ext_step": 30, "slab_ext_renorm": 4, "slab_ext_ends": 7,
       "cyl_ext_step": 36, "cyl_ext_ends": 2, "cyl_ext_k_step": 10,
       "cyl_ext_k_ends": 7,
       "slab_exact_ext": 2, "cyl_exact_ext": 3,
       "slab_cx_chain": 77, "slab_cx_step": 339, "slab_cx_ends": 182,
       "slab_cx_dual_chain": 163, "slab_cx_dual_step": 769,
       "slab_cx_dual_ends": 326, "slab_cx_newton": 31,
       "slab_cx_flux_chain": 20, "slab_cx_flux_step": 160,
       "slab_cx_flux_ends": 164, "slab_cx_flux_dual_chain": 38,
       "slab_cx_flux_dual_step": 378, "slab_cx_flux_dual_ends": 271,
       "slab_cx_flux_update": 100, "slab_cx_flux_dual_update": 264,
       "slab_cx_ext_step": 76, "slab_cx_ext_renorm": 16,
       "slab_cx_ext_ends": 22, "slab_cx_dual_ext_step": 184,
       "slab_cx_dual_ext_renorm": 20, "slab_cx_dual_ext_ends": 50,
       "cyl_cx_kve_series": 755, "cyl_cx_kve_cf2": 1832,
       "cyl_cx_kve_ends": 34, "cyl_cx_step": 464, "cyl_cx_log_step": 476,
       "cyl_cx_ends": 244, "cyl_cx_ext_step": 105, "cyl_cx_num_ends": 240,
       "cyl_tw_cx_step": 1592, "cyl_tw_cx_ends": 624,
       "cyl_cx_dual_kve_series": 1943, "cyl_cx_dual_kve_cf2": 4748,
       "cyl_cx_dual_kve_ends": 68, "cyl_cx_dual_step": 1068,
       "cyl_cx_dual_log_step": 1092, "cyl_cx_dual_ends": 416,
       "cyl_cx_dual_ext_step": 221, "cyl_cx_dual_num_ends": 398,
       "cyl_tw_cx_dual_step": 3924, "cyl_tw_cx_dual_ends": 1336,
       "cyl_cx_chain": 88, "cyl_cx_row": 12, "cyl_cx_dual_chain": 180,
       "cyl_tw_cx_chain": 464, "cyl_tw_cx_row": 48,
       "cyl_tw_cx_dual_chain": 1132}
# The complex-omega chain ("slab_cx_*": tools_torch/count_ops.py traces
# physics/slab.py::complex_shear_coef, complex_edge, complex_det,
# complex_mismatch and search.newton_step): per candidate and RK4 step 3
# evaluations of the complex chain and the complex update, the value pass
# ("slab_cx_step") or the dual pass in omega ("slab_cx_dual_step"), of
# which one chain evaluation is "*_chain"; per evaluation the interface
# ("*_ends"); per Newton step the damped step
# ("slab_cx_newton"); a complex quotient by its real divisions (Smith's
# algorithm: 2 divisions a divisor), the x-only table "slab_shear_x_step"
# once per launch. The flux form at complex omega ("slab_cx_flux_*",
# traced from physics/slab.py::complex_flux_coef; its ends the candidate's
# products, the start's F(0) and the interface; the x-only table
# "slab_x_step") and the numeric exterior at complex omega
# ("slab_cx_*ext_*", traced from one ode._step on complex pairs or their
# duals; every 64th step the rescaling, by hand; per shoot its set-up, the
# quotient vx'/vx and its product with p_e), the same way. The flux form's
# kernel of one thread a seed (count_ops.complex_flux_kernel_ops): a
# step's serial update ("slab_cx_flux_update", "*dual_update": the step
# less its 3 chains), beside the chains the thread forms.
# The complex-omega cylinder ("cyl_cx_*", the density and axial-flow chain;
# "cyl_tw_cx_*", the twisted chain; value pass, and "*dual_*" the Newton
# pass on duals in omega): tools_torch/count_ops.py counts them from the
# plain versions run on a few candidates under a torch function mode (each
# arithmetic operation, root, exp, log, atan2, comparison, maximum or
# minimum on the candidates' tensors one; negation, |.| and selects free;
# the r-only values, 0-d tensors there, none): per candidate and step of
# the interior ("*step"), of the log tail ("*log_step") and of the numeric
# exterior ("*ext_step"); per shoot the ends with the exact exterior less
# the K_m ratio ("*ends") or with the numeric exterior ("*num_ends"); the
# K_m ratio at complex z by branch ("*kve_series", "*kve_cf2") and the rest
# of it ("*kve_ends"), each argument counted at the branch it takes; the
# Newton step "slab_cx_newton" (search.newton_step, shared). For the
# kernel's tables (count_ops.complex_cylinder_table_ops): one chain
# evaluation ("*chain", "*dual_chain"; a step's update is its step less 3
# of them) and of it the (k, m, r) values that do not depend on omega
# ("*row"), which the kernel forms once per block row of a launch.
# The complex-omega sweeps (tools_torch/kh.py) at their published size:
KH_N_SEEDS = 20 * 3 * 12 * 10          # Newton seeds: 7,200
KH_N_AUDIT = 20 * 3 * 4 * 128          # audit contour points: 30,720
KH_PLAIN_N_ITER = 1                    # the plain Newton loop's steps
KH_ANALYTIC_TOL = 2e-6                 # tests/test_complex_kh.py:53
# The other complex-omega slab sweeps (tools_torch/cx_slab.py): the density
# slab's flux form with either exterior, the KH slab's numeric exterior
CX_SLAB = ("cx_ph_09", "cx_ph_09_num", "kh_w1e5_num")
CX_PLAIN_N_ITER = 1                    # the plain Newton loop's steps
# the seeds of a checkpointed block of the density slab's sweep
# (run_case_complex_checkpointed's k_block of 8 k x 9 bands x 120 seeds)
CX_BLOCK_SEEDS = 8 * 9 * 120
# The complex-omega cylinder (tools_torch/cx_cyl.py): its sweeps, and the
# kernel's variants held to their plain versions at a reduced depth
CX_CYL = ("cx_cyl_co_09", "cx_twist_v01_p1")
# name: (case factory, its keywords, exterior_method)
CX_CYL_VARIANTS = {
    "density": ("cylinder_density_coronal", dict(width=0.9), "bessel"),
    "flow": ("cylinder_flow_coronal", dict(U=1.0), "bessel"),
    "density_numeric": ("cylinder_density_coronal", dict(width=0.9),
                        "numeric"),
    "twist": ("cylinder_twisted_photospheric",
              dict(v_twist=0.1, power=1.0, mode=1), "bessel"),
    "magnetic": ("cylinder_twisted_magnetic",
                 dict(B_twist=0.1, v_twist=0.15, power=1.25, mode=1),
                 "bessel"),
    "twist_numeric": ("cylinder_twisted_photospheric",
                      dict(v_twist=0.1, power=1.0, mode=1), "numeric"),
}
CX_CYL_GRID = dict(n_interior=256, n_axis_log=32, n_exterior=128)
CX_CYL_N_CHECK = 133                   # seeds of each variant's check
CX_CYL_PLAIN_N_ITER = 2                # its Newton steps (+ the value round)
# The profile paths that no shipped case takes (tools_torch/
# profiles_cases.py): the real-omega kernels' checks on PROFILE_N_CHECK
# candidates and PROFILE_N_BR brackets at a quarter of the depth; the
# complex-omega kernels' on PROFILE_CX_N seeds at PROFILE_CX_GRID's depth,
# for the configurations of PROFILE_CX_CHECKS (the slab's shear form and
# flux form, the cylinder's density, axial-flow and twisted chains); the
# float32 sweeps' bands per branch against the IEEE-compiled JAX package
PROFILE_N_CHECK = 8192
PROFILE_N_BR = 2048
PROFILE_CX_N = 96
PROFILE_CX_GRID = {"slab": dict(n_interior=128),
                   "cylinder": dict(n_interior=64, n_axis_log=16)}
PROFILE_CX_CHECKS = ("pl_slab_flow", "pl_slab_density", "pl_cyl_flow",
                     "pl_cyl_density", "tw_gauss", "tw_epstein_b")
PROFILE_BANDS = {"slab": 0.05, "cylinder": 0.01}
# NVIDIA H100 SXM data sheet, outside the tensor cores, at 700 W; HBM3 rate
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_S = 3.35e12


_T0 = time.perf_counter()


def line(phase: str, **fields) -> None:
    """One phase's line, with the seconds since the script started."""
    fields["elapsed_s"] = time.perf_counter() - _T0
    print(f"{phase}: {json.dumps(fields, default=float)}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def reset_counters() -> None:
    """Set every kernel launch counter and plain-dispersion count to 0."""
    from eigensolver_tpu_torch.kernels import bessel, cylinder, slab
    from eigensolver_tpu_torch.physics import cylinder as pcyl, slab as pslab
    bessel.launches = cylinder.launches = slab.launches = 0
    cylinder.small_launches = slab.paired = 0
    cylinder.bisect_launches = slab.bisect_launches = 0
    slab.complex_launches = slab.newton_launches = 0
    slab.complex_flux_launches = slab.complex_numeric_launches = 0
    cylinder.newton_launches = cylinder.complex_launches = 0
    cylinder.complex_twisted_launches = cylinder.complex_numeric_launches = 0
    bessel.complex_launches = 0
    pcyl.plain_calls = pslab.plain_calls = 0


def read_counters() -> dict:
    from eigensolver_tpu_torch.kernels import launch_counts
    from eigensolver_tpu_torch.physics import cylinder as pcyl, slab as pslab
    return {**launch_counts(), "plain_cylinder": pcyl.plain_calls,
            "plain_slab": pslab.plain_calls}


def counts_since(before: dict) -> dict:
    now = read_counters()
    return {k: now[k] - before[k] for k in now}


def check_launches(what: str, got: dict, want: dict) -> None:
    """Every counter of got equal to want's entry, 0 where want has none."""
    bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def bound(n_ops: float, n_bytes: float, dtype: str) -> dict:
    """The least time the card could take: operations over the peak rate of
    their type, or bytes over the memory rate, whichever is longer."""
    t_ops = n_ops / PEAK_FLOPS[dtype]
    t_bytes = n_bytes / HBM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def slab_chains(n_interior: int, every_chain: bool = False) -> int:
    """The chain evaluations one shoot of n_interior RK4 steps needs: 3 a
    step, or 2 a step and the first step's first where n_interior is a
    power of two (a step's first abscissa is the step before's last, bit
    for bit: csrc/common.cuh::chain_reuse); every_chain: 3 a step."""
    if every_chain or n_interior & (n_interior - 1):
        return 3 * n_interior
    return 2 * n_interior + 1


def slab_ops(n: int, n_evals: int, n_interior: int, shear: bool = False,
             n_chains: int = None, every_chain: bool = False) -> int:
    """Operations of n_evals evaluations of each of n slab candidates (the
    flux or the shear form): the update and the ends per candidate; the
    chain at each abscissa `slab_chains` counts, once for each of n_chains
    distinct (omega, k) an evaluation (default n); the x-only values once.
    every_chain: the count before the paired scan, 3 chains a step for
    every candidate."""
    f = "slab_shear_" if shear else "slab_"
    if n_chains is None or every_chain:
        n_chains = n
    return (n * n_evals * (n_interior * OPS[f + "update"] + OPS[f + "ends"])
            + n_chains * n_evals * slab_chains(n_interior, every_chain)
            * OPS[f + "chain"]
            + n_interior * OPS[f + "x_step"])


def distinct(k, m=None) -> int:
    """The distinct k values, or with m the distinct (k, m) rows, of a
    batch (tensors)."""
    import torch
    x = k if m is None else torch.stack([k, m], dim=1)
    return int(torch.unique(x, dim=0).shape[0])


def cyl_ops(n: int, n_evals: int, n_interior: int, n_axis_log: int,
            z_ext, rows: int, kept=None) -> int:
    """Operations of n_evals cylinder chains on each of n candidates with
    the exterior arguments z_ext (those of one evaluation), the (k, m, r)
    values once per row of the `rows` distinct (k, m) rows, and the r-only
    values once. kept: per step of the interior and of the log tail,
    whether its first chain is the step before's last
    (kernels.cylinder.chain_kept), which a candidate then needs once; None:
    3 chains a step."""
    if kept is None:
        per = (n_interior * OPS["cyl_step"]
               + n_axis_log * OPS["cyl_log_step"])
    else:
        interior, tail = kept
        per = (n_interior * OPS["cyl_update"]
               + n_axis_log * OPS["cyl_log_update"]
               + (3 * (n_interior + n_axis_log) - int(interior.sum())
                  - int(tail.sum())) * OPS["cyl_chain"])
    return (n * n_evals * (per + OPS["cyl_ends"])
            + n_evals * kve_ops(z_ext)
            + rows * (n_interior * OPS["cyl_row_step"]
                      + n_axis_log * OPS["cyl_log_row_step"])
            + n_interior * OPS["cyl_r_step"]
            + n_axis_log * OPS["cyl_log_r_step"])


def ext_ops(case, n: int, n_evals: int, n_k: int = 0,
            n_ext: int = None) -> int:
    """Operations of the numeric exterior of n_evals evaluations of each of
    n candidates: n_exterior steps (the slab's rescaled every 64th), the
    set-up and the end, less the exact exterior's operations that the
    chain's "*_ends" count; the slab's (which depends on (omega, k) alone)
    once for each of n_ext distinct (omega, k) an evaluation (default n),
    the cylinder's exps and set-up once for each of the batch's n_k
    distinct k."""
    steps = case.grid.n_exterior
    n_ext = n if n_ext is None else n_ext
    if case.geometry.value == "slab":
        per = (steps * OPS["slab_ext_step"]
               + steps // 64 * OPS["slab_ext_renorm"] + OPS["slab_ext_ends"])
        per_k = 0
    else:
        per = steps * OPS["cyl_ext_step"] + OPS["cyl_ext_ends"]
        per_k = steps * OPS["cyl_ext_k_step"] + OPS["cyl_ext_k_ends"]
        n_ext = n
    exact = OPS["slab_exact_ext" if case.geometry.value == "slab"
                else "cyl_exact_ext"]
    return n_evals * (n_ext * per - n * exact) + n_k * per_k


def cyl_tw_ops(case, n: int, n_evals: int, z_ext) -> int:
    """Operations of n_evals twisted cylinder chains of `case` on each of n
    candidates (no log tail) with the exterior arguments z_ext, and the
    r-only values once; without the terms in B_phi where the case has
    none."""
    f = "cyl_tw_b0_" if case.b_twist_profile is None else "cyl_tw_"
    n_interior = case.grid.n_interior
    return (n * n_evals * (n_interior * OPS[f + "step"] + OPS[f + "ends"])
            + n_evals * kve_ops(z_ext) + n_interior * OPS["cyl_tw_r_step"]
            + OPS["cyl_tw_launch"])


def twisted_cases() -> dict:
    """The twisted configurations: bench.py's twist_v01_p1 (B_phi = 0,
    p = 1) and tests/test_btwist.py's magnetic twist (every term live)."""
    from eigensolver_tpu_torch import cases
    return {"twist_v01_p1": cases.cylinder_twisted_photospheric(0.1, 1.0, 1),
            "magnetic_p125": cases.cylinder_twisted_magnetic(0.1, 0.15, 1.25,
                                                             1)}


def kve_ops(z) -> int:
    """Operations of kve_ratio_both on the arguments z (a tensor): CF2 for
    |z| >= 2 (and NaN); else the series' fixed part and, in each of its two
    recursions, every term up to the first that changes none of its sums,
    which ends it (csrc/kve_ratio.cuh)."""
    import torch
    from eigensolver_tpu_torch.profiles import div
    small = z.abs() < 2
    zs = z[small]
    total = (OPS["kve_cf2"] * int((~small).sum())
             + OPS["kve_series"] * zs.numel())
    z2 = 0.25 * zs * zs
    for k1 in (False, True):      # the K_0 recursion, then I_1's and K_1's
        term = torch.ones_like(zs)
        a, b = term, term if k1 else torch.zeros_like(zs)
        hk, hk1 = 0.0, 1.0
        alive = torch.ones_like(zs, dtype=torch.bool)
        for j in range(1, 25):
            term = div(term * z2, j * (j + 1) if k1 else j * j)
            hk, hk1 = hk + 1.0 / j, hk1 + 1.0 / (j + 1)
            a_next = a + term
            b_next = b + term * (hk + hk1 if k1 else hk)
            total += OPS["kve_term"] * int(alive.sum())
            alive &= ~((a_next == a) & (b_next == b))
            a, b = a_next, b_next
    return total


def exterior_args(case, om, k, dtype):
    """sqrt(max(m_e, floor)), the K_m ratio's arguments of the cylinder
    candidates (om, k), in dtype."""
    import torch
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    m_e = CylinderPhysics.from_case(case).exterior_m(om.to(dtype), k.to(dtype))
    floor = torch.tensor(1e-300, dtype=dtype, device=m_e.device)
    return torch.sqrt(torch.maximum(m_e, floor))


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    # no matmul is on the path; state the precision all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line("phase 1 device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def phase_build():
    from eigensolver_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    log = so.with_suffix(".log").read_text() if so.with_suffix(".log").is_file() else ""
    ptxas = [ln.split("ptxas info    :")[-1].strip() for ln in log.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    line("phase 2 build", seconds=seconds, library=so.name,
         kernels=sum("Compiling entry" in ln for ln in log.splitlines()),
         ptxas=ptxas)


def phase_kve_ratio(out: dict):
    import torch
    from eigensolver_tpu_torch import cases, special, sweep
    from eigensolver_tpu_torch.kernels import bessel
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    # the exterior arguments sqrt(m_e) the cylinder sweep evaluates (valid
    # candidates of the cyl_co_09 ladder, both modes, in ladder order)
    case = cases.cylinder_density_coronal(width=0.9)
    om, ks = sweep.build_ladders(case, 256)
    om = torch.from_numpy(np.concatenate([om.ravel()] * 2)).cuda()
    kk = torch.from_numpy(np.repeat(np.concatenate([ks] * 2), 256)).cuda()
    m_e = CylinderPhysics.from_case(case).exterior_m(om, kk)
    z_ladder = torch.sqrt(m_e[m_e > 0]).contiguous()
    z_path = z_ladder.to(torch.float32)
    reset_counters()
    r_path = bessel.kve_ratio_both(z_path)
    torch.cuda.synchronize()
    standalone = read_counters()["kve_ratio"]
    if standalone != 1 or not all(bool(r.isfinite().all()) for r in r_path):
        raise AssertionError("kve_ratio standalone run failed")

    rng = np.random.default_rng(0)
    lg2 = float(np.log10(2.0))
    sets = {  # float64; each cast to the dtype, the series set kept below 2
        "shuffled": 10.0 ** rng.uniform(-2.0, 2.3, N_SWEEP),
        "series": np.minimum(10.0 ** rng.uniform(-2.0, lg2, N_SWEEP),
                             np.nextafter(np.float32(2), np.float32(0))),
        "cf2": 10.0 ** rng.uniform(lg2, 2.3, N_SWEEP),
    }
    sets = {name: torch.from_numpy(z).cuda() for name, z in sets.items()}
    sets["ladder"] = z_ladder
    res = {"standalone": dict(n=z_path.numel(), launches=standalone)}
    for name, z64 in sets.items():
        for dtype in (torch.float32, torch.float64):
            z = z64.to(dtype)
            pairs = [(k.cpu().numpy(), p.cpu().numpy()) for k, p in zip(
                bessel.kve_ratio_both(z), special.kve_ratio_both(z))]
            differ = sum(int((~_same_bits(k, p)).sum()) for k, p in pairs)
            if differ:
                raise AssertionError(f"kve_ratio {name} {dtype}: {differ} "
                                     f"values differ from the plain version")
            res[f"{name} {str(dtype)[6:]}"] = dict(
                n=z.numel(), n_series=int((z.abs() < 2).sum()),
                bits_differ=differ,
                max_abs_err=max(float(np.nanmax(np.abs(k - p)))
                                for k, p in pairs),
                ms=cuda_ms(lambda: bessel.kve_ratio_both(z), 20),
                library_ms=cuda_ms(lambda: _library_kve_ratio(z), 20),
                plain_ms=cuda_ms(lambda: special.kve_ratio_both(z), 2),
                **bound(kve_ops(z), z.numel() * 3 * z.element_size(),
                        str(dtype)[6:]))
    out["kve_ratio"] = res
    line("phase 3 kve_ratio vs plain", **res)


def _library_kve_ratio(z):
    """(K_0'/K_0, K_1'/K_1) from PyTorch's K_0 and K_1: the yardstick of
    kve_ratio (the port never calls it; its K underflow at large z in
    float32 is not the kernel's concern)."""
    import torch
    k0 = torch.special.modified_bessel_k0(z)
    k1 = torch.special.modified_bessel_k1(z)
    return -k1 / k0, -k0 / k1 - 1.0 / z


def _compare_disp(what: str, kres, pres, f64: bool,
                  bits: bool = False) -> dict:
    """Hold a dispersion kernel's (det, mismatch, valid) against the plain
    version's.

    f64: det and mismatch to rtol 1e-9 away from poles (|det| > 1e6 x the
    median is masked); the values whose bits differ are counted, and held
    to 0 with `bits`. f32: det and mismatch bit-equal everywhere (NaN where
    the plain version has NaN), as the kernels are designed to be (no FMA,
    the plain version's expression order); the det signs where |det| > 1e-3
    x the median are counted as well."""
    import torch
    kdet, kmis, kval = kres
    pdet, pmis, pval = pres
    if not torch.equal(kval, pval):
        raise AssertionError(f"{what}: valid masks differ")
    if not torch.equal(kdet.isfinite(), pdet.isfinite()):
        raise AssertionError(f"{what}: finite masks differ")
    kd, pd = kdet.cpu().numpy(), pdet.cpu().numpy()
    fin = np.isfinite(pd)
    med = float(np.median(np.abs(pd[fin])))
    ok = fin & (np.abs(pd) < 1e6 * med)          # away from poles
    r = dict(n=len(pd), masked_poles=int((fin & ~ok).sum()),
             max_abs_err_det=float(np.max(np.abs(kd - pd)[ok])))
    if f64:
        km, pm = kmis.cpu().numpy(), pmis.cpu().numpy()
        r["det_bits_differ"] = int((~_same_bits(kd, pd)).sum())
        r["mismatch_bits_differ"] = int((~_same_bits(km, pm)).sum())
        r["max_rel_err_det"] = float(np.max(np.abs(kd - pd)[ok] / np.abs(pd)[ok]))
        r["max_rel_err_mismatch"] = float(np.nanmax(
            np.abs(km - pm)[ok] / np.abs(pm)[ok]))
        if not (r["max_rel_err_det"] <= 1e-9
                and r["max_rel_err_mismatch"] <= 1e-9):
            raise AssertionError(f"{what} vs plain beyond rtol 1e-9: {r}")
        if bits and (r["det_bits_differ"] or r["mismatch_bits_differ"]):
            raise AssertionError(f"{what} not bit-equal to plain: {r}")
    else:
        km, pm = kmis.cpu().numpy(), pmis.cpu().numpy()
        r["det_bits_differ"] = int((~_same_bits(kd, pd)).sum())
        r["mismatch_bits_differ"] = int((~_same_bits(km, pm)).sum())
        big = ok & (np.abs(pd) > 1e-3 * med)
        r["sign_checked"] = int(big.sum())
        r["sign_disagree"] = int(
            (np.signbit(kd[big]) != np.signbit(pd[big])).sum())
        if r["det_bits_differ"] or r["mismatch_bits_differ"]:
            raise AssertionError(f"{what} not bit-equal to plain: {r}")
    return r


def _same_bits(a, b):
    return (a == b) | (np.isnan(a) & np.isnan(b))


def check_row_layouts(what: str, case, kern, plain, dtype) -> dict:
    """The scan on each of tools_torch.batches.row_layout_batches'
    batches, one launch each, against the plain version on all of them at
    once, bit for bit; per batch the candidates that took the block's row
    table and the tabled exps (kernels.cylinder.scan_tabled): every one
    where the runs are at least a block long, some but not all on the runs
    of 37 (a warp with a lane outside its block's rows takes the
    per-candidate path), none on the others; the pole points' NaN and
    inf."""
    import torch
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    from tools_torch import batches
    numeric = case.grid.exterior_method == "numeric"
    segs = batches.row_layout_batches(case, dtype)
    want = plain(*[torch.cat([s[j] for s in segs.values()])
                   for j in range(3)])
    res, at = {}, 0
    kcyl.scan_tabled("cuda")
    for name, seg in segs.items():
        n = seg[0].numel()
        got = kern(*seg)
        rows, ext = kcyl.scan_tabled("cuda")
        for a, b in zip(got, want):
            x, y = a.cpu().numpy(), b[at:at + n].cpu().numpy()
            if not (x.dtype == bool and np.array_equal(x, y)
                    or x.dtype != bool and _same_bits(x, y).all()):
                raise AssertionError(f"{what} {name}: not bit-equal to "
                                     f"plain")
        at += n
        if name in batches.LONG_RUNS:
            bad = rows != n
        elif name == batches.MIXED_RUNS:
            bad = not 0 < rows < n
        else:
            bad = rows != 0
        if numeric:
            bad = (bad or not rows <= ext <= n
                   or (name in batches.LONG_RUNS and ext != n))
        else:
            bad = bad or ext != 0
        if bad:
            raise AssertionError(f"{what} {name}: {rows} of {n} candidates "
                                 f"through the row table, {ext} through "
                                 f"the exps' table")
        res[name] = dict(n=n, tabled_rows=rows, tabled_exterior=ext,
                         non_finite_det=int((~got.det.isfinite()).sum()))
    if not res["through the continua"]["non_finite_det"]:
        raise AssertionError(f"{what}: no pole point")
    return res


def phase_cylinder_disp(out: dict):
    import torch
    from eigensolver_tpu_torch import cases
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    from tools_torch import batches
    case = cases.cylinder_density_coronal(width=0.9)
    ph = CylinderPhysics.from_case(case)
    sph = CylinderPhysics.from_case(shallower(case))
    om, k, m = batches.ladder_draws(case, N_DISP_CHECK, seed=1)
    res = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        args = [x.to(dtype) for x in (om, k, m)]
        kern = ph.make_dispersion(m=None, dtype=dtype)
        # the check at a quarter of the depth, the kernel's time at the
        # case's own
        kres = sph.make_dispersion(m=None, dtype=dtype)(*args)
        pres, plain_ms = _timed_plain(
            sph.make_dispersion_plain(m=None, dtype=dtype), args)
        r = _compare_disp(f"cylinder_disp {name}", kres, pres,
                          f64=dtype == torch.float64)
        r.update(ms=cuda_ms(lambda: kern(*args), 5), plain_ms=plain_ms,
                 plain_n_interior=sph.case.grid.n_interior)
        res[name] = r
    # the full sweep's scan size: the kernel at both dtypes; the plain
    # version once at float32 (the sweep's scan dtype), held against the
    # kernel on the same candidates
    om_f, k_f, m_f = batches.ladder_draws(case, N_SWEEP, seed=2)
    full = {}
    g = case.grid
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        args = [x.to(dtype) for x in (om_f, k_f, m_f)]
        kern = ph.make_dispersion(m=None, dtype=dtype)
        full[name] = cuda_ms(lambda: kern(*args), 3)
        full[f"bound_{name}"] = bound(
            cyl_ops(N_SWEEP, 1, g.n_interior, g.n_axis_log,
                    exterior_args(case, om_f, k_f, dtype),
                    distinct(k_f, m_f)),
            N_SWEEP * (5 * args[0].element_size() + 1), name)
    args = [x.to(torch.float32) for x in (om_f, k_f, m_f)]
    kres = ph.make_dispersion(m=None, dtype=torch.float32)(*args)
    plain = ph.make_dispersion_plain(m=None, dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pres = plain(*args)
    torch.cuda.synchronize()
    full["plain_float32"] = 1e3 * (time.perf_counter() - t0)
    full["check_float32"] = _compare_disp("cylinder_disp full float32", kres,
                                          pres, f64=False)
    res["full_ms"] = full
    # the sweep's own scan in ladder order: every candidate through its
    # block's row table
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        args = batches.flat_ladder(case, 256, dtype)
        kern = ph.make_dispersion(m=None, dtype=dtype)
        kcyl.scan_tabled("cuda")
        kern(*args)
        tabled = kcyl.scan_tabled("cuda")[0]
        if tabled != N_SWEEP:
            raise AssertionError(f"cylinder_disp ladder {name}: {tabled} of "
                                 f"{N_SWEEP} through the row table")
        full[f"ladder_{name}"] = dict(
            ms=cuda_ms(lambda: kern(*args), 3), tabled_rows=tabled,
            **bound(cyl_ops(N_SWEEP, 1, g.n_interior, g.n_axis_log,
                            exterior_args(case, args[0], args[1], dtype),
                            distinct(args[1], args[2])),
                    N_SWEEP * (5 * args[0].element_size() + 1), name))
        res[f"row layouts {name}"] = check_row_layouts(
            f"cylinder_disp {name}", case, kern,
            ph.make_dispersion_plain(m=None, dtype=dtype), dtype)
    res["ptxas"] = ptxas_report("cylinder_disp_kernel", CYL_FORMS)
    # the tables' bytes as the kernel lays them out (csrc/cylinder_disp.cu::
    # scan_smem; the wrapper holds its own count to it at each launch)
    from eigensolver_tpu_torch.kernels import _build
    res["smem_bytes"] = {
        name: _build.library().eigk_cylinder_scan_smem(
            int(name == "float64"), kcyl.SCAN_SHAPE.chunk)
        for name in ("float32", "float64")}
    out["cylinder_disp"] = res
    line("phase 4 cylinder_disp vs plain", **res)


# the bool template argument of each scan kernel, by its value
SLAB_FORMS = {"0": " flux", "1": " shear", None: ""}
CYL_FORMS = {"0": "", "1": " twisted", None: ""}


def ptxas_entries(key_of) -> dict:
    """Registers and spill bytes of each kernel of the build's ptxas report
    (-Xptxas -v) whose mangled name key_of maps to a key (None: left
    out)."""
    import re
    from eigensolver_tpu_torch.kernels import _build
    log = _build.library_path().with_suffix(".log").read_text()
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            key = key_of(m.group(1))
            continue
        if key is None:
            continue
        # the entry's own line comes first; later ones are its callees'
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and "spill_stores" not in out.get(key, {}):
            out.setdefault(key, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def _type_name(code: str) -> str:
    return "float32" if code == "f" else "float64"


def ptxas_report(kernel: str, form: dict = SLAB_FORMS) -> dict:
    """Registers and spill bytes of each instantiation of the scan
    `kernel`, keyed by type, form (the slab's flux or shear, the cylinder's
    plain or twisted chain), block size, exterior and the slab's paired
    variant."""
    import re

    def key_of(name):
        if kernel not in name:
            return None
        # kernel<T, [bool form,] int threads, bool numeric exterior[,
        # bool paired]>
        t = re.search(kernel + r"I([fd])(?:Lb([01])E)?Li(\d+)ELb([01])E"
                      r"(?:Lb([01])E)?", name)
        return (f"{_type_name(t.group(1))}{form[t.group(2)]} {t.group(3)}"
                f"{' numeric' if t.group(4) == '1' else ''}"
                f"{' paired' if t.group(5) == '1' else ''}" if t else name)
    return ptxas_entries(key_of)


def spec_ptxas(chain: str) -> dict:
    """Registers and spill bytes of each instantiation of the fused kernel
    (csrc/bisect.cuh::spec_kernel) over `chain`'s Model: "slab"
    (slab::SpecChain<T, shear, numeric>), "cylinder" (SpecChain<T,
    numeric>) or "twisted" (TwModel<T, numeric>), keyed by type, form,
    exterior and register budget (x1: 128 registers a thread, x2: 64)."""
    import re
    model = {"slab": r"4slab9SpecChainI([fd])Lb([01])ELb([01])E",
             "cylinder": r"9SpecChainI([fd])()Lb([01])E",
             "twisted": r"7TwModelI([fd])()Lb([01])E"}[chain]
    forms = {"0": " flux", "1": " shear", "": ""}

    def key_of(name):
        t = re.search(r"spec_kernelINS_" + model + r"EELi(\d+)E", name)
        return (f"{_type_name(t.group(1))}{forms[t.group(2)]}"
                f"{' numeric' if t.group(3) == '1' else ''} x{t.group(4)}"
                if t else None)
    return ptxas_entries(key_of)


def _check_counts(what: str, counts: dict, refs) -> dict:
    """Hold per-branch root counts against each (source, counts, band) of
    refs (band None: not held); return the differences per source and
    branch."""
    diff = {}
    for source, want, band in refs:
        for branch, n in want.items():
            got = counts[branch]
            if band is not None and abs(got - n) > band * n:
                raise AssertionError(
                    f"{what}: {branch} {got} roots, {source} {n} (band "
                    f"+-{band:.2%} per branch); all counts {counts}")
            diff[f"{source}_{branch}"] = got - n
    return diff


def _check_roots(rs, case):
    lo, hi = min(case.speeds), max(case.speeds)
    for name, br in rs.branches.items():
        v = br.omegas / br.ks
        if not (np.all(np.isfinite(br.omegas)) and np.all((v > lo) & (v < hi))):
            raise AssertionError(f"{name}: non-finite roots or phase speeds "
                                 f"outside [{lo}, {hi}]")


def phase_sweep(out: dict):
    from eigensolver_tpu_torch import cases, search, sweep
    from eigensolver_tpu_torch.utils import StageTimer
    import warnings
    warnings.simplefilter("ignore")     # saturated-row notices, as expected
    case = cases.cylinder_density_coronal(width=0.9)
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")

    # the cylinder path, with every launch counter reset just before: one
    # ladder scan launch and one fused bracket-stage launch, nothing else
    reset_counters()
    rs, st = sweep.run_case(case, cfg, device="cuda")
    launches = read_counters()
    check_launches("cylinder path", launches,
                   {"cylinder_disp": 1, "cylinder_bisect": 1})
    if st.n_candidates != N_SWEEP:
        raise AssertionError(f"{st.n_candidates} candidates")
    _check_roots(rs, case)

    walls, stages, counts = [], [], []
    for _ in range(3):
        before = read_counters()
        timer = StageTimer()
        rs, st = sweep.run_case(case, cfg, device="cuda", timer=timer)
        check_launches("timed cylinder run", counts_since(before),
                       {"cylinder_disp": 1, "cylinder_bisect": 1})
        walls.append(st.wall_s)
        stages.append(timer.report())
        counts.append(rs.counts())
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"f32 root counts differ between runs: {counts}")
    f32 = dict(counts=counts[0], total=sum(counts[0].values()),
               minus_refs=_check_counts("cyl_co_09 float32", counts[0],
                                        CYL_COUNTS["float32"]),
               wall_s=walls, median_wall_s=statistics.median(walls),
               candidates_per_s=N_SWEEP / statistics.median(walls),
               stages_median_s={k: statistics.median(s[k] for s in stages)
                                for k in stages[0]})

    cfg64 = dataclasses.replace(cfg, scan_dtype="float64",
                                polish_dtype="float64")
    rs64, st64 = sweep.run_case(case, cfg64, device="cuda")
    _check_roots(rs64, case)
    f64 = dict(counts=rs64.counts(), total=sum(rs64.counts().values()),
               minus_refs=_check_counts("cyl_co_09 float64", rs64.counts(),
                                        CYL_COUNTS["float64"]),
               wall_s=st64.wall_s)

    # a small input against the reference: the same reduced sweep on the
    # card and on the CPU (plain version, held equal to the JAX package by
    # tests/test_torch_sweep.py), and the JAX package's counts
    small = dataclasses.replace(
        case, k_values=(0.5, 2.0),
        grid=dataclasses.replace(case.grid, n_interior=256, n_axis_log=32))
    scfg = search.SearchConfig(n_omega=64, n_bisect=30)
    rs_gpu, _ = sweep.run_case(small, scfg, device="cuda")
    rs_cpu, _ = sweep.run_case(small, scfg, device="cpu")
    if not rs_gpu.counts() == rs_cpu.counts() == JAX_COUNTS_REDUCED:
        raise AssertionError(f"reduced sweep: card {rs_gpu.counts()}, cpu "
                             f"{rs_cpu.counts()}, JAX {JAX_COUNTS_REDUCED}")
    dev = max(float(np.max(np.abs(rs_gpu[b].omegas / rs_cpu[b].omegas - 1)))
              for b in rs_cpu.branches)
    if not dev <= 1e-10:
        raise AssertionError(f"reduced sweep roots card vs cpu: {dev:.3e}")

    out["sweep"] = dict(main_path_launches=launches, float32=f32,
                        float64=f64, reduced_max_rel_dev=dev)
    line("phase 5 sweep cyl_co_09", **out["sweep"])
    return launches


def window_candidates(case):
    """The float64 window ends of the refine stage of the case's float32
    sweep (n_omega=256, n_bisect=18, on the card): 10 per root, in the
    order of the stage's one dispersion call, as CUDA tensors (omega, k,
    parity)."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")
    rs, _ = sweep.run_case(case, cfg, device="cuda")
    br = [(m, rs[name]) for m, name in sweep.MODE_NAMES.items()]
    om, kk, md = (torch.from_numpy(np.concatenate(x)).to(
        device="cuda", dtype=torch.float64) for x in (
        [b.omegas for _, b in br], [b.ks for _, b in br],
        [np.full(len(b.ks), float(m)) for m, b in br]))
    return list(search.refine_window_ends(om, kk, md)[2])


def _time_against_plain(what: str, ph, check_ph, args, shear: bool) -> dict:
    """The unpaired slab_disp on the candidates args: its time and bound
    (the chain once per distinct (omega, k)) at ph's depth, none of them
    counted as paired; the kernel's and the plain version's bits, and the
    plain version's time, on the same candidates at check_ph's depth."""
    import torch
    from eigensolver_tpu_torch.kernels import slab as kslab
    dtype = args[0].dtype
    dname = str(dtype).split(".")[-1]
    n = args[0].numel()
    kern = ph.make_dispersion(parity=None, dtype=dtype)
    before = kslab.paired
    r = dict(n=n, shape=list(kslab.scan_shape(n, shear)),
             ms=cuda_ms(lambda: kern(*args), 5),
             **bound(slab_ops(n, 1, ph.case.grid.n_interior, shear,
                              n_chains=distinct(args[0], args[1])),
                     n * (5 * args[0].element_size() + 1), dname))
    kres = check_ph.make_dispersion(parity=None, dtype=dtype)(*args)
    if kslab.paired != before:
        raise AssertionError(f"{what}: counted as paired")
    plain = check_ph.make_dispersion_plain(parity=None, dtype=dtype)
    pres, r["plain_ms"] = _timed_plain(plain, args)
    r["plain_n_interior"] = check_ph.case.grid.n_interior
    r["check"] = _compare_disp(what, kres, pres, f64=dtype == torch.float64,
                               bits=True)
    return r


def _paired_scan(what: str, case, args, reps: int) -> dict:
    """The paired slab_disp (disp.both_parities) on a sweep's whole ladder
    in ladder order, args (omega, k, mode): every row at parity 0, then the
    same rows at parity 1. One launch on the parity-0 half, every
    candidate counted as paired; its time beside the unpaired scan's on
    the same candidates; its bound (the chain, and the numeric exterior,
    once per (omega, k); 2 chains a step at a power-of-two n_interior)
    beside the old one (3 chains a step and the exterior for every
    candidate); the plain version's time and bits on the same
    candidates."""
    import torch
    from eigensolver_tpu_torch.kernels import slab as kslab
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    ph = SlabPhysics.from_case(case)
    dtype = args[0].dtype
    dname = str(dtype).split(".")[-1]
    n = args[0].numel()
    h = n // 2
    if not (torch.equal(args[0][:h], args[0][h:])
            and torch.equal(args[1][:h], args[1][h:])
            and bool((args[2][:h] == 0).all())
            and bool((args[2][h:] == 1).all())):
        raise AssertionError(f"{what}: not both parities of one row set")
    disp = ph.make_dispersion(parity=None, dtype=dtype)
    half = [x[:h].contiguous() for x in args[:2]]
    before = kslab.paired
    kres = disp.both_parities(*half)
    torch.cuda.synchronize()
    if kslab.paired - before != n:
        raise AssertionError(f"{what}: {kslab.paired - before} of {n} "
                             f"candidates counted as paired")
    numeric = case.grid.exterior_method == "numeric"

    def ops(every_chain):
        if numeric:
            return numeric_ops(case, n, 1, args[1], args[2], n_chains=h,
                               every_chain=every_chain)
        return slab_ops(n, 1, case.grid.n_interior, ph.has_flow,
                        n_chains=h, every_chain=every_chain)
    es = args[0].element_size()
    r = dict(n=n, shape=list(kslab.PAIRS_SHAPE[ph.has_flow]),
             ms=cuda_ms(lambda: disp.both_parities(*half), reps),
             unpaired_ms=cuda_ms(lambda: disp(*args), reps),
             **bound(ops(False), 2 * h * es + n * (2 * es + 1), dname),
             bound_3_chains_ms=bound(ops(True), n * (5 * es + 1),
                                     dname)["bound_ms"])
    pres, r["plain_ms"] = _timed_plain(
        ph.make_dispersion_plain(parity=None, dtype=dtype), args)
    r["check"] = _compare_disp(what, kres, pres, f64=dname == "float64",
                               bits=True)
    return r


def phase_slab_disp(out: dict):
    import torch
    from eigensolver_tpu_torch import cases
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    from tools_torch import batches
    res = {}
    forms = (("flux slab_ph_09", cases.slab_density_photospheric(0.9), N_SLAB),
             ("shear flow_gauss", cases.slab_flow_gaussian_coronal(), N_FLOW))
    # the draws' checks at a quarter of the depth (`shallower`), the
    # kernel's times at the case's own; the paired scans' below at full
    for name, case, _ in forms:
        ph = SlabPhysics.from_case(case)
        sph = SlabPhysics.from_case(shallower(case))
        om, k, par = batches.ladder_draws(case, N_DISP_CHECK, seed=3)
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            args = [x.to(dtype) for x in (om, k, par)]
            kern = ph.make_dispersion(parity=None, dtype=dtype)
            kres = sph.make_dispersion(parity=None, dtype=dtype)(*args)
            pres, plain_ms = _timed_plain(
                sph.make_dispersion_plain(parity=None, dtype=dtype), args)
            r = _compare_disp(f"slab_disp {name} {dname}", kres, pres,
                              f64=dtype == torch.float64, bits=True)
            r.update(ms=cuda_ms(lambda: kern(*args), 5), plain_ms=plain_ms,
                     plain_n_interior=sph.case.grid.n_interior)
            res[f"{name} {dname}"] = r
    # each form at its sweep's scan size, both types
    full = {}
    for name, case, n in forms:
        ph = SlabPhysics.from_case(case)
        sph = SlabPhysics.from_case(shallower(case))
        cand = batches.ladder_draws(case, n, seed=4)
        for dtype in (torch.float32, torch.float64):
            what = f"{name} {str(dtype).split('.')[-1]}"
            full[what] = _time_against_plain(
                f"slab_disp full {what}", ph, sph,
                [x.to(dtype) for x in cand], shear=name.startswith("shear"))
    res["full"] = full
    # each sweep's own scan, its whole ladder in ladder order, through the
    # paired scan
    ladder = {}
    for name, case, n in forms:
        for dtype in (torch.float32, torch.float64):
            what = f"{name} {str(dtype).split('.')[-1]}"
            args = batches.flat_ladder(case, 256, dtype)
            if args[0].numel() != n:
                raise AssertionError(f"{what}: {args[0].numel()} candidates")
            ladder[what] = _paired_scan(f"slab_disp paired {what}", case,
                                        args, 5)
    res["ladder paired"] = ladder
    # the refine stage's float64 window launch of the slab_ph_09 f32 sweep
    case = forms[0][1]
    res["window float64"] = _time_against_plain(
        "slab_disp window float64", SlabPhysics.from_case(case),
        SlabPhysics.from_case(shallower(case)), window_candidates(case),
        shear=False)
    res["ptxas"] = ptxas_report("slab_disp_kernel")
    out["slab_disp"] = res
    line("phase 6 slab_disp vs plain", **res)


def phase_slab_sweep(out: dict):
    from eigensolver_tpu_torch import cases, search, sweep
    from eigensolver_tpu_torch.utils import StageTimer
    import warnings
    warnings.simplefilter("ignore")     # saturated-row notices, as expected
    case = cases.slab_density_photospheric(0.9)
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")

    # the slab path, with every launch counter reset just before: one
    # ladder scan launch, the paired scan's (every candidate counted as
    # paired), and one fused bracket-stage launch, nothing else
    want = {"slab_disp": 1, "slab_bisect": 1, "slab_paired": N_SLAB}
    reset_counters()
    rs, st = sweep.run_case(case, cfg, device="cuda")
    launches = read_counters()
    check_launches("slab path", launches, want)
    if st.n_candidates != N_SLAB:
        raise AssertionError(f"{st.n_candidates} candidates")
    _check_roots(rs, case)

    walls, stages, counts = [], [], []
    for _ in range(3):
        before = read_counters()
        timer = StageTimer()
        rs, st = sweep.run_case(case, cfg, device="cuda", timer=timer)
        check_launches("timed slab run", counts_since(before), want)
        walls.append(st.wall_s)
        stages.append(timer.report())
        counts.append(rs.counts())
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"f32 root counts differ between runs: {counts}")
    f32 = dict(counts=counts[0],
               minus_refs=_check_counts("slab_ph_09 float32", counts[0],
                                        SLAB_COUNTS["float32"]),
               wall_s=walls, median_wall_s=statistics.median(walls),
               candidates_per_s=N_SLAB / statistics.median(walls),
               stages_median_s={k: statistics.median(s[k] for s in stages)
                                for k in stages[0]})

    cfg64 = dataclasses.replace(cfg, scan_dtype="float64",
                                polish_dtype="float64")
    before = read_counters()
    rs64, st64 = sweep.run_case(case, cfg64, device="cuda")
    check_launches("slab float64 path", counts_since(before), want)
    _check_roots(rs64, case)
    f64 = dict(counts=rs64.counts(),
               minus_refs=_check_counts("slab_ph_09 float64", rs64.counts(),
                                        SLAB_COUNTS["float64"]),
               wall_s=st64.wall_s)

    flows = {}
    for name, refs in FLOW_COUNTS.items():
        fcase = getattr(cases, name)()
        before = read_counters()
        frs, fst = sweep.run_case(fcase, cfg64, device="cuda")
        # the shear form's scan paired too
        check_launches(f"{name} float64 path", counts_since(before),
                       {"slab_disp": 1, "slab_bisect": 1,
                        "slab_paired": fst.n_candidates})
        _check_roots(frs, fcase)
        flows[name] = dict(counts=frs.counts(), wall_s=fst.wall_s,
                           minus_refs=_check_counts(f"{name} float64",
                                                    frs.counts(), refs))

    # f32 sweep refined in f64 on the card: the scan and the bracket stage,
    # then the f64 refine windows (one slab_disp launch) and the f64 refine
    # bisection (one slab_bisect launch); once, then 3 timed runs
    walls, stages = [], []
    for _ in range(4):
        before = read_counters()
        timer = StageTimer()
        rsr, str_ = sweep.run_case(case, cfg, device="cuda", refine_f64=True,
                                   timer=timer)
        refined_launches = counts_since(before)
        check_launches("refined slab path", refined_launches,
                       {"slab_disp": 2, "slab_bisect": 2,
                        "slab_paired": N_SLAB})
        _check_roots(rsr, case)
        if rsr.counts() != counts[0]:
            raise AssertionError(f"refined counts {rsr.counts()} differ from "
                                 f"the f32 sweep's {counts[0]}")
        walls.append(str_.wall_s)
        stages.append(timer.report())
    walls, stages = walls[1:], stages[1:]
    refined = dict(counts=rsr.counts(), wall_s=walls,
                   median_wall_s=statistics.median(walls),
                   stages_median_s={k: statistics.median(s[k] for s in stages)
                                    for k in stages[0]},
                   launches=refined_launches,
                   minus_refs=_check_counts(
                       "slab_ph_09 float32 refined", rsr.counts(),
                       SLAB_COUNTS["float32_refined"]))

    # a small input against the reference: the same reduced sweep on the
    # card and on the CPU (plain version, held equal to the JAX package by
    # tests/test_torch_sweep.py)
    small = dataclasses.replace(
        case, k_values=(0.5, 1.5, 2.5, 3.5),
        grid=dataclasses.replace(case.grid, n_interior=256))
    scfg = search.SearchConfig(n_omega=64, n_bisect=30)
    rs_gpu, _ = sweep.run_case(small, scfg, device="cuda")
    rs_cpu, _ = sweep.run_case(small, scfg, device="cpu")
    if rs_gpu.counts() != rs_cpu.counts():
        raise AssertionError(f"reduced slab sweep: card {rs_gpu.counts()}, "
                             f"cpu {rs_cpu.counts()}")
    dev = max(float(np.max(np.abs(rs_gpu[b].omegas / rs_cpu[b].omegas - 1)))
              for b in rs_cpu.branches)
    if not dev <= 1e-10:
        raise AssertionError(f"reduced slab sweep roots card vs cpu: {dev:.3e}")

    # the refinement on the card against the same on the CPU: a reduced
    # uniform-flow sweep (shear form) at f32, refined in f64 (the CPU run is
    # held equal to the JAX package's by tests/test_torch_sweep.py)
    flow = cases.slab_flow_uniform_photospheric()
    small = dataclasses.replace(
        flow, k_values=(0.5, 1.5, 2.5, 3.5),
        grid=dataclasses.replace(flow.grid, n_interior=256))
    scfg = search.SearchConfig(n_omega=64, n_bisect=18, scan_dtype="float32",
                               polish_dtype="float32")
    rf_gpu, _ = sweep.run_case(small, scfg, device="cuda", refine_f64=True)
    rf_cpu, _ = sweep.run_case(small, scfg, device="cpu", refine_f64=True)
    if rf_gpu.counts() != rf_cpu.counts():
        raise AssertionError(f"reduced refined sweep: card {rf_gpu.counts()}, "
                             f"cpu {rf_cpu.counts()}")
    rdev = max(float(np.max(np.abs(rf_gpu[b].omegas / rf_cpu[b].omegas - 1)))
               for b in rf_cpu.branches)
    if not rdev <= 1e-12:
        raise AssertionError(f"reduced refined roots card vs cpu: {rdev:.3e}")

    out["slab_sweep"] = dict(main_path_launches=launches, float32=f32,
                             float64=f64, flows_float64=flows,
                             float32_refined=refined,
                             reduced_counts=rs_gpu.counts(),
                             reduced_max_rel_dev=dev,
                             reduced_refined_counts=rf_gpu.counts(),
                             reduced_refined_max_rel_dev=rdev)
    line("phase 7 sweep slab_ph_09", **out["slab_sweep"])
    return launches


def sweep_brackets(case, dtype, cfg=None):
    """The brackets of the case's bracket stage, as CUDA tensors (lo, hi, k,
    mode): the scan in `dtype` on the card over the case's modes, cfg's
    continuum mask and pole pre-filter, find_brackets (cfg default:
    n_omega=256, 8 per row, no mask)."""
    from eigensolver_tpu_torch import search, sweep
    from tools_torch import batches
    cfg = cfg or search.SearchConfig(n_omega=256, max_brackets_per_row=8)
    om, kk, md = batches.ladder_rows(case, cfg.n_omega, dtype)
    disp = sweep.make_dispersion_moded(case, dtype)
    det, valid, mism = search.ladder_scan(disp, om, kk, md)
    if cfg.exclude_v_ranges:
        det = search.mask_v_ranges(om, kk, det, cfg.exclude_v_ranges)
    br = search.find_brackets(om, kk, det, valid, cfg.max_brackets_per_row,
                              md, pole_det_factor=cfg.pole_det_factor,
                              mism=mism)
    return [x.contiguous() for x in (br.lo, br.hi, br.k, br.mode)]


def bisect_fn(case):
    """The case's fused bisection wrapper and its parameters."""
    from eigensolver_tpu_torch.kernels import cylinder as kcyl, slab as kslab
    kmod = kslab if case.geometry.value == "slab" else kcyl
    return getattr(kmod, f"{case.geometry.value}_bisect"), kmod.disp_params(
        case)


def wrapper_shape(case, n: int, dtype):
    """The block shape the case's bisection wrapper launches for n
    brackets: the twisted chain's spec_shape, the numeric exterior's
    numeric_spec_shape (the density/axial-flow cylinder's
    numeric_bisect_shape), else analytic_spec_shape."""
    from eigensolver_tpu_torch.kernels import common, cylinder
    params = bisect_fn(case)[1].struct
    eb = entry_bytes(case, dtype)
    if getattr(params, "twisted", 0):
        return common.spec_shape(n, dtype, eb)
    if params.exterior_numeric and case.geometry.value == "cylinder":
        return cylinder.numeric_bisect_shape(n, dtype)
    if params.exterior_numeric:
        return common.numeric_spec_shape(n, dtype, eb)
    return common.analytic_spec_shape(n, dtype, eb,
                                      bool(getattr(params, "shear", 0)))


def phase_bisect(out: dict, phase: str, name: str, case, n_br: int, ops,
                 key: str = None, plain_n_iter: int = PLAIN_N_ITER,
                 plain_types=("float32", "float64"), loop_small: bool = False,
                 refine=None, chain: str = None, ops_every_chain=None):
    """The fused bracket stage `name` on the case's own brackets: (root,
    mismatch) bit-equal to the loop of scan launches at float32 and float64
    (both timed), and at the types of plain_types with n_iter=plain_n_iter
    to the loop over the plain dispersion (timed once), both at
    `shallower(case)`'s depth on the same brackets; the
    bound from `ops(brackets, dtype, evaluations)`, the operations of the
    evaluations the loop needs. With `refine` (the refine stage's float64
    brackets), that batch too (`_refine_bisect`); with `chain`, the ptxas
    report of the fused kernel's instantiations over its Model; with
    `ops_every_chain`, the bound of that count too (bound_every_chain_ms:
    3 chains a step). The report goes to out[key or name]. loop_small: the
    loop's launches take the twisted chain's small-batch path
    (cylinder_disp_small)."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    res = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        br = sweep_brackets(case, dtype)
        if br[0].numel() != n_br:
            raise AssertionError(f"{name}: {br[0].numel()} brackets")
        disp = sweep.make_dispersion_moded(case, dtype)
        before = read_counters()
        fused = disp.bisect(*br, N_BISECT)
        loop = search.bisect_loop(disp, *br, N_BISECT)
        torch.cuda.synchronize()
        check_launches(f"{name} {dname}", counts_since(before),
                       {name: 1, name.replace("bisect", "disp"): N_BISECT + 2,
                        **({"cylinder_disp_small": N_BISECT + 2}
                           if loop_small else {})})
        differ = [int((~_same_bits(a.cpu().numpy(), b.cpu().numpy())).sum())
                  for a, b in zip(fused, loop)]
        if any(differ):
            raise AssertionError(f"{name} {dname}: {differ} (root, mismatch) "
                                 f"values differ from the launch loop")
        r = dict(n=n_br, shape=list(wrapper_shape(case, n_br, dtype)),
                 root_bits_differ=differ[0], mismatch_bits_differ=differ[1],
                 ms=cuda_ms(lambda: disp.bisect(*br, N_BISECT), 5),
                 loop_ms=cuda_ms(lambda: search.bisect_loop(disp, *br,
                                                            N_BISECT), 2),
                 **bound(ops(br, dtype, N_BISECT + 2),
                         n_br * 6 * br[0].element_size(), dname))
        if ops_every_chain is not None:
            r["bound_every_chain_ms"] = bound(
                ops_every_chain(br, dtype, N_BISECT + 2),
                n_br * 6 * br[0].element_size(), dname)["bound_ms"]
        if dname in plain_types:
            pcase = shallower(case)
            pdisp = sweep.make_dispersion_moded(pcase, dtype)
            pplain = _physics(pcase)[1](dtype)
            got = pdisp.bisect(*br, plain_n_iter)
            want, r["plain_ms"] = _timed_plain(
                lambda *a: search.bisect_loop(pplain, *a, plain_n_iter), br)
            r["plain_n_iter"] = plain_n_iter
            r["plain_n_interior"] = pcase.grid.n_interior
            r["ms_plain_n_iter"] = cuda_ms(
                lambda: pdisp.bisect(*br, plain_n_iter), 5)
            a, b = got[0].cpu().numpy(), want[0].cpu().numpy()
            r["max_abs_err_vs_plain"] = float(np.nanmax(np.abs(a - b)))
            differ = [int((~_same_bits(x.cpu().numpy(), y.cpu().numpy())).sum())
                      for x, y in zip(got, want)]
            if any(differ):
                raise AssertionError(f"{name} {dname}: {differ} (root, "
                                     f"mismatch) values differ from the plain "
                                     f"loop")
        res[dname] = r
    if refine is not None:
        res["refine float64"] = _refine_bisect(name, case, refine, ops)
    if chain is not None:
        res["ptxas"] = spec_ptxas(chain)
    out[key or name] = res
    line(phase, **res)


def _refine_bisect(name: str, case, br, ops) -> dict:
    """The refine stage's float64 bisection (N_REFINE_ITER iterations, no
    residual) of the case's brackets br at the wrapper's speculative shape:
    bit-equal to the loop of scan launches, and so is the loop's schedule
    (L = 0); both timed beside the loop. At REFINE_PLAIN_N_ITER iterations
    bit-equal to the plain speculative bisection at the same L over the
    plain dispersion. The bound counts the evaluations the loop needs."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    from eigensolver_tpu_torch.kernels import common
    f64 = torch.float64
    n = br[0].numel()
    disp = sweep.make_dispersion_moded(case, f64)
    fn, params = bisect_fn(case)
    shape = wrapper_shape(case, n, f64)
    l0 = common.spec_shape(n, f64, entry_bytes(case, f64), levels=0)

    def fused(n_iter, sh):
        return fn(*br, n_iter, params, False, shape=sh)

    loop = search.bisect_loop(disp, *br, N_REFINE_ITER, False)
    for sh in (shape, l0):
        differ = int((~_same_bits(fused(N_REFINE_ITER, sh)[0].cpu().numpy(),
                                  loop[0].cpu().numpy())).sum())
        if differ:
            raise AssertionError(f"{name} refine L={sh.levels}: {differ} "
                                 f"roots differ from the launch loop")
    need = spec_evals(N_REFINE_ITER, False, 1)
    r = dict(n=n, n_iter=N_REFINE_ITER, shape=list(shape), evals_needed=need,
             evals=spec_evals(N_REFINE_ITER, False, shape.levels),
             ms=cuda_ms(lambda: fused(N_REFINE_ITER, shape), 5),
             L0_shape=list(l0), L0_ms=cuda_ms(lambda: fused(N_REFINE_ITER, l0),
                                              5),
             loop_ms=cuda_ms(lambda: search.bisect_loop(
                 disp, *br, N_REFINE_ITER, False), 2),
             **bound(ops(br, f64, need), n * 5 * 8, "float64"))
    got = fused(REFINE_PLAIN_N_ITER, shape)
    plain = _physics(case)[1](f64)
    want, r["plain_ms"] = _timed_plain(lambda *a: search.bisect_loop(
        plain, *a, REFINE_PLAIN_N_ITER, False, levels=shape.levels), br)
    r["plain_n_iter"] = REFINE_PLAIN_N_ITER
    a, b = got[0].cpu().numpy(), want[0].cpu().numpy()
    r["max_abs_err_vs_plain"] = float(np.nanmax(np.abs(a - b)))
    differ = int((~_same_bits(a, b)).sum())
    if differ:
        raise AssertionError(f"{name} refine: {differ} roots differ from the "
                             f"plain speculative bisection at L = "
                             f"{shape.levels}")
    return r


def spec_evals(n_iter: int, final_eval: bool, levels: int) -> int:
    """Evaluations a bracket takes in the speculative bisection
    (csrc/bisect.cuh::spec_kernel): f(lo) and the 2^d - 1 nodes of each
    round's d <= L levels, n_iter + final_eval levels in all (L = 0, the
    loop's schedule, and L = 1 take the loop's evaluations, which the
    function needs)."""
    levels = max(levels, 1)
    n_lv = n_iter + int(final_eval)
    rounds = [min(levels, n_lv - done) for done in range(0, n_lv, levels)]
    return int(n_iter > 0) + sum(2 ** d - 1 for d in rounds)


def refine_stage(case):
    """The float64 window ends of the refine stage of the case's
    float32 sweep (n_omega=256, n_bisect=18, on the card), 10 per root in
    the order of the stage's one dispersion call, and its brackets (the
    first window of each root that brackets, as search.refine_windows
    picks it): ((omega, k, m), (lo, hi, k, m)) CUDA tensors."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")
    rs, _ = sweep.run_case(case, cfg, device="cuda")
    mode_of = {b: m for m, b in sweep.MODE_NAMES.items()}
    om, kk, md = (torch.from_numpy(np.concatenate(x)).to(
        device="cuda", dtype=torch.float64) for x in (
        [rs[b].omegas for b in rs.branches], [rs[b].ks for b in rs.branches],
        [np.full(len(rs[b].ks), float(mode_of[b])) for b in rs.branches]))
    ends = list(search.refine_window_ends(om, kk, md)[2])
    disp64 = sweep.make_dispersion_moded(case, torch.float64)
    lo, hi, _ = search.refine_windows(disp64, om, kk, md)
    return ends, [lo, hi, kk, md]


def twisted_attrs(kind: int, threads: int, min_blocks: int, smem: int,
                  dtype) -> dict:
    """Registers, local (spill) bytes a thread, shared memory and blocks
    per SM of a twisted kernel (kind 0: the scan, min_blocks unread; 1: the
    fused kernel at budget min_blocks)."""
    import ctypes
    import torch
    from eigensolver_tpu_torch.kernels import _build
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().eigk_cylinder_tw_attrs(
        int(dtype == torch.float64), kind, threads, min_blocks, smem, out),
        "eigk_cylinder_tw_attrs")
    return {"threads": threads, "min_blocks": min_blocks, "registers": out[0],
            "local_bytes": out[1], "smem_bytes": smem,
            "blocks_per_sm": out[2]}


def twisted_shapes() -> dict:
    """The default launch shapes of the twisted kernels at the main path's
    sizes (the 76,800 scan, the 8,192 and 3,090 small batches, the 2,400
    and 309 bisections) with each one's registers, spills, shared memory
    and blocks per SM."""
    import torch
    from eigensolver_tpu_torch.kernels import common, cylinder as kcyl
    res = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        eb = kcyl._ENTRY_BYTES[dtype, True]
        sh = kcyl.TW_SCAN_SHAPE[dtype]
        res[f"scan {N_TWIST} {dname}"] = dict(shape=list(sh), **twisted_attrs(
            0, sh.threads, 0, 2 * 3 * sh.chunk * eb, dtype))
        for what, n, ev in (("eval", N_DISP_CHECK, True),
                            ("eval", N_WINDOWS, True),
                            ("bisect", N_BR_TWIST, False),
                            ("bisect", N_REFINE_TWIST, False)):
            sp = common.spec_shape(n, dtype, eb, ev)
            threads = 32 * (sp.producers + 1)
            smem = common.spec_smem(sp, dtype, eb)
            budgets = {}
            for mb in (1, 2):
                budgets[mb] = twisted_attrs(1, threads, mb, smem, dtype)
            blocks = -(-n // sp.brackets)
            # the budget launch_spec picks with min_blocks = 0
            mb = sp.min_blocks or (1 if blocks <= _SMS * budgets[1][
                "blocks_per_sm"] else 2)
            res[f"{what} {n} {dname}"] = dict(shape=list(sp), blocks=blocks,
                                              **budgets[mb])
    return res


def phase_twisted_disp(out: dict):
    import torch
    from eigensolver_tpu_torch import sweep
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    from tools_torch import batches
    res = {}
    for name, case in twisted_cases().items():
        # the checks at a quarter of the depth (`shallower`), the kernel's
        # times at the case's own
        full_kern = CylinderPhysics.from_case(case).make_dispersion
        full_params = kcyl.disp_params(case)
        om, k, m = batches.ladder_draws(case, N_DISP_CHECK, seed=7)
        case = shallower(case)
        ph = CylinderPhysics.from_case(case)
        params = kcyl.disp_params(case)
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            args = [x.to(dtype) for x in (om, k, m)]
            kern = ph.make_dispersion(m=None, dtype=dtype)
            plain = ph.make_dispersion_plain(m=None, dtype=dtype)
            before = read_counters()
            kres = kern(*args)              # 8,192: the small-batch path
            torch.cuda.synchronize()
            check_launches(f"twisted {name} {dname} small batch",
                           counts_since(before),
                           {"cylinder_disp": 1, "cylinder_disp_small": 1})
            t0 = time.perf_counter()
            pres = plain(*args)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            r = _compare_disp(f"twisted cylinder_disp {name} {dname}", kres,
                              pres, f64=dtype == torch.float64, bits=True)
            scan = kcyl.TW_SCAN_SHAPE[dtype]
            r["scan"] = _compare_disp(
                f"twisted cylinder_disp scan {name} {dname}",
                kcyl.cylinder_disp(*args, params, shape=scan), pres,
                f64=dtype == torch.float64, bits=True)
            fkern = full_kern(m=None, dtype=dtype)
            r.update(ms=cuda_ms(lambda: fkern(*args), 5),
                     scan_ms=cuda_ms(lambda: kcyl.cylinder_disp(
                         *args, full_params, shape=scan), 5),
                     plain_ms=plain_ms, plain_n_interior=case.grid.n_interior)
            res[f"{name} {dname}"] = r
    # each case's whole scan as its sweep gives it: the ladder in order,
    # m = 1; the kernel at both types beside its bound; twist_v01_p1's
    # plain version once at float32
    full = {}
    for case_name, case in twisted_cases().items():
        ph = CylinderPhysics.from_case(case)
        omegas, ks = sweep.build_ladders(case, 256)
        om_f = torch.from_numpy(omegas.ravel()).cuda()
        k_f = torch.from_numpy(np.repeat(ks, omegas.shape[1])).cuda()
        m_f = torch.ones_like(om_f)
        if om_f.numel() != N_TWIST:
            raise AssertionError(f"{om_f.numel()} twisted candidates")
        r = full[case_name] = {"n": N_TWIST}
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).split(".")[-1]
            args = [x.to(dtype) for x in (om_f, k_f, m_f)]
            kern = ph.make_dispersion(m=None, dtype=dtype)
            r[name] = cuda_ms(lambda: kern(*args), 5)
            r[f"bound_{name}"] = bound(
                cyl_tw_ops(case, N_TWIST, 1,
                           exterior_args(case, om_f, k_f, dtype)),
                N_TWIST * (5 * args[0].element_size() + 1), name)
        if case_name != "twist_v01_p1":
            continue
        # the check at a quarter of the depth
        args = [x.to(torch.float32) for x in (om_f, k_f, m_f)]
        sph = CylinderPhysics.from_case(shallower(case))
        kres = sph.make_dispersion(m=None, dtype=torch.float32)(*args)
        pres, r["plain_float32"] = _timed_plain(
            sph.make_dispersion_plain(m=None, dtype=torch.float32), args)
        r["plain_n_interior"] = sph.case.grid.n_interior
        r["check_float32"] = _compare_disp(
            "twisted cylinder_disp full float32", kres, pres, f64=False)
    res["full_ms"] = full
    # the refine stage's float64 window launch of the twist_v01_p1 float32
    # sweep: the small-batch path (its default) and the scan, each bit-equal
    # to the plain version at a quarter of the depth, timed at the full one
    case = twisted_cases()["twist_v01_p1"]
    ends, _ = refine_stage(case)
    n = ends[0].numel()
    kern = CylinderPhysics.from_case(case).make_dispersion(
        m=None, dtype=torch.float64)
    params = kcyl.disp_params(case)
    shallow = shallower(case)
    sph = CylinderPhysics.from_case(shallow)
    sparams = kcyl.disp_params(shallow)
    scan = kcyl.TW_SCAN_SHAPE[torch.float64]
    kres = sph.make_dispersion(m=None, dtype=torch.float64)(*ends)
    pres, plain_ms = _timed_plain(
        sph.make_dispersion_plain(m=None, dtype=torch.float64), ends)
    res["window float64"] = dict(
        n=n, ms=cuda_ms(lambda: kern(*ends), 5),
        scan_ms=cuda_ms(lambda: kcyl.cylinder_disp(*ends, params,
                                                   shape=scan), 5),
        plain_ms=plain_ms, plain_n_interior=shallow.grid.n_interior,
        check=_compare_disp("twisted window float64", kres, pres, f64=True,
                            bits=True),
        scan_check=_compare_disp(
            "twisted window float64 scan",
            kcyl.cylinder_disp(*ends, sparams, shape=scan), pres, f64=True,
            bits=True),
        **bound(cyl_tw_ops(case, n, 1, exterior_args(case, ends[0], ends[1],
                                                     torch.float64)),
                n * (5 * 8 + 1), "float64"))
    res["shapes"] = twisted_shapes()
    res["ptxas"] = ptxas_report("cylinder_disp_kernel", CYL_FORMS)
    res["ptxas_twisted"] = twisted_ptxas()
    out["twisted_disp"] = res
    line("phase 10 twisted cylinder_disp vs plain", **res)


def twisted_ptxas() -> dict:
    """Registers and spill bytes of the twisted kernels from the build's
    ptxas report: the scan by type, the fused kernel by type and budget."""
    import re

    def key_of(name):
        t = re.search(r"tw_scan_kernelI([fd])Lb([01])E", name)
        return (f"scan {_type_name(t.group(1))}"
                f"{' numeric' if t.group(2) == '1' else ''}" if t else None)
    return {**ptxas_entries(key_of),
            **{f"fused {k}": v for k, v in spec_ptxas("twisted").items()}}


def phase_twisted_sweep(out: dict):
    from eigensolver_tpu_torch import search, sweep
    from eigensolver_tpu_torch.equilibrium import genuine_continua_rowfn
    from eigensolver_tpu_torch.utils import StageTimer
    import warnings
    warnings.simplefilter("ignore")     # saturated-row notices, as expected
    cases_ = twisted_cases()
    case = cases_["twist_v01_p1"]
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")

    # the twisted path, with every launch counter reset just before
    reset_counters()
    rs, st = sweep.run_case(case, cfg, device="cuda")
    launches = read_counters()
    check_launches("twisted path", launches,
                   {"cylinder_disp": 1, "cylinder_bisect": 1})
    if st.n_candidates != N_TWIST:
        raise AssertionError(f"{st.n_candidates} candidates")
    _check_roots(rs, case)

    walls, stages, counts = [], [], []
    for _ in range(3):
        before = read_counters()
        timer = StageTimer()
        rs, st = sweep.run_case(case, cfg, device="cuda", timer=timer)
        check_launches("timed twisted run", counts_since(before),
                       {"cylinder_disp": 1, "cylinder_bisect": 1})
        walls.append(st.wall_s)
        stages.append(timer.report())
        counts.append(rs.counts())
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"f32 root counts differ between runs: {counts}")
    f32 = dict(counts=counts[0],
               minus_refs=_check_counts("twist_v01_p1 float32", counts[0],
                                        TWIST_COUNTS["float32"]),
               wall_s=walls, median_wall_s=statistics.median(walls),
               candidates_per_s=N_TWIST / statistics.median(walls),
               stages_median_s={k: statistics.median(s[k] for s in stages)
                                for k in stages[0]})

    cfg64 = dataclasses.replace(cfg, scan_dtype="float64",
                                polish_dtype="float64")
    f64 = {}
    for name, refs in (("twist_v01_p1", TWIST_COUNTS["float64"]),
                       ("magnetic_p125", MAGNETIC_COUNTS["float64"])):
        rs64, st64 = sweep.run_case(cases_[name], cfg64, device="cuda")
        _check_roots(rs64, cases_[name])
        f64[name] = dict(counts=rs64.counts(), wall_s=st64.wall_s,
                         minus_refs=_check_counts(f"{name} float64",
                                                  rs64.counts(), refs))

    # f32 refined in f64 on the card: 4 launches (the scan, the bracket
    # stage, the f64 window ends through the small-batch path, the f64
    # bisection); with the counters reset just before the first, then 3
    # timed runs
    walls, stages = [], []
    for run in range(4):
        if run == 0:
            reset_counters()
        before = read_counters()
        timer = StageTimer()
        rsr, str_ = sweep.run_case(case, cfg, device="cuda", refine_f64=True,
                                   timer=timer)
        got = counts_since(before)
        refined_launches = refined_launches if run else got
        check_launches("refined twisted path", got,
                       {"cylinder_disp": 2, "cylinder_disp_small": 1,
                        "cylinder_bisect": 2})
        _check_roots(rsr, case)
        walls.append(str_.wall_s)
        stages.append(timer.report())
    walls, stages = walls[1:], stages[1:]
    refined = dict(counts=rsr.counts(), wall_s=walls,
                   median_wall_s=statistics.median(walls),
                   stages_median_s={k: statistics.median(s[k] for s in stages)
                                    for k in stages[0]},
                   launches=refined_launches,
                   minus_refs=_check_counts("twist_v01_p1 float32 refined",
                                            rsr.counts(),
                                            TWIST_COUNTS["float32_refined"]))

    # a small input against the reference: the reduced magnetic sweep with
    # the row-local continuum mask on the card and on the CPU (the CPU run
    # held equal to the JAX package's by tests/test_torch_twisted_sweep.py)
    mag = cases_["magnetic_p125"]
    small = dataclasses.replace(
        mag, k_values=(0.8, 1.4, 2.0),
        grid=dataclasses.replace(mag.grid, n_interior=128))
    scfg = search.SearchConfig(n_omega=48, n_bisect=20,
                               exclude_omega_rowfn=genuine_continua_rowfn(small))
    rs_gpu, _ = sweep.run_case(small, scfg, device="cuda")
    rs_cpu, _ = sweep.run_case(small, scfg, device="cpu")
    if not rs_gpu.counts() == rs_cpu.counts() == JAX_COUNTS_MASKED_REDUCED:
        raise AssertionError(f"reduced masked sweep: card {rs_gpu.counts()}, "
                             f"cpu {rs_cpu.counts()}, JAX "
                             f"{JAX_COUNTS_MASKED_REDUCED}")
    dev = max(float(np.max(np.abs(rs_gpu[b].omegas / rs_cpu[b].omegas - 1)))
              for b in rs_cpu.branches)
    if not dev <= 1e-10:
        raise AssertionError(f"reduced masked roots card vs cpu: {dev:.3e}")

    out["twisted_sweep"] = dict(main_path_launches=launches, float32=f32,
                                float64=f64, float32_refined=refined,
                                reduced_masked_counts=rs_gpu.counts(),
                                reduced_masked_max_rel_dev=dev)
    line("phase 11 twisted sweeps", **out["twisted_sweep"])
    return launches, refined_launches


def phase_twisted_levels(out: dict):
    """Phase 12's levels: the speculative twisted cylinder_bisect at every
    level count L = 0..5 (L = 0 the loop's schedule; B = 32 / 2^L brackets
    a block, or fewer for two blocks per SM) on twist_v01_p1's 2,400
    brackets (float32 and float64, n_bisect=18 and the residual) and on the
    refine stage's brackets (float64, 30 iterations, no residual), each
    bit-equal to the loop of one-thread launches (search.bisect_loop) and
    timed beside the loop. The bound counts the evaluations the loop needs
    (`evals_needed`), each L the ones it does (`evals`). The refine stage's
    default launch is also held, at REFINE_PLAIN_N_ITER iterations, to the
    plain speculative bisection at its levels over the plain dispersion
    (search.bisect_loop(levels=L), one plain call a round)."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    from eigensolver_tpu_torch.kernels import common, cylinder as kcyl
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    case = twisted_cases()["twist_v01_p1"]
    params = kcyl.disp_params(case)
    _, refine_br = refine_stage(case)
    res = {}
    for what, dtype, br, n_iter, final in (
            ("sweep float32", torch.float32,
             sweep_brackets(case, torch.float32), N_BISECT, True),
            ("sweep float64", torch.float64,
             sweep_brackets(case, torch.float64), N_BISECT, True),
            ("refine float64", torch.float64, refine_br, N_REFINE_ITER,
             False)):
        dname = str(dtype).split(".")[-1]
        n = br[0].numel()
        disp = sweep.make_dispersion_moded(case, dtype)
        loop = search.bisect_loop(disp, *br, n_iter, final)
        eb = kcyl._ENTRY_BYTES[dtype, True]
        default = common.spec_shape(n, dtype, eb)
        z = exterior_args(case, br[0], br[2], dtype)
        need = spec_evals(n_iter, final, 1)
        work = bound(cyl_tw_ops(case, n, need, z),
                     n * 6 * br[0].element_size(), dname)
        r = {"n": n, "n_iter": n_iter, "default": list(default),
             "evals_needed": need,
             "loop_ms": cuda_ms(lambda: search.bisect_loop(
                 disp, *br, n_iter, final), 1)}
        for lv in range(6):
            shape = common.spec_shape(n, dtype, eb, levels=lv)
            got = kcyl.cylinder_bisect(*br, n_iter, params, final,
                                       shape=shape)
            differ = [int((~_same_bits(a.cpu().numpy(), b.cpu().numpy())).sum())
                      for a, b in zip(got, loop) if a is not None]
            if any(differ):
                raise AssertionError(f"twisted cylinder_bisect {what} L={lv}: "
                                     f"{differ} values differ from the loop")
            r[f"L{lv}"] = dict(
                shape=list(shape), evals=spec_evals(n_iter, final, lv),
                ms=cuda_ms(lambda: kcyl.cylinder_bisect(
                    *br, n_iter, params, final, shape=shape), 3),
                **work)
        r["ms"] = cuda_ms(lambda: kcyl.cylinder_bisect(*br, n_iter, params,
                                                       final), 3)
        r["evals"] = spec_evals(n_iter, final, default.levels)
        r.update(work)
        if what == "refine float64":
            # the default launch against the plain speculative bisection,
            # both at a quarter of the depth on the same brackets
            shallow = shallower(case)
            plain = CylinderPhysics.from_case(shallow).make_dispersion_plain(
                m=None, dtype=dtype)
            got = kcyl.cylinder_bisect(*br, REFINE_PLAIN_N_ITER,
                                       kcyl.disp_params(shallow), final,
                                       shape=default)
            t0 = time.perf_counter()
            want = search.bisect_loop(plain, *br, REFINE_PLAIN_N_ITER, final,
                                      levels=default.levels)
            torch.cuda.synchronize()
            r["plain_ms"] = 1e3 * (time.perf_counter() - t0)
            r["plain_n_iter"] = REFINE_PLAIN_N_ITER
            r["plain_n_interior"] = shallow.grid.n_interior
            a, b = got[0].cpu().numpy(), want[0].cpu().numpy()
            r["max_abs_err_vs_plain"] = float(np.nanmax(np.abs(a - b)))
            differ = int((~_same_bits(a, b)).sum())
            if differ:
                raise AssertionError(
                    f"twisted cylinder_bisect {what}: {differ} roots differ "
                    f"from the plain speculative bisection at L = "
                    f"{default.levels}")
        res[what] = r
    out["twisted_levels"] = res
    line("phase 12 twisted cylinder_bisect levels", **res)


def parity_config(name: str, dtype: str, k_stride: int = 1):
    """(case, SearchConfig, refine_f64) of a reference-parity target
    (tools_torch/parity.py) with the port's modules."""
    from eigensolver_tpu_torch import cases, equilibrium, search
    from tools_torch import parity
    return parity.configure(name, cases, search.SearchConfig,
                            equilibrium.genuine_continua, dtype, k_stride)


def with_numeric(case, wavelengths: float, **grid):
    """The case with the numeric exterior of `wavelengths`."""
    return dataclasses.replace(case, grid=dataclasses.replace(
        case.grid, exterior_method="numeric",
        exterior_wavelengths=wavelengths, **grid))


def _physics(case):
    """(kernel, plain) moded dispersions of the case, by dtype."""
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    if case.geometry.value == "slab":
        ph = SlabPhysics.from_case(case)
        return (lambda dt: ph.make_dispersion(parity=None, dtype=dt),
                lambda dt: ph.make_dispersion_plain(parity=None, dtype=dt))
    ph = CylinderPhysics.from_case(case)
    return (lambda dt: ph.make_dispersion(m=None, dtype=dt),
            lambda dt: ph.make_dispersion_plain(m=None, dtype=dt))


def numeric_ops(case, n: int, n_evals: int, k, m, n_chains: int = None,
                every_chain: bool = False, kept=None) -> int:
    """Operations of n_evals evaluations of each of n candidates (k, m: the
    batch's columns) of the case's chain with its numeric exterior (no K_m
    ratio); the slab's chain and exterior once for each of n_chains
    distinct (omega, k) (default n), or with every_chain (the count before
    the paired scan) for each candidate, 3 chains a step; the density/
    axial-flow cylinder's with the steps' `kept` chains (cyl_ops)."""
    import torch
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    g = case.grid
    none = torch.zeros(0)
    if case.geometry.value == "slab":
        chain = slab_ops(n, n_evals, g.n_interior,
                         shear=SlabPhysics.from_case(case).has_flow,
                         n_chains=n_chains, every_chain=every_chain)
        return chain + ext_ops(case, n, n_evals,
                               n_ext=None if every_chain else n_chains)
    if case.twist_profile is not None:
        chain = cyl_tw_ops(case, n, n_evals, none)
    else:
        chain = cyl_ops(n, n_evals, g.n_interior, g.n_axis_log, none,
                        distinct(k, m), kept)
    return chain + ext_ops(case, n, n_evals, distinct(k))


def _timed_plain(plain, args):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = plain(*args)
    torch.cuda.synchronize()
    return res, 1e3 * (time.perf_counter() - t0)


def _numeric_scan(what: str, case, args, plain_too: bool):
    """The scan with the numeric exterior on the candidates args: its time
    and bound; with plain_too the plain version's time and bits on the
    same candidates. Returns (report, the plain version's result or
    None)."""
    kern, plain = _physics(case)
    dtype = args[0].dtype
    dname = str(dtype).split(".")[-1]
    n = args[0].numel()
    disp = kern(dtype)
    r = dict(n=n, ms=cuda_ms(lambda: disp(*args), 3),
             **bound(numeric_ops(case, n, 1, args[1], args[2],
                                 n_chains=distinct(args[0], args[1])),
                     n * (5 * args[0].element_size() + 1), dname))
    pres = None
    if plain_too:
        kres = disp(*args)
        pres, r["plain_ms"] = _timed_plain(plain(dtype), args)
        r["check"] = _compare_disp(what, kres, pres, f64=dname == "float64",
                                   bits=True)
    return r, pres


def shallower(case):
    """The case at 1/NUM_PLAIN_DEPTH of its interior and exterior steps:
    the depth of phase 13's ragged draws and of its bisections against the
    plain loop. The plain versions' time on the card is set by the chain's
    serial steps, not by the batch."""
    g = case.grid
    return dataclasses.replace(case, grid=dataclasses.replace(
        g, n_interior=g.n_interior // NUM_PLAIN_DEPTH,
        n_exterior=g.n_exterior // NUM_PLAIN_DEPTH))


def _fused_bisect(case, br, final_eval=True, shape=None):
    """fused(n_iter): the case's fused bisection of the brackets br at the
    wrapper's shape, or at `shape`."""
    kern = _physics(case)[0]
    disp = kern(br[0].dtype)
    if shape is None:
        return lambda k: disp.bisect(*br, k, final_eval)
    fn, params = bisect_fn(case)
    return lambda k: fn(*br, k, params, final_eval, shape=shape)


def _numeric_bisect(what: str, case, br, n_iter=N_BISECT, final_eval=True,
                    shape=None) -> dict:
    """The fused bisection with the numeric exterior on the brackets br:
    bit-equal to the loop of one-thread launches at n_iter; timed, with
    its bound (the evaluations the loop needs). The density/axial-flow
    cylinder's also with its block shape and its launch's counts
    (kernels.cylinder.bisect_counts: the columns through the row table,
    held to bisect_tabled_columns, and through the tabled exps, the chains
    kept), its bound with the kept chains and without (3 a step,
    bound_every_chain_ms)."""
    import torch
    from eigensolver_tpu_torch import search
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    kern = _physics(case)[0]
    dtype = br[0].dtype
    dname = str(dtype).split(".")[-1]
    n = br[0].numel()
    disp = kern(dtype)
    fused = _fused_bisect(case, br, final_eval, shape)
    tabled = (case.geometry.value == "cylinder"
              and case.twist_profile is None)
    if tabled:
        kcyl.bisect_counts("cuda")
    got = fused(n_iter)
    counts = kcyl.bisect_counts("cuda") if tabled else None
    loop = search.bisect_loop(disp, *br, n_iter, final_eval)
    torch.cuda.synchronize()
    differ = [int((~_same_bits(a.cpu().numpy(), b.cpu().numpy())).sum())
              for a, b in zip(got, loop) if a is not None]
    if any(differ):
        raise AssertionError(f"{what}: {differ} (root, mismatch) values "
                             f"differ from the launch loop")
    evals = int(n_iter > 0) + n_iter + int(final_eval)
    kept = kcyl.chain_kept(case, dtype) if tabled else None
    r = dict(n=n, n_iter=n_iter, ms=cuda_ms(lambda: fused(n_iter), 3),
             loop_ms=cuda_ms(lambda: search.bisect_loop(
                 disp, *br, n_iter, final_eval), 1),
             **bound(numeric_ops(case, n, evals, br[2], br[3], kept=kept),
                     n * 6 * br[0].element_size(), dname))
    if tabled:
        sh = shape or wrapper_shape(case, n, dtype)
        want = kcyl.bisect_tabled_columns(br[2], br[3], sh)
        if counts["rows"] != want or counts["exterior"] != want:
            raise AssertionError(f"{what}: {counts} through the tables, "
                                 f"not {want} columns")
        r.update(shape=list(sh), tabled=counts, bound_every_chain_ms=bound(
            numeric_ops(case, n, evals, br[2], br[3]),
            n * 6 * br[0].element_size(), dname)["bound_ms"])
    return r


def _bisect_vs_plain(what: str, case, br, final_eval=True,
                     shape=None) -> dict:
    """The fused bisection on the brackets br at NUM_PLAIN_N_ITER, bit-equal
    to the loop over the plain dispersion; both timed."""
    from eigensolver_tpu_torch import search
    plain = _physics(case)[1]
    fused = _fused_bisect(case, br, final_eval, shape)
    got = fused(NUM_PLAIN_N_ITER)
    want, plain_ms = _timed_plain(
        lambda *a: search.bisect_loop(plain(br[0].dtype), *a,
                                      NUM_PLAIN_N_ITER, final_eval), br)
    differ = [int((~_same_bits(x.cpu().numpy(), y.cpu().numpy())).sum())
              for x, y in zip(got, want) if x is not None]
    if any(differ):
        raise AssertionError(f"{what}: {differ} values differ from the "
                             f"plain loop")
    a, b = got[0].cpu().numpy(), want[0].cpu().numpy()
    return dict(plain_ms=plain_ms, plain_n_iter=NUM_PLAIN_N_ITER,
                plain_n=br[0].numel(), plain_n_interior=case.grid.n_interior,
                ms_plain_n_iter=cuda_ms(lambda: fused(NUM_PLAIN_N_ITER), 3),
                max_abs_err_vs_plain=float(np.nanmax(np.abs(a - b))))


def entry_bytes(case, dtype) -> int:
    """Bytes per abscissa of the fused bisection's tables of the case's
    chain at dtype, as its kernels lay them out: the slab's x-only entry,
    the twisted cylinder's r-only entry, the density/axial-flow
    cylinder's r-only entry with its rows' (and exps') tables."""
    from eigensolver_tpu_torch.kernels import cylinder as kcyl, slab as kslab
    if case.geometry.value == "slab":
        shear = bool(kslab.disp_params(case).struct.shear)
        return kslab._ENTRY_BYTES[(shear, dtype)]
    st = kcyl.disp_params(case).struct
    return kcyl.bisect_entry_bytes(dtype, bool(st.twisted),
                                   bool(st.exterior_numeric))


def twisted_numeric_case():
    """twist_v01_p1 with the numeric exterior at 3 wavelengths, at a
    reduced depth (n_interior=384): no shipped target pairs the twisted
    chain with the numeric exterior."""
    return with_numeric(twisted_cases()["twist_v01_p1"], 3.0,
                        n_interior=384)


def phase_numeric_kernels(out: dict):
    """Phase 13: the kernels with the numeric exterior (B6) against their
    plain versions, bit for bit, at float32 and float64."""
    import torch
    from eigensolver_tpu_torch import cases, search
    from eigensolver_tpu_torch.kernels import common, cylinder as kcyl
    from tools_torch import batches
    f32, f64 = torch.float32, torch.float64
    slab, slab_cfg, _ = parity_config("slab_ph_09", "float32")
    shear = with_numeric(cases.slab_flow_gaussian_coronal(), 3.0)
    cyl, cyl_cfg, _ = parity_config("cyl_flow_1", "float32")
    res = {}
    # ragged batches of ladder draws, both types, kernel vs plain bits, at
    # the reduced depth (`shallower`)
    for name, case in (("slab_disp flux", slab), ("slab_disp shear", shear),
                       ("cylinder_disp", cyl)):
        case = shallower(case)
        cand = batches.ladder_draws(case, N_RAGGED, seed=13)
        for dtype in (f64, f32):
            dname = str(dtype).split(".")[-1]
            res[f"{name} {N_RAGGED} {dname}"] = dict(
                n_interior=case.grid.n_interior, **_numeric_scan(
                    f"{name} numeric {dname}", case,
                    [x.to(dtype) for x in cand], plain_too=True)[0])
    # the numeric cylinder scan's row layouts, bit for bit, with the
    # candidates each takes through its block's tables
    kern, plain = _physics(cyl)
    for dtype in (f64, f32):
        dname = str(dtype).split(".")[-1]
        res[f"cylinder_disp row layouts {dname}"] = check_row_layouts(
            f"cylinder_disp numeric {dname}", cyl, kern(dtype),
            plain(dtype), dtype)
    # the parity sweeps' whole scans in ladder order, and the plain
    # version on the same candidates; the cylinder's candidates all
    # through the row table and the exps' table
    for name, case, cfg in (("slab_disp", slab, slab_cfg),
                            ("cylinder_disp", cyl, cyl_cfg)):
        for dtype in (f32, f64):
            dname = str(dtype).split(".")[-1]
            args = batches.flat_ladder(case, cfg.n_omega, dtype)
            kcyl.scan_tabled("cuda")
            if name == "slab_disp":
                # the sweep's own scan: both parities of each (omega, k)
                # in one thread
                res[f"{name} full {dname}"] = _paired_scan(
                    f"{name} numeric full {dname}", case, args, 3)
                continue
            r = _numeric_scan(f"{name} numeric full {dname}", case, args,
                              plain_too=True)[0]
            if name == "cylinder_disp":
                # the timed launches and the check's, each all tabled
                rows, ext = kcyl.scan_tabled("cuda")
                if not rows == ext == 5 * N_PAR_CYL:
                    raise AssertionError(
                        f"numeric cylinder_disp full {dname}: {rows} and "
                        f"{ext} of 5 x {N_PAR_CYL} through the tables")
                r["tabled_rows"], r["tabled_exterior"] = rows, ext
            res[f"{name} full {dname}"] = r
    # the fused bisections (the speculative kernel over the scans' tables)
    # on the parity sweeps' own brackets, against the launch loop at
    # N_BISECT, and at the reduced depth (`shallower`, its own brackets)
    # against the plain loop at NUM_PLAIN_N_ITER; on their first 600 (a
    # refine-sized batch) at the speculative default L against the loop
    for name, case, cfg in (("slab_bisect", slab, slab_cfg),
                            ("cylinder_bisect", cyl, cyl_cfg)):
        for dtype in (f32, f64):
            dname = str(dtype).split(".")[-1]
            br = sweep_brackets(case, dtype, cfg)
            res[f"{name} {dname}"] = _numeric_bisect(
                f"{name} numeric {dname}", case, br)
            low = shallower(case)
            res[f"{name} {dname}"].update(_bisect_vs_plain(
                f"{name} numeric {dname} (n_interior "
                f"{low.grid.n_interior})", low, sweep_brackets(low, dtype,
                                                               cfg)))
            shape = wrapper_shape(case, 600, dtype)
            res[f"{name} 600 L{shape.levels} {dname}"] = _numeric_bisect(
                f"{name} numeric 600 L{shape.levels} {dname}", case,
                [x[:600].contiguous() for x in br], shape=shape)
    # the twisted kernels at a reduced size: the small-batch path and the
    # scan on a ragged batch, the speculative bisection at L = 0 and at its
    # default L on 600 brackets of the ladder (n_omega=64)
    tw = twisted_numeric_case()
    params = kcyl.disp_params(tw)
    cand = batches.ladder_draws(tw, N_RAGGED, seed=14)
    cand[2] = torch.ones_like(cand[2])
    for dtype in (f64, f32):
        dname = str(dtype).split(".")[-1]
        args = [x.to(dtype) for x in cand]
        r, pres = _numeric_scan(f"twisted numeric {dname}", tw, args, True)
        scan = kcyl.TW_SCAN_SHAPE[dtype]
        r["scan_check"] = _compare_disp(
            f"twisted numeric scan {dname}",
            kcyl.cylinder_disp(*args, params, shape=scan), pres,
            f64=dtype == f64, bits=True)
        r["scan_ms"] = cuda_ms(lambda: kcyl.cylinder_disp(
            *args, params, shape=scan), 3)
        res[f"cylinder_disp twisted {dname}"] = r
        br = [x[:600].contiguous() for x in sweep_brackets(
            tw, dtype, search.SearchConfig(n_omega=64,
                                           max_brackets_per_row=8))]
        eb = kcyl._ENTRY_BYTES[dtype, True]
        for lv in (0, None):
            shape = common.spec_shape(600, dtype, eb, levels=lv)
            what = f"twisted cylinder_bisect numeric L{shape.levels} {dname}"
            r = _numeric_bisect(what, tw, br, shape=shape)
            if lv is None:
                r.update(_bisect_vs_plain(what, tw, br, shape=shape))
            res[f"cylinder_bisect twisted L{shape.levels} {dname}"] = r
    res["ptxas"] = {**{f"slab_disp {k}": v for k, v in ptxas_report(
        "slab_disp_kernel").items() if "numeric" in k},
                    **{f"cylinder_disp {k}": v for k, v in ptxas_report(
                        "cylinder_disp_kernel", CYL_FORMS).items()
                       if "numeric" in k},
                    **{f"cylinder_bisect {k}": v
                       for k, v in spec_ptxas("cylinder").items()}}
    out["numeric_kernels"] = res
    line("phase 13 numeric exteriors vs plain", **res)


def _timed_runs(case, cfg, refine: bool, want_launches: dict, what: str,
                runs: int = 3):
    """runs timed sweeps (after the caller's first), each with want's
    launches; (walls, stage medians, counts)."""
    from eigensolver_tpu_torch import sweep
    from eigensolver_tpu_torch.utils import StageTimer
    walls, stages, counts = [], [], []
    for _ in range(runs):
        before = read_counters()
        timer = StageTimer()
        rs, st = sweep.run_case(case, cfg, device="cuda", refine_f64=refine,
                                timer=timer)
        check_launches(what, counts_since(before), want_launches)
        walls.append(st.wall_s)
        stages.append(timer.report())
        counts.append(rs.counts())
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"{what}: counts differ between runs: {counts}")
    return walls, {k: statistics.median(s[k] for s in stages)
                   for k in stages[0]}, counts[0]


def phase_parity(out: dict):
    """Phase 14: the reference-parity sweeps (tools_torch/parity.py) on the
    card, each path with the counters reset just before it: slab_ph_09 and
    cyl_flow_1 at float32 refined in float64 (5 launches: scan, bracket
    stage, f64 windows, f64 bisection, the f64 evaluation that re-judges
    acceptance at the refined roots) and at float64 (2), the slab_ph_3
    needle pass (2) and its merge with the float64 main sweep. Walls:
    median of 3 after the counted run; counts per branch held against the
    JAX package's (cyl_flow_1's at full width at float64, and at both
    types on its k subset, every 9th k)."""
    from eigensolver_tpu_torch import roots, sweep
    import warnings
    warnings.simplefilter("ignore")     # saturated-row notices, as expected
    res, paths = {}, {}
    for name, disp, bis in (("slab_ph_09", "slab_disp", "slab_bisect"),
                            ("cyl_flow_1", "cylinder_disp",
                             "cylinder_bisect")):
        for dtype in ("float32", "float64"):
            case, cfg, refine = parity_config(name, dtype)
            # refined: + the f64 windows and their bisection, + the
            # re-judging evaluation at the refined roots
            # (accept_pct_refined, finalize_branches)
            want = {disp: 3 if refine else 1, bis: 2 if refine else 1}
            if name == "slab_ph_09":
                # the scan paired, the windows and the re-judge not
                want["slab_paired"] = N_PAR_SLAB
            reset_counters()
            rs, st = sweep.run_case(case, cfg, device="cuda",
                                    refine_f64=refine)
            launches = read_counters()
            check_launches(f"{name} {dtype} parity path", launches, want)
            _check_roots(rs, case)
            paths[f"{name} {dtype}"] = launches
            walls, stages, counts = _timed_runs(case, cfg, refine, want,
                                                f"{name} {dtype} parity")
            if counts != rs.counts():
                raise AssertionError(f"{name} {dtype}: counts {counts} "
                                     f"against the first run's "
                                     f"{rs.counts()}")
            r = dict(candidates=st.n_candidates, counts=counts,
                     launches=launches, wall_s=walls,
                     median_wall_s=statistics.median(walls),
                     candidates_per_s=st.n_candidates
                     / statistics.median(walls), stages_median_s=stages)
            if f"{name} {dtype}" in PARITY_COUNTS:
                r["minus_refs"] = _check_counts(
                    f"{name} {dtype} parity", counts,
                    PARITY_COUNTS[f"{name} {dtype}"])
            if name == "cyl_flow_1":
                sub, scfg, _ = parity_config(name, dtype, CYL_PAR_K_STRIDE)
                srs, sst = sweep.run_case(sub, scfg, device="cuda",
                                          refine_f64=refine)
                r["k_subset"] = dict(
                    n_k=len(sub.k_grid()), candidates=sst.n_candidates,
                    counts=srs.counts(), minus_refs=_check_counts(
                        f"cyl_flow_1/9 {dtype} parity", srs.counts(),
                        PARITY_COUNTS[f"cyl_flow_1/9 {dtype}"]))
            res[f"{name} {dtype}"] = r
    # the needle target: its float64 main sweep, the needle pass, the merge
    from tools_torch import parity
    case, cfg, _ = parity_config("slab_ph_3", "float64")
    main, _ = sweep.run_case(case, cfg, device="cuda")
    edges = parity.needle_edges("slab_ph_3", case, sweep.needle_edges)
    modes = parity.TARGETS["slab_ph_3"]["needle"]["modes"]
    want = {"slab_disp": 1, "slab_bisect": 1}
    reset_counters()
    ndl, nst = sweep.run_needle_pass(case, edges=edges, modes=modes,
                                     device="cuda")
    launches = read_counters()
    check_launches("needle path", launches, want)
    paths["slab_ph_3 needle"] = launches
    if nst.n_candidates != N_NEEDLE:
        raise AssertionError(f"needle pass: {nst.n_candidates} candidates")
    walls = []
    for _ in range(3):
        before = read_counters()
        again, ast = sweep.run_needle_pass(case, edges=edges, modes=modes,
                                           device="cuda")
        check_launches("timed needle pass", counts_since(before), want)
        if again.counts() != ndl.counts():
            raise AssertionError("needle counts differ between runs")
        walls.append(ast.wall_s)
    merged = roots.merge_rootsets(main, ndl)
    res["slab_ph_3 needle"] = dict(
        candidates=nst.n_candidates, edges=len(edges), launches=launches,
        wall_s=walls, median_wall_s=statistics.median(walls),
        main_counts=main.counts(), needle_counts=ndl.counts(),
        merged_counts=merged.counts(),
        minus_refs={**_check_counts("slab_ph_3 float64", main.counts(),
                                    PARITY_COUNTS["slab_ph_3 float64"]),
                    **{f"needle_{k}": v for k, v in _check_counts(
                        "slab_ph_3 needle", ndl.counts(),
                        PARITY_COUNTS["slab_ph_3 needle"]).items()},
                    **{f"merged_{k}": v for k, v in _check_counts(
                        "slab_ph_3 merged", merged.counts(),
                        PARITY_COUNTS["slab_ph_3 merged"]).items()}})
    out["parity"] = res
    line("phase 14 reference-parity sweeps", **res)
    return paths


def _sign_roots(disp, w, k: float, m: float):
    """Linearly interpolated sign changes of disp along omega = w k at one
    (k, m) (tests/test_special.py:101-132), on the card in float64."""
    import torch
    from eigensolver_tpu_torch import search
    om = torch.from_numpy(w * k)[None, :].cuda()
    kk = torch.tensor([k], dtype=torch.float64, device="cuda")
    md = torch.tensor([m], dtype=torch.float64, device="cuda")
    det, valid, _ = search.ladder_scan(disp, om, kk, md)
    d, v = det[0].cpu().numpy(), valid[0].cpu().numpy()
    s = np.sign(d)
    i = np.nonzero((s[:-1] * s[1:] < 0) & v[:-1] & v[1:])[0]
    return w[i] - d[i] * (w[i + 1] - w[i]) / (d[i + 1] - d[i])


def phase_oracles(out: dict):
    """Phases 15 and 16, at the full grid on the card: the Bessel/numeric
    oracle (cylinder_density_coronal(1e5), k = 1, 801 points on v in
    [2, 4], m = 1: the roots under the K_m ratio and the numeric exterior
    agree to rtol 1e-6) and the needle oracle (tests/test_needle.py:61-87:
    the needle pass at one k finds each reference entry within 3e-3)."""
    import torch
    from eigensolver_tpu_torch import cases, sweep
    case_b = cases.cylinder_density_coronal(width=1e5)
    case_n = with_numeric(case_b, case_b.grid.exterior_wavelengths)
    w = np.linspace(2.0, 4.0, 801)
    rb, rn = (_sign_roots(sweep.make_dispersion_moded(c, torch.float64), w,
                          1.0, 1.0) for c in (case_b, case_n))
    if not len(rb) == len(rn) > 0:
        raise AssertionError(f"Bessel/numeric oracle: {len(rb)} against "
                             f"{len(rn)} roots")
    rel = float(np.max(np.abs(rn / rb - 1)))
    if not rel <= 1e-6:
        raise AssertionError(f"Bessel/numeric oracle: roots differ by {rel}")
    out["bessel_numeric_oracle"] = dict(roots=len(rb), max_rel_diff=rel,
                                        roots_bessel=rb.tolist())
    line("phase 15 Bessel/numeric oracle", **out["bessel_numeric_oracle"])
    res = {}
    for fac, width, k, om_ref in NEEDLE_ORACLE:
        case = with_numeric(getattr(cases, fac)(width=width), 7.0)
        edges = tuple(e for e in sweep.needle_edges(case) if e[0] > 0)
        rs, _ = sweep.run_needle_pass(case, modes=(0,), ks=[k], edges=edges,
                                      device="cuda")
        om = rs["sausage"].omegas
        rel = float(np.min(np.abs(om - om_ref) / om_ref)) if len(om) else 1.0
        if not rel < 3e-3:
            raise AssertionError(f"needle oracle {fac}({width}) k={k}: "
                                 f"nearest {rel:.2e} from {om_ref}")
        res[f"{fac}({width}) k={k}"] = dict(roots=om.tolist(), want=om_ref,
                                            min_rel=rel)
    out["needle_oracle"] = res
    line("phase 16 needle oracle", **res)



def cx_ops(n: int, n_interior: int, dual: bool = False,
           n_iter: int = 1, every_chain: bool = False) -> int:
    """Operations of n_iter complex shoots (the value pass of
    slab_disp_complex, or the dual pass and the step of slab_newton) on
    each of n candidates, and the x-only values once. Where n_interior is
    a power of two a step's first abscissa is the step before's last, bit
    for bit (csrc/common.cuh::chain_reuse), so a shoot needs 2 n_interior
    + 1 chain evaluations, not 3 n_interior; every_chain counts 3 a step
    whatever n_interior is (the count of every abscissa, for comparison)."""
    f = "slab_cx_dual_" if dual else "slab_cx_"
    chains = 3 * n_interior
    if not every_chain and n_interior & (n_interior - 1) == 0:
        chains = 2 * n_interior + 1
    per = (n_interior * (OPS[f + "step"] - 3 * OPS[f + "chain"])
           + chains * OPS[f + "chain"] + OPS[f + "ends"]
           + (OPS["slab_cx_newton"] if dual else 0))
    return n * n_iter * per + n_interior * OPS["slab_shear_x_step"]


def kh_config(name: str):
    from eigensolver_tpu_torch import cases
    from tools_torch import kh
    return kh.configure(name, cases)


def complex_ptxas() -> dict:
    """Registers and spill bytes of the complex-omega slab kernels'
    instantiations (csrc/slab_complex.cu: the shear form's
    newton_kernel<T, kNum>, its producer warps fixed by the type; the flux
    form's flux_kernel<T, kNum>, one thread a seed, at the type's built
    shape), keyed by them."""
    import re
    import torch
    from eigensolver_tpu_torch.kernels import common

    def key_of(name):
        t = re.search(r"7slab_cx(13newton|11flux)_kernelI([fd])Lb([01])EE",
                      name)
        if not t:
            return None
        dt = torch.float32 if t.group(2) == "f" else torch.float64
        ext = "numeric" if t.group(3) == "1" else "exact"
        if t.group(1) == "13newton":
            return (f"newton_kernel {_type_name(t.group(2))} shear {ext} "
                    f"P={common.COMPLEX_PRODUCERS[dt]}")
        sh = common.FLUX_NEWTON_SHAPE[dt]
        return (f"flux_kernel {_type_name(t.group(2))} {ext} "
                f"{sh.threads}:{sh.min_blocks}")
    entries = ptxas_entries(key_of)
    want = 4 * len(common.COMPLEX_PRODUCERS)
    if len(entries) != want:
        raise AssertionError(f"complex kernels' instantiations: "
                             f"{sorted(entries)}, want {want}")
    return entries


def _cx_bits(what: str, got: dict, want: dict) -> float:
    """Hold the named float tensors of got bit-equal to want's (NaN where
    want has NaN); return the largest |got - want| where both are
    finite."""
    import torch
    err = 0.0
    for key in want:
        a, b = got[key], want[key]
        if not torch.equal(a.isnan(), b.isnan()):
            raise AssertionError(f"{what}: NaN masks of {key} differ")
        fin = a.isfinite() & b.isfinite()
        bad = (a != b) & ~a.isnan()
        if bool(bad.any()):
            raise AssertionError(f"{what}: {int(bad.sum())} values of {key} "
                                 f"differ from the plain version")
        if bool(fin.any()):
            err = max(err, float((a[fin] - b[fin]).abs().max()))
    return err


def _newton_chain(step, seeds, n_iter: int):
    """n_iter chained one-step launches from the seeds, each from the one
    before: the last omega and, per step, its device ms (CUDA events
    around the one launch), and of its input omegas the non-finite ones and
    those whose |Im| is below 1e-290 (where Smith's division would leave
    CUDA's fast path but for complex.cuh::fast_div, PERF.md section 6)."""
    import torch
    om, steps = seeds, []
    for _ in range(n_iter):
        fin = om.re.isfinite() & om.im.isfinite()
        tiny = fin & (om.im.abs() < 1e-290)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        nxt = step(om)
        t1.record()
        torch.cuda.synchronize()
        steps.append(dict(ms=t0.elapsed_time(t1),
                          non_finite=int((~fin).sum()),
                          tiny_im=int(tiny.sum())))
        om = nxt
    return om, steps


def phase_complex_kernels(out: dict):
    """Phase 17 (see the module's docstring)."""
    import torch
    from eigensolver_tpu_torch import sweep
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.kernels import common
    from eigensolver_tpu_torch.kernels import slab as kslab
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    from eigensolver_tpu_torch.search import newton_loop
    case, kw = kh_config("kh_w1")
    params = kslab.disp_params(case, True)
    n_int = case.grid.n_interior
    # the checks against the plain versions at a quarter of the depth
    # (`shallower`), the kernel's times at the case's own
    shallow = shallower(case)
    sph = SlabPhysics.from_case(shallow)
    sparams = kslab.disp_params(shallow, True)
    f64 = torch.float64

    def pair(z, dtype=f64):
        return C(torch.from_numpy(z.real.copy()).to("cuda", dtype),
                 torch.from_numpy(z.imag.copy()).to("cuda", dtype))

    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    if len(om0) != KH_N_SEEDS:
        raise AssertionError(f"{len(om0)} seeds, want {KH_N_SEEDS}")
    seeds = pair(om0)
    kk = torch.from_numpy(k0).cuda()
    par = torch.ones_like(kk)
    res = {}
    # slab_newton: n_iter=1 against the plain loop, bit for bit
    dual = sph.make_dispersion_dual_plain(parity=None)
    t0 = time.perf_counter()
    want = newton_loop(dual, seeds, kk, par, KH_PLAIN_N_ITER)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    got = kslab.slab_newton(seeds, kk, par, KH_PLAIN_N_ITER, 1.0, sparams)
    torch.cuda.synchronize()
    err = _cx_bits("slab_newton n_iter=1", {"re": got.re, "im": got.im},
                   {"re": want.re, "im": want.im})
    # the main path's 30 steps: one launch against 30 chained one-step
    # launches, bit for bit; then with the final evaluation in the launch
    n_iter = kw["newton_iters"]
    chained, steps = _newton_chain(
        lambda z: kslab.slab_newton(z, kk, par, 1, 1.0, params), seeds,
        n_iter)
    roots = kslab.slab_newton(seeds, kk, par, n_iter, 1.0, params)
    _cx_bits(f"slab_newton n_iter={n_iter} against {n_iter} chained",
             {"re": roots.re, "im": roots.im},
             {"re": chained.re, "im": chained.im})
    ms = cuda_ms(lambda: kslab.slab_newton(seeds, kk, par, n_iter, 1.0,
                                           params), 3)
    ms_fused = cuda_ms(lambda: kslab.slab_newton(
        seeds, kk, par, n_iter, 1.0, params, final_eval=True), 3)
    roots_f, _ = kslab.slab_newton(seeds, kk, par, n_iter, 1.0, params,
                                   final_eval=True)
    _cx_bits("slab_newton with the final evaluation",
             {"re": roots_f.re, "im": roots_f.im},
             {"re": roots.re, "im": roots.im})
    n = KH_N_SEEDS
    shape = common.complex_spec_shape(f64)

    def newton_bound(every_chain):
        return bound(cx_ops(n, n_int, dual=True, n_iter=n_iter,
                            every_chain=every_chain), 48 * n, "float64")

    def final_eval_bound(every_chain):
        ops = (cx_ops(n, n_int, dual=True, n_iter=n_iter,
                      every_chain=every_chain)
               + cx_ops(n, n_int, every_chain=every_chain)
               - n_int * OPS["slab_shear_x_step"])
        return bound(ops, 48 * n + 8 * 3 * n + n, "float64")["bound_ms"]
    res["slab_newton"] = dict(
        n=n, n_iter=n_iter, shape=list(shape), ms=ms,
        ms_final_eval=ms_fused, final_eval_ms=ms_fused - ms,
        ms_n_iter_1=steps[0]["ms"],
        chained_ms=sum(r["ms"] for r in steps),
        step_ms=[r["ms"] for r in steps],
        step_non_finite=[r["non_finite"] for r in steps],
        step_tiny_im=[r["tiny_im"] for r in steps],
        plain_ms=1e3 * plain_s, plain_n_iter=KH_PLAIN_N_ITER,
        plain_n_interior=shallow.grid.n_interior, max_abs_err=err,
        **newton_bound(False),
        bound_3_chains_ms=newton_bound(True)["bound_ms"],
        bound_n_iter_1_ms=bound(cx_ops(n, n_int, dual=True), 48 * n,
                                "float64")["bound_ms"],
        bound_final_eval_ms=final_eval_bound(False),
        bound_final_eval_3_chains_ms=final_eval_bound(True))
    line("phase 17 slab_newton vs plain", **res["slab_newton"])
    # the evaluation mode: the final evaluation's and the audit's batches
    cells, paths, _, _ = sweep.audit_contours(
        np.asarray(case.k_grid()), np.asarray(case.sorted_speeds()),
        case.imag_band)
    z_a = paths.reshape(-1)
    if len(z_a) != KH_N_AUDIT:
        raise AssertionError(f"{len(z_a)} contour points, want {KH_N_AUDIT}")
    k_a = np.repeat(np.array([c[0] for c in cells]), paths.shape[1])
    # the final batch's check on the roots of the Newton launch at the
    # reduced depth, its times on the main path's roots
    s_roots, s_fused = kslab.slab_newton(seeds, kk, par, n_iter, 1.0,
                                         sparams, final_eval=True)
    batches = {"final float64": (s_roots, kk, roots),
               "audit float64": (pair(z_a), torch.from_numpy(k_a).cuda(),
                                 None),
               "ragged float32": (pair(z_a[:N_RAGGED], torch.float32),
                                  torch.from_numpy(k_a[:N_RAGGED]).to(
                                      "cuda", torch.float32), None)}
    for what, (z_check, kz, z) in batches.items():
        z = z_check if z is None else z
        dt = kz.dtype
        pz = torch.ones_like(kz)
        plain = sph.make_dispersion_plain(parity=None, dtype=dt)
        t0 = time.perf_counter()
        pr = plain(z_check, kz, pz)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        kr = kslab.slab_disp_complex(z_check, kz, pz, sparams)
        torch.cuda.synchronize()
        # the Newton launch's own value round, held at the roots alike
        for name, r in ((what, kr),) + (
                (("in the Newton launch", s_fused),)
                if what.startswith("final") else ()):
            if not torch.equal(r.valid, pr.valid):
                raise AssertionError(f"slab_disp_complex {name}: valid "
                                     f"differs")
            err = _cx_bits(f"slab_disp_complex {name}",
                           {"det_re": r.det.re, "det_im": r.det.im,
                            "mismatch": r.mismatch_pct},
                           {"det_re": pr.det.re, "det_im": pr.det.im,
                            "mismatch": pr.mismatch_pct})
        nz = kz.numel()
        ms = cuda_ms(lambda: kslab.slab_disp_complex(z, kz, pz, params), 10)
        tname = "float64" if dt == f64 else "float32"
        n_bytes = (8 if dt == f64 else 4) * 7 * nz + nz
        res[f"slab_disp_complex {what}"] = dict(
            n=nz, shape=list(common.complex_spec_shape(dt)), ms=ms,
            plain_ms=1e3 * plain_s,
            plain_n_interior=shallow.grid.n_interior, max_abs_err=err,
            finite=float(kr.det.re.isfinite().float().mean()),
            **bound(cx_ops(nz, n_int), n_bytes, tname),
            bound_3_chains_ms=bound(cx_ops(nz, n_int, every_chain=True),
                                    n_bytes, tname)["bound_ms"])
        line(f"phase 17 slab_disp_complex {what} vs plain",
             **res[f"slab_disp_complex {what}"])
    res["ptxas"] = complex_ptxas()
    line("phase 17 complex kernels ptxas", **res["ptxas"])
    out["complex_kernels"] = res


def _check_kh_seeds(name: str, case, kw: dict, rs, target: dict) -> dict:
    """Phase 18's per-seed check: the sweep's Newton pass again on the card
    (the same kernel, the same bits) with its final evaluation, and one Newton
    step further; kh.seed_verdicts of these. The verdicts must accept what the
    sweep accepted; every seed converged here and in the JAX package's run must
    be accepted as there; the converged accepted seeds must give
    target["counts_converged"] roots. Returns the counts and the seeds
    whose acceptance differs from the JAX package's."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.roots import dedup_complex_roots
    from tools_torch import kh
    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    disp = sweep.make_dispersion(case, 1, torch.float64)
    seeds = C(torch.from_numpy(om0.real.copy()).cuda(),
              torch.from_numpy(om0.imag.copy()).cuda())
    kk = torch.from_numpy(k0).cuda()
    om, res = search.newton_complex(disp, seeds, kk,
                                    n_iter=kw["newton_iters"],
                                    final_eval=True)
    nxt = search.newton_complex(disp, om, kk, n_iter=1)

    def host(z):
        return z.re.cpu().numpy() + 1j * z.im.cpu().numpy()
    om = host(om)
    acc, conv = kh.seed_verdicts(case, om, host(nxt),
                                 res.mismatch_pct.cpu().numpy(),
                                 res.valid.cpu().numpy(), k0)
    dedup_rel = case.tol.dedup_rel
    n_all = len(dedup_complex_roots(om[acc], k0[acc], dedup_rel)[0])
    if n_all != rs.counts()["kink"]:
        raise AssertionError(f"{name}: the seed verdicts give {n_all} roots, "
                             f"the sweep {rs.counts()['kink']}")
    j_acc = kh.unpack_mask(target["seeds_accepted"], len(k0))
    j_conv = kh.unpack_mask(target["seeds_converged"], len(k0))
    both = conv & j_conv
    bad = np.flatnonzero(both & (acc != j_acc))
    if len(bad):
        raise AssertionError(f"{name}: seeds {bad.tolist()} converged here "
                             f"and in JAX's run, accepted differently")
    n_conv = kh.converged_count(om, k0, acc, conv, dedup_complex_roots,
                                dedup_rel)
    if n_conv != target["counts_converged"]["kink"]:
        raise AssertionError(f"{name}: the converged accepted seeds give "
                             f"{n_conv} roots, JAX "
                             f"{target['counts_converged']['kink']}")
    return dict(counts_converged=n_conv, accepted=int(acc.sum()),
                converged=int(conv.sum()),
                accepted_unconverged=int((acc & ~conv).sum()),
                converged_both=int(both.sum()),
                flips=np.flatnonzero(acc != j_acc).tolist())


def phase_kh_sweeps(out: dict) -> dict:
    """Phase 18 (see the module's docstring): the launches of each sweep's
    first run."""
    from eigensolver_tpu_torch import sweep
    from tools_torch import kh
    res, launches = {}, {}
    for name in ("kh_w1e5", "kh_w1"):
        case, kw = kh_config(name)
        reset_counters()
        rs, stats = sweep.run_case_complex(case, **kw, device="cuda")
        launches[name] = read_counters()
        check_launches(f"{name} path", launches[name],
                       {"slab_newton": 1, "slab_disp_complex": 1})
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            sweep.run_case_complex(case, **kw, device="cuda")
            walls.append(time.perf_counter() - t0)
        target = kh.TARGETS[name]
        comp = stats.completeness
        if stats.n_candidates != KH_N_SEEDS:
            raise AssertionError(f"{name}: {stats.n_candidates} seeds")
        band = 0.0 if target["counts_exact"] else None
        diff = _check_counts(name, rs.counts(),
                             [("jax", target["counts"], band)])
        seeds = _check_kh_seeds(name, case, kw, rs, target)
        margin = 0.05 * case.imag_band
        off_axis = {b: int(np.sum(np.abs(r.omegas_imag) > margin))
                    for b, r in rs.branches.items()}
        if off_axis != target["counts_off_axis"]:
            raise AssertionError(f"{name}: off-axis counts {off_axis}, JAX "
                                 f"{target['counts_off_axis']}")
        if comp != target["completeness"]:
            raise AssertionError(f"{name}: completeness {comp}, JAX "
                                 f"{target['completeness']}")
        if comp["missed"] or comp["agree"] != comp["checked"]:
            raise AssertionError(f"{name}: audit {comp}")
        br = rs["kink"]
        if not (np.all(np.isfinite(br.omegas))
                and np.all(np.isfinite(br.omegas_imag))):
            raise AssertionError(f"{name}: non-finite roots")
        i = int(np.argmax(br.omegas_imag))
        growth_rel = abs(br.omegas_imag[i] / target["max_growth"] - 1)
        if not (br.ks[i] == target["max_growth_k"]
                and growth_rel <= kh.GROWTH_RTOL):
            raise AssertionError(f"{name}: largest growth rate "
                                 f"{br.omegas_imag[i]} at k {br.ks[i]}, JAX "
                                 f"{target['max_growth']}")
        r = dict(wall_s=statistics.median(walls), walls=walls,
                 first_wall_s=stats.wall_s, counts=rs.counts(),
                 counts_minus_jax=diff, counts_off_axis=off_axis,
                 seeds=seeds,
                 completeness=comp, launches=launches[name],
                 max_growth=float(br.omegas_imag[i]),
                 max_growth_k=float(br.ks[i]),
                 max_growth_rel_diff=float(growth_rel))
        if name == "kh_w1e5":
            W = (br.omegas[i] + 1j * br.omegas_imag[i]) / br.ks[i]
            dW = abs(W - kh.analytic_newton(case.regime, W, br.ks[i]))
            if not dW < KH_ANALYTIC_TOL:
                raise AssertionError(f"{name}: growing root {W} off the "
                                     f"analytic relation by {dW}")
            r["analytic_abs_err"] = float(dW)
        res[name] = r
        line(f"phase 18 {name} sweep", **r)
    out["kh_sweeps"] = res
    return launches


# -- phases 22-23 --------------------------------------------------------------

def cx_slab_config(name: str):
    from eigensolver_tpu_torch import cases
    from tools_torch import cx_slab
    return cx_slab.configure(name, cases)


def cx_variant_ops(case, n: int, dual: bool = False, n_iter: int = 1,
                   every_chain: bool = False) -> int:
    """`cx_ops` for the case's form and exterior: the shear or the flux
    chain ("slab_cx_*", "slab_cx_flux_*"), with the numeric exterior its
    steps, rescalings and ends ("slab_cx_*ext_*") per shoot, the x-only
    values of the form once."""
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    gr = case.grid
    shear = SlabPhysics.from_case(case).has_flow
    f = ("slab_cx_" if shear else "slab_cx_flux_") + ("dual_" if dual
                                                       else "")
    per = (gr.n_interior * (OPS[f + "step"] - 3 * OPS[f + "chain"])
           + slab_chains(gr.n_interior, every_chain) * OPS[f + "chain"]
           + OPS[f + "ends"] + (OPS["slab_cx_newton"] if dual else 0))
    if gr.exterior_method == "numeric":
        e = "slab_cx_dual_" if dual else "slab_cx_"
        per += (gr.n_exterior * OPS[e + "ext_step"]
                + gr.n_exterior // 64 * OPS[e + "ext_renorm"]
                + OPS[e + "ext_ends"])
    x_step = "slab_shear_x_step" if shear else "slab_x_step"
    return n * n_iter * per + gr.n_interior * OPS[x_step]


def cx_flux_kernel_ops(case, n: int, dual: bool = False, n_iter: int = 1,
                       threads: int = None) -> int:
    """The flux form's kernel's own count (csrc/slab_complex.cu::
    flux_kernel, one thread a seed) of n_iter shoots of n seeds: per seed
    and shoot the update of each step ("slab_cx_flux_*update"), the chains
    it forms (3 a step, but the first of each step it keeps:
    `kernels.slab.flux_chain_kept`), the ends and with the numeric exterior
    its steps, rescalings and ends; and the x-only values once per launch,
    or with `threads` once per block and shoot, as its tables refill them.
    Without `threads` it equals cx_variant_ops, the bound's count."""
    from eigensolver_tpu_torch.kernels import slab as kslab
    gr = case.grid
    f = "slab_cx_flux_" + ("dual_" if dual else "")
    chains = 3 * gr.n_interior - int(kslab.flux_chain_kept(
        gr.n_interior).sum())
    per = (gr.n_interior * OPS[f + "update"] + chains * OPS[f + "chain"]
           + OPS[f + "ends"] + (OPS["slab_cx_newton"] if dual else 0))
    if gr.exterior_method == "numeric":
        e = "slab_cx_dual_" if dual else "slab_cx_"
        per += (gr.n_exterior * OPS[e + "ext_step"]
                + gr.n_exterior // 64 * OPS[e + "ext_renorm"]
                + OPS[e + "ext_ends"])
    tables = 1 if threads is None else -(-n // threads) * n_iter
    return n * n_iter * per + tables * gr.n_interior * OPS["slab_x_step"]


def _cx_pairs(om0, k0, dtype=None):
    import torch
    from eigensolver_tpu_torch.cplx import C
    dtype = dtype or torch.float64
    return (C(torch.from_numpy(om0.real.copy()).to("cuda", dtype),
              torch.from_numpy(om0.imag.copy()).to("cuda", dtype)),
            torch.from_numpy(k0).to("cuda", dtype))


def _cx_variant_kernels(name: str, case, kw: dict) -> dict:
    """Phase 22's kernel checks of one configuration: on the sweep's seeds
    (both parities, seed i at parity i mod 2) slab_newton at n_iter=1 with
    its value round, and the evaluation mode at its roots, bit-equal to
    the plain Newton loop and the plain value dispersion, at a quarter of
    the depth (`shallower`, as phase 13's plain checks); the times of the
    main path's launches (30 steps, with and without the value round, and
    the audit's contour points in the evaluation mode) at full depth
    beside their bounds; the form's kernel, its launch shape, registers and
    spills; the flux kernel's kept chains (its counts) and its time on the
    seeds of a checkpointed block (`CX_BLOCK_SEEDS`, one wave); the roots
    and warps of 32 seeds whose |Im omega| is below 1e-290."""
    import torch
    from eigensolver_tpu_torch import sweep
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.kernels import common
    from eigensolver_tpu_torch.kernels import slab as kslab
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    from eigensolver_tpu_torch.search import newton_loop
    shallow = shallower(case)
    ph = SlabPhysics.from_case(shallow)
    params = kslab.disp_params(case, True)
    params_shallow = kslab.disp_params(shallow, True)
    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    seeds, kk = _cx_pairs(om0, k0)
    par = (torch.arange(len(k0), device="cuda") % 2).double()
    dual = ph.make_dispersion_dual_plain(parity=None)
    plain = ph.make_dispersion_plain(parity=None)
    t0 = time.perf_counter()
    want = newton_loop(dual, seeds, kk, par, CX_PLAIN_N_ITER)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    at_roots = plain(want, kk, par)
    torch.cuda.synchronize()
    plain_value_s = time.perf_counter() - t0
    got, res = kslab.slab_newton(seeds, kk, par, CX_PLAIN_N_ITER, 1.0,
                                 params_shallow, final_eval=True)
    ev = kslab.slab_disp_complex(got, kk, par, params_shallow)
    torch.cuda.synchronize()
    err = _cx_bits(f"{name} slab_newton n_iter={CX_PLAIN_N_ITER}",
                   {"re": got.re, "im": got.im},
                   {"re": want.re, "im": want.im})
    for what, r in (("its value round", res), ("the evaluation mode", ev)):
        if not torch.equal(r.valid, at_roots.valid):
            raise AssertionError(f"{name} {what}: valid differs")
        _cx_bits(f"{name} {what}",
                 {"det_re": r.det.re, "det_im": r.det.im,
                  "mismatch": r.mismatch_pct},
                 {"det_re": at_roots.det.re, "det_im": at_roots.det.im,
                  "mismatch": at_roots.mismatch_pct})
    n, n_iter = len(k0), kw["newton_iters"]
    shear = bool(params.struct.shear)
    numeric = bool(params.struct.exterior_numeric)
    if not shear:
        kslab.flux_counts("cuda")
    ms = cuda_ms(lambda: kslab.slab_newton(seeds, kk, par, n_iter, 1.0,
                                           params), 2)
    ms_fe = cuda_ms(lambda: kslab.slab_newton(seeds, kk, par, n_iter, 1.0,
                                              params, final_eval=True), 2)
    roots = kslab.slab_newton(seeds, kk, par, n_iter, 1.0, params)
    fin = roots.re.isfinite() & roots.im.isfinite()
    tiny = fin & (roots.im.abs() < 1e-290)
    if shear:
        kernel = dict(name=f"newton_kernel<double, {str(numeric).lower()}>",
                      shape=list(common.complex_spec_shape(torch.float64)))
    else:
        # thread 0 of block 0's shoots: 3 launches (2 timed and a warm-up)
        # of n_iter rounds, 3 of n_iter and the value round, the roots'
        counts = kslab.flux_counts("cuda")
        kept = kslab.flux_chain_kept(case.grid.n_interior)
        shoots = 3 * n_iter + 3 * (n_iter + 1) + n_iter
        if counts != dict(kept=shoots * int(kept.sum()),
                          steps=shoots * case.grid.n_interior):
            raise AssertionError(f"{name}: flux kernel counts {counts}, "
                                 f"{shoots} shoots")
        blk = slice(0, CX_BLOCK_SEEDS)
        sb, kb, pb = C(seeds.re[blk], seeds.im[blk]), kk[blk], par[blk]
        kernel = dict(
            name=f"flux_kernel<double, {str(numeric).lower()}>",
            shape=list(common.FLUX_NEWTON_SHAPE[torch.float64]),
            attrs=kslab.flux_attrs(torch.float64, numeric),
            # a shoot's, by the kernel's own counts
            kept_steps=counts["kept"] // shoots,
            steps=counts["steps"] // shoots,
            # the kernel's own count (its tables once a block and round)
            # beside the bound's (the x-only values once)
            ops=cx_flux_kernel_ops(
                case, n, True, n_iter,
                common.FLUX_NEWTON_SHAPE[torch.float64].threads),
            bound_ops=cx_variant_ops(case, n, True, n_iter),
            block_n=CX_BLOCK_SEEDS,
            block_ms=cuda_ms(lambda: kslab.slab_newton(
                sb, kb, pb, n_iter, 1.0, params, final_eval=True), 2))
    kernel["ptxas"] = {key: v for key, v in complex_ptxas().items()
                       if key.startswith(kernel["name"].split("<")[0])
                       and "float64" in key
                       and ("numeric" in key) == numeric
                       and ("shear" in key) == shear}
    cells, paths, _, _ = sweep.audit_contours(
        np.asarray(case.k_grid()), np.asarray(case.sorted_speeds()),
        case.imag_band)
    z_a, k_a = _cx_pairs(paths.reshape(-1),
                         np.repeat(np.array([c[0] for c in cells]),
                                   paths.shape[1]))
    p_a = torch.ones_like(k_a)
    ms_audit = cuda_ms(lambda: kslab.slab_disp_complex(z_a, k_a, p_a,
                                                       params), 3)
    n_a = k_a.numel()

    def fe_ops(every):
        return (cx_variant_ops(case, n, True, n_iter, every)
                + cx_variant_ops(case, n, every_chain=every))
    return dict(
        n=n, n_iter=n_iter, shape=kernel["shape"], kernel=kernel, ms=ms,
        ms_final_eval=ms_fe,
        final_eval_ms=ms_fe - ms, plain_ms=1e3 * plain_s,
        plain_n_iter=CX_PLAIN_N_ITER, plain_value_ms=1e3 * plain_value_s,
        plain_n_interior=shallow.grid.n_interior,
        max_abs_err=err,
        roots_non_finite=int((~fin).sum()),
        roots_tiny_im=int(tiny.sum()), warps_tiny_im=_warps(tiny),
        warps=_warps(torch.ones_like(tiny)),
        **bound(cx_variant_ops(case, n, True, n_iter), 48 * n, "float64"),
        bound_3_chains_ms=bound(cx_variant_ops(case, n, True, n_iter, True),
                                48 * n, "float64")["bound_ms"],
        bound_final_eval_ms=bound(fe_ops(False), 73 * n,
                                  "float64")["bound_ms"],
        audit=dict(n=n_a, ms=ms_audit, **bound(
            cx_variant_ops(case, n_a), 7 * 8 * n_a + n_a, "float64")))


def _check_cx_seeds(name: str, case, kw: dict, rs, target: dict,
                    subset=None, sub_rs=None) -> dict:
    """`_check_kh_seeds` per mode of a tools_torch/cx_slab.py target: the
    sweep's Newton pass again with its final evaluation, one step further;
    the verdicts accept what the sweep accepted; the seeds converged here
    and in the JAX package's run accepted alike; the converged accepted
    seeds give the target's counts_converged. With `subset` (the indices
    of a tools_torch/cx_cyl.py target's seeds among the sweep's) the
    verdicts of those seeds, held to `sub_rs`, the sweep of those seeds
    alone."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    from eigensolver_tpu_torch.roots import dedup_complex_roots
    from tools_torch import kh
    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    seeds, kk = _cx_pairs(om0, k0)
    rel = case.tol.dedup_rel
    sel = np.arange(len(k0)) if subset is None else np.asarray(subset)
    k_sel = k0[sel]
    rs = rs if sub_rs is None else sub_rs
    res = {}
    for mode in case.modes:
        b = sweep.MODE_NAMES[mode]
        disp = sweep.make_dispersion(case, mode, torch.float64)
        om, ev = search.newton_complex(disp, seeds, kk,
                                       n_iter=kw["newton_iters"],
                                       final_eval=True)
        nxt = search.newton_complex(disp, om, kk, n_iter=1)

        def host(z):
            return z.re.cpu().numpy() + 1j * z.im.cpu().numpy()
        om = host(om)[sel]
        acc, conv = kh.seed_verdicts(case, om, host(nxt)[sel],
                                     ev.mismatch_pct.cpu().numpy()[sel],
                                     ev.valid.cpu().numpy()[sel], k_sel)
        if len(dedup_complex_roots(om[acc], k_sel[acc], rel)[0]) != \
                rs.counts()[b]:
            raise AssertionError(f"{name} {b}: the seed verdicts give "
                                 f"other roots than the sweep")
        j_acc = kh.unpack_mask(target["seeds_accepted"][b], len(sel))
        j_conv = kh.unpack_mask(target["seeds_converged"][b], len(sel))
        both = conv & j_conv
        bad = np.flatnonzero(both & (acc != j_acc))
        if len(bad):
            raise AssertionError(f"{name} {b}: seeds {bad[:20].tolist()} "
                                 f"converged here and in JAX's run, "
                                 f"accepted differently")
        n_conv = kh.converged_count(om, k_sel, acc, conv,
                                    dedup_complex_roots, rel)
        if n_conv != target["counts_converged"][b]:
            raise AssertionError(f"{name} {b}: the converged accepted seeds "
                                 f"give {n_conv} roots, JAX "
                                 f"{target['counts_converged'][b]}")
        res[b] = dict(counts_converged=n_conv, accepted=int(acc.sum()),
                      converged=int(conv.sum()),
                      converged_both=int(both.sum()),
                      flips=int((acc != j_acc).sum()))
    return res


def phase_complex_slab(out: dict) -> dict:
    """Phase 22 (see the module's docstring): the launches of each sweep's
    counted run."""
    from eigensolver_tpu_torch import sweep
    from tools_torch import cx_slab
    res, launches = {}, {}
    for name in CX_SLAB:
        case, kw = cx_slab_config(name)
        flux = case.flow_profile.kind.value == "uniform" and \
            case.regime.U_i0 == case.regime.U_e == 0.0
        numeric = case.grid.exterior_method == "numeric"
        r = _cx_variant_kernels(name, case, kw)
        line(f"phase 22 {name} kernels vs plain", **r)
        reset_counters()
        rs, stats = sweep.run_case_complex(case, **kw, device="cuda")
        launches[name] = read_counters()
        n_modes = len(case.modes)
        check_launches(f"{name} path", launches[name], {
            "slab_newton": n_modes, "slab_disp_complex": n_modes,
            "slab_complex_flux": 2 * n_modes * flux,
            "slab_complex_numeric": 2 * n_modes * numeric})
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            sweep.run_case_complex(case, **kw, device="cuda")
            walls.append(time.perf_counter() - t0)
        target = cx_slab.TARGETS[name]
        if stats.n_candidates != target["candidates"]:
            raise AssertionError(f"{name}: {stats.n_candidates} seeds")
        seeds = _check_cx_seeds(name, case, kw, rs, target)
        # the total count held exactly where the JAX package's
        # unconverged accepted seeds add no root to its converged ones
        exact = {b: target["counts_converged"][b] == n
                 for b, n in target["counts"].items()}
        for b, n in rs.counts().items():
            if exact[b] and n != target["counts"][b]:
                raise AssertionError(f"{name} {b}: {n} roots, JAX "
                                     f"{target['counts'][b]}")
        margin = 0.05 * case.imag_band
        off_axis = {b: int(np.sum(np.abs(br.omegas_imag) > margin))
                    for b, br in rs.branches.items()}
        comp = stats.completeness
        if off_axis != target["counts_off_axis"]:
            raise AssertionError(f"{name}: off-axis counts {off_axis}, JAX "
                                 f"{target['counts_off_axis']}")
        if comp != target["completeness"] or comp["missed"]:
            raise AssertionError(f"{name}: completeness {comp}, JAX "
                                 f"{target['completeness']}")
        for br in rs.branches.values():
            if not (np.all(np.isfinite(br.omegas))
                    and np.all(np.isfinite(br.omegas_imag))):
                raise AssertionError(f"{name}: non-finite roots")
        r.update(sweep=dict(
            wall_s=statistics.median(walls), walls=walls,
            first_wall_s=stats.wall_s, counts=rs.counts(),
            root_digest=root_digest(rs),
            counts_jax=target["counts"], counts_exact=exact,
            counts_off_axis=off_axis, completeness=comp,
            launches=launches[name], seeds=seeds))
        line(f"phase 22 {name} sweep", **r["sweep"])
        res[name] = r
    out["complex_slab"] = res
    return launches


SHARD_WORKER = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke
from eigensolver_tpu_torch.parallel import (init_distributed, make_mesh,
                                            run_case_sharded,
                                            shutdown_distributed)
assert init_distributed()
out = {}
for name, (case, cfg, refine) in chip_smoke.shard_configs().items():
    t0 = time.perf_counter()
    rs, st = run_case_sharded(case, make_mesh(), cfg, refine_f64=refine)
    out[name] = dict(wall_s=time.perf_counter() - t0,
                     digest=chip_smoke.root_digest(rs), counts=rs.counts())
shutdown_distributed()
print("RESULT " + json.dumps(out), flush=True)
'''


SHARD_RUNS = 5          # phase 23's timed runs of each sweep, in turns


def shard_configs() -> dict:
    """Phase 23's sweeps: (case, SearchConfig, refine_f64) by name."""
    from eigensolver_tpu_torch import cases, search
    f32 = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")
    slab = cases.slab_density_photospheric(0.9)
    return {"slab_ph_09 float32": (slab, f32, False),
            "slab_ph_09 float32 refined": (slab, f32, True),
            "cyl_co_09 float32": (cases.cylinder_density_coronal(0.9), f32,
                                  False),
            "cyl_flow_1 parity float64": parity_config("cyl_flow_1",
                                                        "float64")}


def root_digest(rs) -> str:
    """A hash of a RootSet's roots, branch by branch, bit for bit (at
    complex omega their imaginary parts too)."""
    import hashlib
    h = hashlib.sha256()
    for b in sorted(rs.branches):
        br = rs[b]
        h.update(b.encode())
        h.update(np.ascontiguousarray(br.ks, np.float64).tobytes())
        h.update(np.ascontiguousarray(br.omegas, np.float64).tobytes())
        if getattr(br, "omegas_imag", None) is not None:
            h.update(np.ascontiguousarray(br.omegas_imag,
                                          np.float64).tobytes())
    return h.hexdigest()


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_sharded(out: dict, tmp: Path) -> dict:
    """Phase 23 (see the module's docstring): the launches of each sharded
    sweep's counted run."""
    import os
    import torch
    import warnings
    from eigensolver_tpu_torch import cases, roots, search, sweep
    from eigensolver_tpu_torch.parallel import make_mesh, run_case_sharded
    warnings.simplefilter("ignore")     # saturated-row notices, as expected
    n_cards = torch.cuda.device_count()
    mesh = (make_mesh() if n_cards > 1
            else [torch.device("cuda", 0)] * 2)
    res, launches, digests = {}, {}, {}
    for name, (case, cfg, refine) in shard_configs().items():
        want, wst = sweep.run_case(case, cfg, refine_f64=refine,
                                   device="cuda")
        digests[name] = root_digest(want)
        reset_counters()
        got, st = run_case_sharded(case, mesh, cfg, refine_f64=refine)
        launches[name] = read_counters()
        scan = "slab" if case.geometry.value == "slab" else "cylinder"
        n_blocks = len(mesh)
        want_launches = {f"{scan}_disp": n_blocks + refine,
                         f"{scan}_bisect": n_blocks + refine}
        if scan == "slab":
            # every block's rows through the paired scan, its padding too
            rows = st.n_candidates // (2 * cfg.n_omega)
            want_launches["slab_paired"] = (-(-rows // n_blocks) * n_blocks
                                            * 2 * cfg.n_omega)
        check_launches(f"sharded {name}", launches[name], want_launches)
        if root_digest(got) != digests[name] or \
                st.n_candidates != wst.n_candidates:
            raise AssertionError(f"sharded {name}: roots differ from "
                                 f"run_case's")
        walls, one = [], []
        for _ in range(SHARD_RUNS):
            t0 = time.perf_counter()
            run_case_sharded(case, mesh, cfg, refine_f64=refine)
            walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            sweep.run_case(case, cfg, refine_f64=refine, device="cuda")
            one.append(time.perf_counter() - t0)
        wall, wall_one = statistics.median(walls), statistics.median(one)
        res[name] = dict(blocks=n_blocks, counts=got.counts(),
                         launches=launches[name], wall_s=wall,
                         run_case_wall_s=wall_one,
                         overhead=wall / wall_one - 1, walls=walls,
                         run_case_walls=one, bit_equal=True)
        line(f"phase 23 sharded {name}", **res[name])
    # two processes on the card(s), joined by init_distributed (gloo)
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, EIGENSOLVER_COORDINATOR=f"127.0.0.1:{port}",
                   EIGENSOLVER_NUM_PROCESSES="2",
                   EIGENSOLVER_PROCESS_ID=str(rank))
        if n_cards > 1:
            env["CUDA_VISIBLE_DEVICES"] = str(rank % n_cards)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SHARD_WORKER, str(ROOT)], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    ranks = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=400)
            if p.returncode:
                raise AssertionError(f"sharded rank: exit {p.returncode}\n"
                                     f"{se[-3000:]}")
            got = [ln for ln in so.splitlines() if ln.startswith("RESULT ")]
            ranks.append(json.loads(got[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    wall = time.perf_counter() - t0
    for name, d in digests.items():
        if not ranks[0][name]["digest"] == ranks[1][name]["digest"] == d:
            raise AssertionError(f"two processes {name}: roots differ from "
                                 f"run_case's")
    res["two processes"] = dict(
        process_wall_s=wall, walls={name: [r[name]["wall_s"] for r in ranks]
                                    for name in digests})
    line("phase 23 sharded two processes", **res["two processes"])
    # the CLI
    pickle = tmp / "sharded.pickle"
    stdout, cli_wall = _cli(tmp, "sweep", "slab_density_photospheric",
                            "--width", "0.9", "--sharded", "-o", pickle)
    report = json.loads(stdout.splitlines()[0])
    cfg = search.SearchConfig(n_omega=256, scan_dtype="float32",
                              polish_dtype="float32")
    want, _ = sweep.run_case(cases.slab_density_photospheric(0.9), cfg,
                             device="cuda")
    _same_roots("sweep --sharded", roots.load_pickle(str(pickle)), want,
                0.0)
    n_blocks = len(make_mesh())
    check_launches("sweep --sharded", {k: v for k, v in report[
        "launches"].items() if k != "slab_paired"},
        {"slab_disp": n_blocks, "slab_bisect": n_blocks})
    res["cli"] = dict(process_wall_s=cli_wall, sweep_wall_s=report["wall_s"],
                      launches=report["launches"], counts=report["counts"])
    line("phase 23 sweep --sharded", **res["cli"])
    out["sharded"] = res
    return launches



def phase_twisted_numeric_path() -> dict:
    """The twisted chain's numeric-exterior variant on a path of its own
    (no shipped target pairs the two): a reduced float32 sweep of
    twisted_numeric_case() (k in {0.8, 1.4, 2.0}, n_omega=64, n_bisect=18)
    with the counters reset just before it; its launches, one scan (the
    small-batch path at this size) and one fused bisection."""
    from eigensolver_tpu_torch import search, sweep
    case = dataclasses.replace(twisted_numeric_case(),
                               k_values=(0.8, 1.4, 2.0))
    cfg = search.SearchConfig(n_omega=64, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")
    reset_counters()
    rs, _ = sweep.run_case(case, cfg, device="cuda")
    launches = read_counters()
    check_launches("twisted numeric path", launches,
                   {"cylinder_disp": 1, "cylinder_disp_small": 1,
                    "cylinder_bisect": 1})
    _check_roots(rs, case)
    line("phase 13 twisted numeric path", counts=rs.counts(),
         launches=launches)
    return launches


def float64_of(r: dict) -> dict:
    """A fused bisection's float64 numbers for the kernels line."""
    return {"float64_shape": r["shape"], "float64_ms": r["ms"],
            "float64_loop_ms": r["loop_ms"],
            "float64_bound_ms": r["bound_ms"],
            "float64_plain_ms": r["plain_ms"],
            "float64_max_abs_err": r["max_abs_err_vs_plain"]}


def numeric_kernel_entries(res: dict, par: dict, tw: dict) -> list:
    """The kernels JSON entries of the numeric-exterior variants (phase
    13's times and checks at float32, the launches of their paths in
    phases 13-14; the bisections' sources are slab_disp.cu and
    cylinder_disp.cu over bisect.cuh::spec_kernel)."""
    def entry(name, source, replaces, launches, r, check, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "n": r["n"],
                "max_abs_err": check, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None, **extra}

    slab_path = par["slab_ph_09 float32"]
    cyl_path = par["cyl_flow_1 float32"]
    sd, cd = res["slab_disp full float32"], res["cylinder_disp full float32"]
    sb, cb = res["slab_bisect float32"], res["cylinder_bisect float32"]
    td = res["cylinder_disp twisted float32"]
    tb = [v for k, v in res.items()
          if k.startswith("cylinder_bisect twisted")
          and k.endswith("float32") and "plain_ms" in v][0]
    src = "eigensolver_tpu_torch/csrc/"
    return [
        # the slab's numeric exterior (ode.py::rk4_final_renorm, called at
        # physics/slab.py:362) in slab_disp, on slab_ph_09's parity scan;
        # launches on its f32 refined path (scan + refine windows)
        # the scan paired (ms, paired_ms; the unpaired scan on the same
        # ladder beside it), the bound before the paired scan beside its
        # own; the ragged draws through the unpaired scan
        entry("slab_disp_numeric", src + "slab_disp.cu",
              "eigensolver_tpu/ode.py:75", slab_path["slab_disp"], sd,
              sd["check"]["max_abs_err_det"], paired_ms=sd["ms"],
              unpaired_ms=sd["unpaired_ms"],
              bound_3_chains_ms=sd["bound_3_chains_ms"],
              paired_candidates=slab_path["slab_paired"],
              float64_ms=res["slab_disp full float64"]["ms"],
              float64_unpaired_ms=res["slab_disp full float64"]["unpaired_ms"],
              float64_bound_ms=res["slab_disp full float64"]["bound_ms"],
              float64_bound_3_chains_ms=res["slab_disp full float64"][
                  "bound_3_chains_ms"],
              ragged_ms={d: res[f"slab_disp flux {N_RAGGED} {d}"]["ms"]
                         for d in ("float32", "float64")},
              ragged_n_interior=res[f"slab_disp flux {N_RAGGED} float32"][
                  "n_interior"],
              needle_path_launches=par["slab_ph_3 needle"]["slab_disp"]),
        entry("slab_bisect_numeric", src + "slab_disp.cu",
              "eigensolver_tpu/ode.py:75", slab_path["slab_bisect"], sb,
              sb["max_abs_err_vs_plain"], plain_n_iter=sb["plain_n_iter"],
              plain_n_interior=sb["plain_n_interior"],
              ms_plain_n_iter=sb["ms_plain_n_iter"],
              launch_loop_ms=sb["loop_ms"],
              float64_ms=res["slab_bisect float64"]["ms"],
              needle_path_launches=par["slab_ph_3 needle"]["slab_bisect"]),
        # the cylinder's (ode.py::rk4_final, called at physics/cylinder.py:
        # 319) in cylinder_disp, on cyl_flow_1's parity scan
        entry("cylinder_disp_numeric", src + "cylinder_disp.cu",
              "eigensolver_tpu/ode.py:22", cyl_path["cylinder_disp"], cd,
              cd["check"]["max_abs_err_det"],
              float64_ms=res["cylinder_disp full float64"]["ms"],
              float64_bound_ms=res["cylinder_disp full float64"]["bound_ms"],
              tabled_rows=cd["tabled_rows"],
              tabled_exterior=cd["tabled_exterior"]),
        # the block's (k, m, r) row table and its k's exps in the
        # producers, the exterior on a producer row group's lanes: its
        # shape, tabled counts, bound with the kept chains (3 chains a step
        # beside it) and registers and spills
        entry("cylinder_bisect_numeric", src + "cylinder_disp.cu",
              "eigensolver_tpu/ode.py:22", cyl_path["cylinder_bisect"], cb,
              cb["max_abs_err_vs_plain"], plain_n_iter=cb["plain_n_iter"],
              plain_n_interior=cb["plain_n_interior"],
              ms_plain_n_iter=cb["ms_plain_n_iter"],
              launch_loop_ms=cb["loop_ms"], shape=cb["shape"],
              tabled=cb["tabled"],
              bound_every_chain_ms=cb["bound_every_chain_ms"],
              float64_ms=res["cylinder_bisect float64"]["ms"],
              float64_launch_loop_ms=res["cylinder_bisect float64"][
                  "loop_ms"],
              float64_bound_ms=res["cylinder_bisect float64"]["bound_ms"],
              ptxas={k: v for k, v in res["ptxas"].items()
                     if k.startswith("cylinder_bisect")}),
        # the twisted chain's, reduced (n_interior=384, 8,191 candidates,
        # 600 brackets): launches on its own reduced path
        entry("cylinder_disp_twisted_numeric", src + "cylinder_twisted.cu",
              "eigensolver_tpu/ode.py:22", tw["cylinder_disp"], td,
              td["check"]["max_abs_err_det"], scan_ms=td["scan_ms"]),
        entry("cylinder_bisect_twisted_numeric", src + "cylinder_twisted.cu",
              "eigensolver_tpu/ode.py:22", tw["cylinder_bisect"], tb,
              tb["max_abs_err_vs_plain"], plain_n_iter=tb["plain_n_iter"],
              launch_loop_ms=tb["loop_ms"]),
    ]


def complex_kernel_entries(res: dict, launches: dict) -> list:
    """The kernels JSON entries of the complex-omega kernel's two wrappers
    (phase 17's times and checks, the launches of the published KH sweep
    in phase 18; the width-1.0 sweep's beside them)."""
    src = "eigensolver_tpu_torch/csrc/slab_complex.cu"
    nw, w1 = res["slab_newton"], launches["kh_w1"]
    au = res["slab_disp_complex audit float64"]
    keys = ("n", "ms", "plain_ms", "plain_n_interior", "bound_ms",
            "bound_3_chains_ms", "max_abs_err")
    return [{
        # the XLA-fused lax.scan of physics/slab.py at complex omega (no
        # Pallas original), the kernel's evaluation mode: the audit's 30,720
        # contour points, float64
        "name": "slab_disp_complex", "route": "cuda", "source": src,
        "replaces": "eigensolver_tpu/physics/slab.py:309",
        "launches": launches["kh_w1e5"]["slab_disp_complex"],
        "launches_kh_w1": w1["slab_disp_complex"],
        "n": au["n"], "shape": au["shape"], "max_abs_err": au["max_abs_err"],
        "ms": au["ms"], "plain_ms": au["plain_ms"],
        "plain_n_interior": au["plain_n_interior"], "bound_ms": au["bound_ms"],
        "bound_by": au["bound_by"], "library_ms": None,
        # the bound counting all 3 chains a step (cx_ops every_chain)
        "bound_3_chains_ms": au["bound_3_chains_ms"],
        # the 7,200 roots in the evaluation mode; the main path evaluates
        # them in the Newton launch's value round (final_eval_ms there)
        "roots_float64": {k: res["slab_disp_complex final float64"][k]
                          for k in keys},
        "ragged_float32": {k: res["slab_disp_complex ragged float32"][k]
                           for k in keys},
    }, {
        # the fori_loop of search.newton_complex with its holomorphic
        # jax.jvp: 7,200 seeds x 30 steps; the plain loop at n_iter=1
        "name": "slab_newton", "route": "cuda", "source": src,
        "replaces": "eigensolver_tpu/search.py:581",
        "launches": launches["kh_w1e5"]["slab_newton"],
        "launches_kh_w1": w1["slab_newton"],
        "n": nw["n"], "n_iter": nw["n_iter"], "shape": nw["shape"],
        "max_abs_err": nw["max_abs_err"], "ms": nw["ms"],
        "plain_ms": nw["plain_ms"], "plain_n_iter": nw["plain_n_iter"],
        "plain_n_interior": nw["plain_n_interior"],
        "ms_n_iter_1": nw["ms_n_iter_1"], "chained_ms": nw["chained_ms"],
        "bound_ms": nw["bound_ms"], "bound_by": nw["bound_by"],
        "library_ms": None,
        "bound_3_chains_ms": nw["bound_3_chains_ms"],
        # the main path's launch: the 30 steps and the roots' evaluation
        "ms_final_eval": nw["ms_final_eval"],
        "final_eval_ms": nw["final_eval_ms"],
        "bound_final_eval_ms": nw["bound_final_eval_ms"],
        "bound_final_eval_3_chains_ms": nw["bound_final_eval_3_chains_ms"],
    }]


def complex_variant_entries(res: dict, launches: dict) -> list:
    """The kernels JSON entries of the complex-omega slab kernels' flux
    form (B2-complex: csrc/slab_complex.cu::flux_kernel, one thread a seed,
    on the density slab's sweep, cx_ph_09, 37,800 seeds a mode) and numeric
    exterior (B6-complex: the shear form's newton_kernel<T, true>, whose
    consumer lane integrates it, on the KH slab's sweep, kh_w1e5_num, 7,200
    seeds; the density slab's flux_kernel<T, true> beside), phase 22's
    times and checks: the Newton launch of 30 steps, float64, the plain
    loop at n_iter=1 at a quarter of the depth (plain_n_interior)."""
    src = "eigensolver_tpu_torch/csrc/slab_complex.cu"
    keys = ("n", "kernel", "ms", "ms_final_eval", "plain_ms", "bound_ms",
            "bound_3_chains_ms", "max_abs_err", "roots_tiny_im",
            "warps_tiny_im")

    def entry(name, replaces, main, key, others):
        r = res[main]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": launches[main][key],
                "kernel": r["kernel"],
                "n": r["n"], "n_iter": r["n_iter"], "shape": r["shape"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "plain_n_iter": r["plain_n_iter"],
                "plain_n_interior": r["plain_n_interior"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None,
                "bound_3_chains_ms": r["bound_3_chains_ms"],
                "ms_final_eval": r["ms_final_eval"],
                "bound_final_eval_ms": r["bound_final_eval_ms"],
                "roots_tiny_im": r["roots_tiny_im"],
                "warps_tiny_im": r["warps_tiny_im"], "warps": r["warps"],
                "audit": r["audit"],
                **{o: {**{k: res[o][k] for k in keys},
                       "launches": launches[o][key]} for o in others}}
    return [
        # _rk4_linear_flux with make_flux_coef at complex omega (the XLA
        # program of physics/slab.py, no Pallas original): flux_kernel
        entry("slab_complex_flux", "eigensolver_tpu/physics/slab.py:41",
              "cx_ph_09", "slab_complex_flux", ("cx_ph_09_num",)),
        # ode.rk4_final_renorm on complex states at physics/slab.py:360:
        # newton_kernel's consumer lane (the shear form), flux_kernel's
        # own thread (the flux form)
        entry("slab_complex_numeric", "eigensolver_tpu/ode.py:75",
              "kh_w1e5_num", "slab_complex_numeric", ("cx_ph_09_num",)),
    ]


# -- phases 24-25: complex omega on the cylinder ------------------------------

def cx_cyl_variant(name: str, **grid):
    """A variant of phase 24: its case made complex, on `grid` (default the
    reduced CX_CYL_GRID)."""
    from eigensolver_tpu_torch import cases
    fac, kw, exterior = CX_CYL_VARIANTS[name]
    c = getattr(cases, fac)(**kw)
    return dataclasses.replace(c, complex_omega=True, grid=dataclasses.replace(
        c.grid, exterior_method=exterior, **(grid or CX_CYL_GRID)))


def cx_cyl_config(name: str):
    from eigensolver_tpu_torch import cases
    from tools_torch import cx_cyl
    return cx_cyl.configure(name, cases)


def cx_cyl_kve_ops(z, dual: bool = False) -> int:
    """Operations of the K_m ratio at complex z (a `cplx.C` on the card),
    each argument at the branch it takes (|z| < 2: the series)."""
    from eigensolver_tpu_torch.cplx import cabs
    f = "cyl_cx_dual_" if dual else "cyl_cx_"
    n = z.re.numel()
    small = int((cabs(z) < 2).sum())
    return (small * OPS[f + "kve_series"]
            + (n - small) * OPS[f + "kve_cf2"] + n * OPS[f + "kve_ends"])


def cx_cyl_ops(case, n: int, dual: bool = False, n_iter: int = 1) -> int:
    """Operations of n_iter complex cylinder shoots on each of n seeds (the
    value pass, or the dual pass and the Newton step): the interior, the
    log tail and the exterior of the case's chain, the K_m ratio at its
    cheaper branch (a lower bound; `cx_cyl_kve_ops` counts the branches
    where the arguments are known)."""
    from eigensolver_tpu_torch.physics.cylinder import is_twisted, log_tail
    gr = case.grid
    d = "dual_" if dual else ""
    f = "cyl_cx_" + d
    if is_twisted(case):
        per = gr.n_interior * OPS["cyl_tw_cx_" + d + "step"]
        ends = OPS["cyl_tw_cx_" + d + "ends"]
    else:
        per = (gr.n_interior * OPS[f + "step"]
               + log_tail(case) * gr.n_axis_log * OPS[f + "log_step"])
        ends = OPS[f + "ends"]
    if gr.exterior_method == "numeric":
        # the numeric exterior's ends in place of the exact one's
        ends += (OPS[f + "num_ends"] - OPS[f + "ends"]
                 + gr.n_exterior * OPS[f + "ext_step"])
    else:
        ends += OPS[f + "kve_ends"] + min(OPS[f + "kve_series"],
                                          OPS[f + "kve_cf2"])
    return n * n_iter * (per + ends + (OPS["slab_cx_newton"] if dual else 0))


def block_rows(k, m, threads: int) -> int:
    """The (k, m) rows of a batch's blocks of `threads` seeds, summed over
    the blocks: the row-table entries a launch needs per abscissa."""
    import torch
    b = torch.arange(k.numel(), device=k.device) // threads
    return int(torch.unique(torch.stack([b.to(k.dtype), k, m], dim=1),
                            dim=0).shape[0])


def cx_cyl_ops_tabled(case, n: int, dtype, rows: int, dual: bool = False,
                      n_iter: int = 1) -> int:
    """cx_cyl_ops as the kernel's tables need it: per seed and step the
    update and the chains that the step forms (3, less the one kept where
    kernels.cylinder.chain_kept says), each less its (k, m, r) values, which
    a launch needs once for each of its `rows` block rows (`block_rows`)
    and abscissae (the kernel forms them again each round)."""
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    from eigensolver_tpu_torch.physics.cylinder import is_twisted
    gr = case.grid
    d = "dual_" if dual else ""
    f = "cyl_tw_cx_" if is_twisted(case) else "cyl_cx_"
    chain, row = OPS[f + d + "chain"], OPS[f + "row"]
    interior, tail = kcyl.chain_kept(case, dtype)
    segs = [(interior, OPS[f + d + "step"], chain)]
    if tail.numel():
        log_step = OPS[f + d + "log_step"]
        segs.append((tail, log_step,
                     chain + (log_step - OPS[f + d + "step"]) // 3))
    per, abscissae = 0, 0
    for kept, step, ch in segs:
        steps = kept.numel()
        per += (steps * (step - 3 * ch)
                + (3 * steps - int(kept.sum())) * (ch - row))
        abscissae += 3 * steps
    untabled = cx_cyl_ops(case, n, dual, n_iter)
    ends = untabled // (n * n_iter) - (
        gr.n_interior * OPS[f + d + "step"]
        + (tail.numel() * OPS[f + d + "log_step"] if tail.numel() else 0))
    return n * n_iter * (per + ends) + rows * abscissae * row


def cx_cyl_ptxas() -> dict:
    """Registers and spill bytes of the cylinder's complex-omega kernel
    (csrc/cylinder_complex.cu::newton_kernel<T, kTw, kNum>) and of its K_m
    ratio alone, keyed by type, chain and exterior."""
    import re

    def key_of(name):
        t = re.search(r"6cyl_cx13newton_kernelI([fd])Lb([01])ELb([01])EE",
                      name)
        if t:
            return (f"newton_kernel {_type_name(t.group(1))} "
                    f"{'twisted' if t.group(2) == '1' else 'plain'} "
                    f"{'numeric' if t.group(3) == '1' else 'exact'}")
        t = re.search(r"6cyl_cx10kve_kernelI([fd])E", name)
        return f"kve_kernel {_type_name(t.group(1))}" if t else None
    entries = ptxas_entries(key_of)
    if len(entries) != 10:
        raise AssertionError(f"complex cylinder kernels' instantiations: "
                             f"{sorted(entries)}")
    return entries


def _cx_cyl_draws(case, n: int, seed: int, dtype):
    """n seeds as the sweep spreads them (phase speeds over the case's
    speed edges, Im omega over +-imag_band, k over its range, m 0 or 1)."""
    import torch
    from eigensolver_tpu_torch.cplx import C
    rng = np.random.default_rng(seed)
    v = np.asarray(case.sorted_speeds())
    k = rng.uniform(case.k_min, case.k_max, n)
    re = rng.uniform(v[0], v[-1], n) * k
    im = rng.uniform(-case.imag_band, case.imag_band, n)
    m = rng.integers(0, 2, n).astype(np.float64)

    def t(a):
        return torch.from_numpy(a).to("cuda", dtype)
    return C(t(re), t(im)), t(k), t(m)


def _cx_cyl_same(what: str, res, want) -> float:
    """Hold a CylinderInterface at complex omega bit-equal to want's."""
    import torch
    if not torch.equal(res.valid, want.valid):
        raise AssertionError(f"{what}: valid differs")
    return _cx_bits(what, {"det_re": res.det.re, "det_im": res.det.im,
                           "mismatch": res.mismatch_pct},
                    {"det_re": want.det.re, "det_im": want.det.im,
                     "mismatch": want.mismatch_pct})


def _cx_cyl_rows(res, rows):
    """The CylinderInterface of res's candidates `rows` (a slice)."""
    from eigensolver_tpu_torch.cplx import C
    return type(res)(C(res.det.re[rows], res.det.im[rows]),
                     res.mismatch_pct[rows], res.valid[rows])


def _cx_cyl_cells(case, dtype, n_k: int = 3, per_k: int = 200):
    """Seeds laid out as sweep.complex_seeds lays out the sweep's, on the
    case's first n_k k with at least per_k seeds a k (n_re = 6 across a
    band), at the case's last mode: every block of the kernel's launch
    shape spans one k row or two, and a row crosses a block boundary."""
    import torch
    from eigensolver_tpu_torch import sweep
    from eigensolver_tpu_torch.cplx import C
    sub = dataclasses.replace(case, k_values=tuple(
        float(k) for k in case.k_grid()[:n_k]))
    n_im = -(-per_k // (6 * (len(sub.sorted_speeds()) - 1)))
    om, k = sweep.complex_seeds(sub, 6, n_im)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dtype)
    k = t(k)
    return C(t(om.real), t(om.imag)), k, torch.full_like(
        k, float(case.modes[-1]))


def phase_complex_cylinder_kernels(out: dict) -> None:
    """Phase 24 (see the module's docstring)."""
    import torch
    from eigensolver_tpu_torch import special, sweep
    from eigensolver_tpu_torch.cplx import C, cabs, csqrt, where
    from eigensolver_tpu_torch.kernels import bessel
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    from eigensolver_tpu_torch.physics.cylinder import (CylinderPhysics,
                                                        is_twisted)
    from eigensolver_tpu_torch.search import newton_loop
    res = {}
    # the launch shapes, and the kept steps of the sweeps' grids
    shapes = {}
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).split(".")[1]
        for tw in (False, True):
            for num in (False, True):
                a = kcyl.newton_attrs(dtype, tw, num)
                if a["threads"] != kcyl.NEWTON_SHAPE[dtype, tw].threads:
                    raise AssertionError(f"cylinder_newton: built for "
                                         f"{a['threads']} threads, "
                                         f"NEWTON_SHAPE says otherwise")
                shapes[f"{dt} {'twisted' if tw else 'plain'}"
                       f"{' numeric' if num else ''}"] = a
        for name in CX_CYL:
            case, _ = cx_cyl_config(name)
            kept = [s for s in kcyl.chain_kept(case, dtype) if s.numel()]
            shapes[f"{name} {dt} kept"] = [
                float(s.sum()) / max(1, s.numel() - 1) for s in kept]
    line("phase 24 launch shapes", **shapes)
    res["shapes"] = shapes
    for name in CX_CYL_VARIANTS:
        case = cx_cyl_variant(name)
        params = kcyl.disp_params(case)
        ph = CylinderPhysics.from_case(case)
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).split(".")[1]
            om, k, m = _cx_cyl_draws(case, CX_CYL_N_CHECK, 5, dtype)
            omc, kc, mc = _cx_cyl_cells(case, dtype)
            dual = ph.make_dispersion_dual_plain(m=None, dtype=dtype)
            plain = ph.make_dispersion_plain(m=None, dtype=dtype)
            om13, k13, m13 = _cx_cyl_draws(case, 13, 7, dtype)
            # the plain Newton loop of both draws, then one plain
            # evaluation of its roots and of 13 more draws (the plain
            # version's time is set by the chain's serial steps, not by the
            # batch)
            t0 = time.perf_counter()
            want = newton_loop(dual, C(torch.cat([om.re, omc.re]),
                                       torch.cat([om.im, omc.im])),
                               torch.cat([k, kc]), torch.cat([m, mc]),
                               CX_CYL_PLAIN_N_ITER)
            both = plain(C(torch.cat([want.re, om13.re]),
                           torch.cat([want.im, om13.im])),
                         torch.cat([k, kc, k13]), torch.cat([m, mc, m13]))
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            n, nc = CX_CYL_N_CHECK, kc.numel()
            at_roots = _cx_cyl_rows(both, slice(0, n))
            at_cells = _cx_cyl_rows(both, slice(n, n + nc))
            plain13 = _cx_cyl_rows(both, slice(n + nc, None))
            before = read_counters()
            kcyl.newton_counts("cuda")
            got, r = kcyl.cylinder_newton(om, k, m, CX_CYL_PLAIN_N_ITER, 1.0,
                                          params, final_eval=True)
            ev = kcyl.cylinder_disp_complex(got, k, m, params)
            ev13 = kcyl.cylinder_disp_complex(om13, k13, m13, params)
            random_counts = kcyl.newton_counts("cuda")
            gotc, rc = kcyl.cylinder_newton(omc, kc, mc, CX_CYL_PLAIN_N_ITER,
                                            1.0, params, final_eval=True)
            evc = kcyl.cylinder_disp_complex(gotc, kc, mc, params)
            cell_counts = kcyl.newton_counts("cuda")
            torch.cuda.synchronize()
            err = _cx_bits(f"phase 24 {name} {dt} cylinder_newton",
                           {"re": got.re, "im": got.im},
                           {"re": want.re[:n], "im": want.im[:n]})
            err = max(err, _cx_bits(
                f"phase 24 {name} {dt} cylinder_newton laid out",
                {"re": gotc.re, "im": gotc.im},
                {"re": want.re[n:], "im": want.im[n:]}))
            for what, got_i, want_i in (
                    ("value round", r, at_roots),
                    ("evaluation", ev, at_roots),
                    ("ragged evaluation", ev13, plain13),
                    ("value round laid out", rc, at_cells),
                    ("evaluation laid out", evc, at_cells)):
                err = max(err, _cx_cyl_same(f"phase 24 {name} {dt} {what}",
                                            got_i, want_i))
            twisted = is_twisted(case)
            numeric = name.endswith("numeric")
            check_launches(f"phase 24 {name} {dt}", counts_since(before), {
                "cylinder_newton": 2, "cylinder_disp_complex": 3,
                "cylinder_complex_twisted": 5 * twisted,
                "cylinder_complex_numeric": 5 * numeric})
            # every laid-out seed read its block's row table (and, with the
            # numeric exterior, its exps) in both launches
            interior, tail = kcyl.chain_kept(case, dtype, "cuda")
            kept = int(interior.sum() + tail.sum())
            steps = interior.numel() + tail.numel()
            if (cell_counts["rows"] != 2 * nc
                    or cell_counts["exterior"] != 2 * nc * numeric
                    or cell_counts["kept"] != 2 * kept
                    or cell_counts["steps"] != 2 * steps
                    or random_counts["kept"] != 3 * kept):
                raise AssertionError(f"phase 24 {name} {dt}: tables "
                                     f"{cell_counts}, {random_counts}")
            ms = cuda_ms(lambda: kcyl.cylinder_newton(
                om, k, m, CX_CYL_PLAIN_N_ITER, 1.0, params,
                final_eval=True), 3)
            ops = (cx_cyl_ops(case, n, True, CX_CYL_PLAIN_N_ITER)
                   + cx_cyl_ops(case, n))
            r = dict(n=n, n_laid_out=nc, n_iter=CX_CYL_PLAIN_N_ITER,
                     grid=CX_CYL_GRID, max_abs_err=err, ms=ms,
                     plain_ms=1e3 * plain_s,
                     finite=float(torch.isfinite(got.re).float().mean()),
                     tabled_random=random_counts["rows"],
                     tabled_laid_out=cell_counts["rows"],
                     kept_steps=kept, steps=steps,
                     **bound(ops, 73 * n, dt))
            line(f"phase 24 {name} {dt} kernel vs plain", **r)
            res[f"{name} {dt}"] = r
    # B1 at complex z alone, on the exterior arguments sqrt(m_e) of the
    # cx_cyl_co_09 sweep's seeds (both modes)
    case, kw = cx_cyl_config("cx_cyl_co_09")
    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).split(".")[1]
        seeds, kk = _cx_pairs(np.tile(om0, 2), np.tile(k0, 2), dtype)
        mm = torch.cat([torch.zeros(len(k0)), torch.ones(len(k0))]).to(
            "cuda", dtype)
        m_e, _, _ = CylinderPhysics.from_case(case).complex_m_e(seeds, kk)
        z = csqrt(m_e)
        ok = z.re.isfinite() & z.im.isfinite() & (z.re > 0)
        z = C(z.re[ok].contiguous(), z.im[ok].contiguous())
        mm = mm[ok].contiguous()
        bessel.complex_launches = 0

        def plain_kve():
            r0, r1 = special.kve_ratio_both_c(z)
            return where(mm < 0.5, r0, r1)
        t0 = time.perf_counter()
        want = plain_kve()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        got = bessel.kve_ratio_complex(z, mm)
        torch.cuda.synchronize()
        if bessel.complex_launches != 1:
            raise AssertionError("kve_ratio_complex: launches")
        err = _cx_bits(f"phase 24 kve_ratio_complex {dt}",
                       {"re": got.re, "im": got.im},
                       {"re": want.re, "im": want.im})
        n = z.re.numel()
        r = dict(n=n, max_abs_err=err,
                 ms=cuda_ms(lambda: bessel.kve_ratio_complex(z, mm), 5),
                 plain_ms=1e3 * plain_s,
                 series=int((cabs(z) < 2).sum()),
                 **bound(cx_cyl_kve_ops(z), 5 * n * (4 if dt == "float32"
                                                     else 8), dt))
        line(f"phase 24 kve_ratio_complex {dt}", **r)
        res[f"kve {dt}"] = r
    res["ptxas"] = cx_cyl_ptxas()
    line("phase 24 ptxas", **res["ptxas"])
    out["complex_cylinder_kernels"] = res


def _event_ms(fn):
    """fn()'s result and its device ms (CUDA events around the one call)."""
    import torch
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _warps(mask) -> int:
    """The warps of 32 consecutive seeds that hold a seed of `mask`."""
    import torch
    pad = (-mask.numel()) % 32
    return int(torch.cat([mask, mask.new_zeros(pad)]).view(-1, 32)
               .any(dim=1).sum())


def _cx_cyl_main_launches(case, kw: dict, modes=None) -> dict:
    """The main path's launches of a complex cylinder sweep timed on the
    card: the Newton launch of the sweep's seeds (30 steps, with the value
    round after a warm-up, then without) per mode (of `modes`, default the
    case's), and the audit's contour points in the evaluation mode, each
    beside its bound for the kernel's tables (`cx_cyl_ops_tabled`) and as
    counted before them (`*_untabled_ms`); the roots on the divisions' slow
    path (|Im omega| < 1e-290) and their warps."""
    import torch
    from eigensolver_tpu_torch import sweep
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    from eigensolver_tpu_torch.physics.cylinder import is_twisted
    params = kcyl.disp_params(case)
    threads = kcyl.NEWTON_SHAPE[torch.float64, is_twisted(case)].threads
    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    seeds, kk = _cx_pairs(om0, k0)
    n, n_iter = len(k0), kw["newton_iters"]
    r = dict(n=n, n_iter=n_iter)
    for mode in modes or case.modes:
        mm = torch.full_like(kk, float(mode))
        ms_fe = cuda_ms(lambda: kcyl.cylinder_newton(
            seeds, kk, mm, n_iter, 1.0, params, final_eval=True), 1)
        roots, ms = _event_ms(lambda: kcyl.cylinder_newton(
            seeds, kk, mm, n_iter, 1.0, params))
        fin = roots.re.isfinite() & roots.im.isfinite()
        tiny = fin & (roots.im.abs() < 1e-290)
        rows = block_rows(kk, mm, threads)
        newton = cx_cyl_ops_tabled(case, n, torch.float64, rows, True,
                                   n_iter)
        value = cx_cyl_ops_tabled(case, n, torch.float64, rows)
        r[f"m{mode}"] = dict(
            ms=ms, ms_final_eval=ms_fe, final_eval_ms=ms_fe - ms,
            roots_non_finite=int((~fin).sum()),
            roots_tiny_im=int(tiny.sum()), warps_tiny_im=_warps(tiny),
            warps=_warps(fin | ~fin), block_rows=rows,
            **bound(newton, 48 * n, "float64"),
            bound_final_eval_ms=bound(newton + value, 73 * n,
                                      "float64")["bound_ms"],
            bound_untabled_ms=bound(cx_cyl_ops(case, n, True, n_iter),
                                    48 * n, "float64")["bound_ms"],
            bound_final_eval_untabled_ms=bound(
                cx_cyl_ops(case, n, True, n_iter) + cx_cyl_ops(case, n),
                73 * n, "float64")["bound_ms"])
    cells, paths, _, _ = sweep.audit_contours(
        np.asarray(case.k_grid()), np.asarray(case.sorted_speeds()),
        case.imag_band)
    z_a, k_a = _cx_pairs(paths.reshape(-1),
                         np.repeat(np.array([c[0] for c in cells]),
                                   paths.shape[1]))
    m_a = torch.full_like(k_a, float(case.modes[-1]))
    n_a = k_a.numel()
    r["audit"] = dict(n=n_a, ms=cuda_ms(
        lambda: kcyl.cylinder_disp_complex(z_a, k_a, m_a, params), 2),
        **bound(cx_cyl_ops_tabled(case, n_a, torch.float64,
                                  block_rows(k_a, m_a, threads)),
                73 * n_a, "float64"),
        bound_untabled_ms=bound(cx_cyl_ops(case, n_a), 73 * n_a,
                                "float64")["bound_ms"])
    return r


def phase_complex_cylinder(out: dict) -> dict:
    """Phase 25 (see the module's docstring): the launches of each sweep's
    counted run."""
    from eigensolver_tpu_torch import sweep
    from tools_torch import cx_cyl
    res, launches = {}, {}
    for name in CX_CYL:
        case, kw = cx_cyl_config(name)
        r = _cx_cyl_main_launches(case, kw)
        line(f"phase 25 {name} launches", **r)
        twisted = case.twist_profile is not None
        n_modes = len(case.modes)
        reset_counters()
        rs, stats = sweep.run_case_complex(case, **kw, device="cuda")
        launches[name] = read_counters()
        check_launches(f"{name} path", launches[name], {
            "cylinder_newton": n_modes, "cylinder_disp_complex": n_modes,
            "cylinder_complex_twisted": 2 * n_modes * twisted})
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            sweep.run_case_complex(case, **kw, device="cuda")
            walls.append(time.perf_counter() - t0)
        for br in rs.branches.values():
            if not (np.all(np.isfinite(br.omegas))
                    and np.all(np.isfinite(br.omegas_imag))):
                raise AssertionError(f"{name}: non-finite roots")
        comp = stats.completeness
        if comp["missed"] or comp["agree"] != comp["checked"]:
            raise AssertionError(f"{name}: completeness {comp}")
        # the JAX package's targets, on every k_stride-th k: the same
        # sweep on those k, and the full sweep's seeds of those k per seed
        target = cx_cyl.TARGETS[name]
        stride = target["k_stride"]
        sub_case = cx_cyl.strided(case, stride)
        sub_rs, sub_stats = sweep.run_case_complex(sub_case, **kw,
                                                   device="cuda")
        if sub_stats.n_candidates != target["candidates"]:
            raise AssertionError(f"{name}: {sub_stats.n_candidates} seeds")
        seeds = _check_cx_seeds(name, case, kw, rs, target,
                                subset=cx_cyl.subset_seeds(
                                    case, stride, kw["n_re"], kw["n_im"]),
                                sub_rs=sub_rs)
        exact = {b: target["counts_converged"][b] == n
                 for b, n in target["counts"].items()}
        for b, n in sub_rs.counts().items():
            if exact[b] and n != target["counts"][b]:
                raise AssertionError(f"{name} {b}: {n} roots on every "
                                     f"{stride}th k, JAX "
                                     f"{target['counts'][b]}")
        margin = 0.05 * case.imag_band
        off_axis = {b: int(np.sum(np.abs(br.omegas_imag) > margin))
                    for b, br in sub_rs.branches.items()}
        if off_axis != target["counts_off_axis"]:
            raise AssertionError(f"{name}: off-axis counts {off_axis}, JAX "
                                 f"{target['counts_off_axis']}")
        if sub_stats.completeness != target["completeness"]:
            raise AssertionError(f"{name}: completeness "
                                 f"{sub_stats.completeness}, JAX "
                                 f"{target['completeness']}")
        r.update(sweep=dict(
            wall_s=statistics.median(walls), walls=walls,
            first_wall_s=stats.wall_s, counts=rs.counts(),
            root_digest=root_digest(rs),
            completeness=comp, launches=launches[name],
            k_stride=stride, counts_strided=sub_rs.counts(),
            counts_jax=target["counts"], counts_exact=exact,
            counts_off_axis=off_axis, seeds=seeds))
        line(f"phase 25 {name} sweep", **r["sweep"])
        res[name] = r
    # the numeric exterior (B6-complex) on the density cylinder: the
    # Newton launch at cx_cyl_co_09's size, and a sweep of its own on
    # every 30th k (its launches)
    case, kw = cx_cyl_config("cx_cyl_co_09")
    num = dataclasses.replace(case, grid=dataclasses.replace(
        case.grid, exterior_method="numeric"))
    r = _cx_cyl_main_launches(num, kw, modes=(1,))
    reset_counters()
    sub = cx_cyl.strided(num, 30)
    rs, stats = sweep.run_case_complex(sub, **kw, device="cuda")
    launches["numeric"] = read_counters()
    check_launches("cx_cyl_co_09 numeric path", launches["numeric"], {
        "cylinder_newton": 2, "cylinder_disp_complex": 2,
        "cylinder_complex_numeric": 4})
    r.update(sweep=dict(wall_s=stats.wall_s, counts=rs.counts(),
                        completeness=stats.completeness, k_stride=30,
                        launches=launches["numeric"]))
    line("phase 25 cx_cyl_co_09 numeric", **r)
    res["numeric"] = r
    out["complex_cylinder"] = res
    return launches


def complex_cylinder_entries(res: dict, kres: dict, launches: dict) -> list:
    """The kernels JSON entries of the cylinder's complex-omega kernel
    (phases 24-25): the Newton launch of the density cylinder (B7 with
    B4-complex and B1 at complex z; cx_cyl_co_09, 129,600 seeds a mode, 30
    steps, float64), of the twisted one (B4-twisted at complex omega;
    cx_twist_v01_p1, 36,000), with the numeric exterior (B6-complex; the
    density cylinder's seeds), and the K_m ratio at complex z alone (B1);
    each plain_ms is the plain version's time on phase 24's reduced check
    (its n, depth and steps beside)."""
    src = "eigensolver_tpu_torch/csrc/cylinder_complex.cu"

    def entry(name, replaces, main, mode, variant, key, other=None):
        r = res[main][f"m{mode}"]
        p = kres[f"{variant} float64"]
        e = {"name": name, "route": "cuda", "source": src,
             "replaces": replaces, "launches": launches[key[0]][key[1]],
             "n": res[main]["n"], "n_iter": res[main]["n_iter"],
             "max_abs_err": p["max_abs_err"], "ms": r["ms"],
             "plain_ms": p["plain_ms"],
             "plain_check": {k: p[k] for k in ("n", "n_iter", "grid", "ms",
                                               "bound_ms")},
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": None, "ms_final_eval": r["ms_final_eval"],
             "bound_final_eval_ms": r["bound_final_eval_ms"],
             "bound_untabled_ms": r["bound_untabled_ms"],
             "roots_tiny_im": r["roots_tiny_im"],
             "warps_tiny_im": r["warps_tiny_im"],
             "float32_check": {k: kres[f"{variant} float32"][k]
                               for k in ("max_abs_err", "ms", "plain_ms")},
             "audit": res[main]["audit"]}
        if other:
            e.update(other)
        return e
    kve = kres["kve float64"]
    return [
        # the XLA-fused disp of physics/cylinder.py at complex omega under
        # search.newton_complex's jax.jvp (no Pallas original)
        entry("cylinder_newton", "eigensolver_tpu/search.py:581",
              "cx_cyl_co_09", 1, "density", ("cx_cyl_co_09",
                                             "cylinder_newton"),
              {"m0": res["cx_cyl_co_09"]["m0"],
               "disp_complex_launches": launches["cx_cyl_co_09"][
                   "cylinder_disp_complex"]}),
        # the twisted chain at complex omega (coefficients with twisted_c1,
        # jax.jvp of r C1/C3)
        entry("cylinder_newton_twisted",
              "eigensolver_tpu/physics/cylinder.py:138", "cx_twist_v01_p1",
              1, "twist", ("cx_twist_v01_p1", "cylinder_complex_twisted")),
        # ode.rk4_final on complex states at physics/cylinder.py:319
        entry("cylinder_newton_numeric", "eigensolver_tpu/ode.py:22",
              "numeric", 1, "density_numeric",
              ("numeric", "cylinder_complex_numeric")),
        {
            # special.kve_ratio_both at complex z: inlined in the Newton
            # kernel's exact exterior (its launches those of the density
            # and twisted sweeps), timed alone on the cx_cyl_co_09 seeds'
            # sqrt(m_e)
            "name": "kve_ratio_complex", "route": "cuda",
            "source": "eigensolver_tpu_torch/csrc/kve_complex.cuh",
            "replaces": "eigensolver_tpu/special.py:109",
            "inlined_in": "cylinder_newton",
            "launches": sum(launches[nm]["cylinder_newton"]
                            + launches[nm]["cylinder_disp_complex"]
                            for nm in CX_CYL),
            "n": kve["n"], "series": kve["series"],
            "max_abs_err": kve["max_abs_err"], "ms": kve["ms"],
            "plain_ms": kve["plain_ms"], "bound_ms": kve["bound_ms"],
            "bound_by": kve["bound_by"],
            # torch.special has no K_m at complex z
            "library_ms": None,
            "float32": {k: kres["kve float32"][k]
                        for k in ("ms", "plain_ms", "bound_ms")}},
    ]


CK_BLOCK = 8                        # k a block of the checkpointed sweeps
EF_K = 1.5                          # the eigenfunctions' roots: nearest k


def _same_roots(what: str, got, want, rtol: float,
                imag: bool = False) -> bool:
    """Hold got's roots to want's, branch by branch in (k, omega) order:
    equal counts and ks, omegas within rtol (Im omega also within atol
    1e-15); return whether every value is bit-equal."""
    if got.counts() != want.counts():
        raise AssertionError(f"{what}: counts {got.counts()}, want "
                             f"{want.counts()}")
    bits = True
    for b in want.branches:
        g, w = got[b], want[b]
        og, ow = np.lexsort((g.omegas, g.ks)), np.lexsort((w.omegas, w.ks))
        pairs = [(g.ks[og], w.ks[ow], 0.0, 0.0),
                 (g.omegas[og], w.omegas[ow], rtol, 0.0)]
        if imag:
            pairs.append((g.omegas_imag[og], w.omegas_imag[ow], rtol, 1e-15))
        for a, e, rt, at in pairs:
            a, e = np.asarray(a, np.float64), np.asarray(e, np.float64)
            if not np.allclose(a, e, rtol=rt, atol=at):
                raise AssertionError(f"{what} {b}: largest difference "
                                     f"{np.max(np.abs(a - e))}")
            bits &= bool(np.array_equal(a, e))
    return bits


def _timed(fn):
    t0 = time.perf_counter()
    r = fn()
    return r, time.perf_counter() - t0


def phase_checkpointed(out: dict, tmp: Path) -> dict:
    """Phase 19: the crash-safe sweeps on the card, each on a fresh store
    in tmp: (a) slab_ph_09 at float32 and float64 (35 k, 5 blocks: 5
    slab_disp, every candidate through the paired scan, and 5
    slab_bisect), its roots against run_case's under the same config and
    its counts against the JAX package's; (b) the same call again: no
    launch, no candidate, the same roots; (c) the first 16 k alone (2
    blocks), then the whole grid on that store (3 blocks); (d) cyl_co_09
    float32 (90 k, 12 blocks); (e) kh_w1e5 through
    run_case_complex_checkpointed (20 k, 3 blocks: 3 slab_newton, no
    audit). Returns the root sets the later phases use and the launches
    of each path."""
    import torch
    from eigensolver_tpu_torch import cases, search, sweep
    from eigensolver_tpu_torch.native.store import ResultStore
    import warnings
    warnings.simplefilter("ignore")     # saturated-row notices, as expected
    res, launches, sets = {}, {}, {}

    def checkpointed(key, case, cfg, path, want):
        reset_counters()
        (rs, st), wall = _timed(lambda: sweep.run_case_checkpointed(
            case, cfg, checkpoint_path=str(path), k_block=CK_BLOCK,
            device="cuda"))
        launches[key] = read_counters()
        check_launches(key, launches[key], want)
        return rs, st, wall

    slab = cases.slab_density_photospheric(0.9)
    n_slab = -(-slab.n_k // CK_BLOCK)
    per_block = CK_BLOCK * (len(slab.speeds) - 1) * 256 * 2   # both parities
    want_slab = {"slab_disp": n_slab, "slab_bisect": n_slab,
                 "slab_paired": n_slab * per_block}
    for dt in ("float32", "float64"):
        cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype=dt,
                                  polish_dtype=dt)
        ref, _ = sweep.run_case(slab, cfg, device="cuda")
        path = tmp / f"slab_{dt}.eigr"
        key = f"slab_ph_09 {dt}"
        rs, st, wall = checkpointed(key, slab, cfg, path, want_slab)
        with ResultStore(str(path)) as s:
            backend = s.backend
        r = dict(wall_s=wall, blocks=n_slab, counts=rs.counts(),
                 candidates=st.n_candidates, launches=launches[key],
                 store_backend=backend,
                 bit_equal_run_case=_same_roots(key, rs, ref, 1e-12),
                 minus_refs=_check_counts(key, rs.counts(),
                                          SLAB_COUNTS[dt]))
        # (b) the finished store again: nothing to run
        (rs2, st2, wall2) = checkpointed(f"{key} resume", slab, cfg, path, {})
        if st2.n_candidates or st2.n_roots:
            raise AssertionError(f"{key} resume: {st2.n_candidates} "
                                 f"candidates, {st2.n_roots} roots")
        _same_roots(f"{key} resume", rs2, rs, 0.0)
        r["resume_wall_s"] = wall2
        if dt == "float32":
            # (c) stopped after 16 k, resumed on the same store
            path = tmp / "slab_killed.eigr"
            first = dataclasses.replace(
                slab, k_values=tuple(np.asarray(slab.k_grid())[:16]))
            _, _, wall_a = checkpointed(
                "slab_ph_09 first 16 k", first, cfg, path,
                {"slab_disp": 2, "slab_bisect": 2,
                 "slab_paired": 2 * per_block})
            rs3, _, wall_b = checkpointed(
                "slab_ph_09 resumed", slab, cfg, path,
                {"slab_disp": n_slab - 2, "slab_bisect": n_slab - 2,
                 "slab_paired": (n_slab - 2) * per_block})
            r["killed_resumed"] = dict(
                walls_s=[wall_a, wall_b],
                bit_equal=_same_roots("slab_ph_09 resumed", rs3, rs, 1e-12))
            sets["slab_ph_09"] = rs
        res[key] = r
        if dt == "float64":
            sets["slab_ph_09 float64"] = rs

    cyl = cases.cylinder_density_coronal(0.9)
    n_cyl = -(-cyl.n_k // CK_BLOCK)
    cfg = search.SearchConfig(n_omega=256, n_bisect=18, scan_dtype="float32",
                              polish_dtype="float32")
    ref, _ = sweep.run_case(cyl, cfg, device="cuda")
    rs, st, wall = checkpointed("cyl_co_09 float32", cyl, cfg,
                                tmp / "cyl.eigr",
                                {"cylinder_disp": n_cyl,
                                 "cylinder_bisect": n_cyl})
    res["cyl_co_09 float32"] = dict(
        wall_s=wall, blocks=n_cyl, counts=rs.counts(),
        launches=launches["cyl_co_09 float32"],
        bit_equal_run_case=_same_roots("cyl_co_09", rs, ref, 1e-12),
        minus_refs=_check_counts("cyl_co_09", rs.counts(),
                                 CYL_COUNTS["float32"]))
    sets["cyl_co_09"] = rs

    case, kw = kh_config("kh_w1e5")
    ref, _ = sweep.run_case_complex(case, **kw, check_completeness=False,
                                    device="cuda")
    n_kh = -(-case.n_k // CK_BLOCK)
    reset_counters()
    (rs, st), wall = _timed(lambda: sweep.run_case_complex_checkpointed(
        case, checkpoint_path=str(tmp / "kh.eigr"), k_block=CK_BLOCK, **kw,
        dtype=torch.float64, device="cuda"))
    launches["kh_w1e5"] = read_counters()
    check_launches("kh_w1e5 checkpointed", launches["kh_w1e5"],
                   {"slab_newton": n_kh})
    if rs.counts() != {"kink": 49}:
        raise AssertionError(f"kh_w1e5 checkpointed: {rs.counts()}")
    res["kh_w1e5 float64"] = dict(
        wall_s=wall, blocks=n_kh, counts=rs.counts(),
        candidates=st.n_candidates, launches=launches["kh_w1e5"],
        bit_equal_run_case=_same_roots("kh_w1e5", rs, ref, 1e-12, imag=True))
    sets["kh_w1e5"] = ref
    out["checkpointed"] = res
    for key, r in res.items():
        line(f"phase 19 checkpointed {key}", **r)
    return sets, launches


def _cli(tmp: Path, *args) -> tuple:
    """`python -m eigensolver_tpu_torch *args` from the checkout's root,
    on the default device; (its stdout, its wall). A non-zero exit
    raises."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "eigensolver_tpu_torch",
                        *map(str, args)], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode:
        raise AssertionError(f"cli {args[0]}: exit {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    return r.stdout, wall


def _saved(stdout: str) -> Path:
    """The file a subcommand's last line reports as saved (it must exist
    and hold bytes)."""
    last = stdout.strip().splitlines()[-1]
    for word in last.split():
        p = Path(word)
        if p.is_absolute() and p.is_file() and p.stat().st_size > 0:
            return p
    raise AssertionError(f"cli: no saved file in {last!r}")


def phase_cli(out: dict, tmp: Path, sets: dict) -> dict:
    """Phase 20: the CLI, each command a `python -m eigensolver_tpu_torch`
    process on the default device (cuda): the slab_ph_09 sweep (the CLI's
    SearchConfig(n_omega=256), float32) against an in-process run_case at
    the same config, the same with --checkpoint, the KH sweep with
    --complex --checkpoint (its store's growth rates against
    run_case_complex's; its pickle the kink-only 2-array layout, which has
    none), then analyze (its counts) and eigenfunction (its root) on the
    slab pickle, with --plot (and --analytic) where matplotlib imports,
    vtk on the slab pickle and on phase 19's cyl_co_09 roots, and movie
    --frames 4 on those where matplotlib imports (a slab root has no
    azimuthal component to animate). Each sweep's JSON carries its
    kernel launches and the kernel library's load time; the library is
    loaded, not built again (its file unchanged)."""
    import pickle
    from eigensolver_tpu_torch import cases, roots, search, sweep
    from eigensolver_tpu_torch.kernels import _build
    from eigensolver_tpu_torch.native.store import read_all
    so = _build.library_path()
    stamp = so.stat().st_mtime_ns
    res, walls = {}, {}
    slab_args = ("slab_density_photospheric", "--width", "0.9")
    case_args = ("--case", "slab_density_photospheric", "--width", "0.9")

    def sweep_json(key, *args):
        stdout, walls[key] = _cli(tmp, "sweep", *args)
        return json.loads(stdout.splitlines()[0])

    slab = cases.slab_density_photospheric(0.9)
    cfg = search.SearchConfig(n_omega=256, scan_dtype="float32",
                              polish_dtype="float32")
    ref, _ = sweep.run_case(slab, cfg, device="cuda")
    n_slab = -(-slab.n_k // CK_BLOCK)
    per_block = CK_BLOCK * (len(slab.speeds) - 1) * 256 * 2   # both parities
    for key, extra, want in (
            ("sweep", (), {"slab_disp": 1, "slab_bisect": 1,
                           "slab_paired": N_SLAB}),
            ("sweep --checkpoint", ("--checkpoint", tmp / "cli.eigr"),
             {"slab_disp": n_slab, "slab_bisect": n_slab,
              "slab_paired": n_slab * per_block})):
        pkl = tmp / f"s{len(extra)}.pickle"
        rep = sweep_json(key, *slab_args, *extra, "-o", pkl)
        if rep["counts"] != ref.counts() or rep["launches"] != want:
            raise AssertionError(f"cli {key}: {rep}, run_case "
                                 f"{ref.counts()}, launches want {want}")
        got = roots.load_pickle(str(pkl))
        res[key] = dict(counts=rep["counts"], launches=rep["launches"],
                        library_s=rep["library_s"], wall_s=walls[key],
                        sweep_wall_s=rep["wall_s"],
                        bit_equal_run_case=_same_roots(f"cli {key}", got,
                                                       ref, 1e-12))
    s_pickle = tmp / "s0.pickle"

    kh = tmp / "cli_kh.eigr"
    rep = sweep_json("sweep --complex --checkpoint",
                     "slab_flow_complex_coronal", "--complex",
                     "--checkpoint", kh, "-o", tmp / "kh.pickle")
    kh_case = cases.slab_flow_complex_coronal()
    want = {"slab_newton": -(-kh_case.n_k // CK_BLOCK)}
    if rep["counts"] != {"kink": 49} or rep["launches"] != want:
        raise AssertionError(f"cli KH sweep: {rep}, launches want {want}")
    with open(tmp / "kh.pickle", "rb") as f:
        layout = len(pickle.load(f))
    if layout != 2:
        raise AssertionError(f"cli KH pickle: {layout} arrays, want 2")
    modes, ks, om, oi = read_all(str(kh))
    fin = np.isfinite(om)
    om_c, k_d = roots.dedup_complex_roots(om[fin] + 1j * oi[fin], ks[fin],
                                          kh_case.tol.dedup_rel)
    stored = roots.RootSet({"kink": roots.RootBranch(
        om_c.real, k_d, omegas_imag=om_c.imag)})
    res["sweep --complex --checkpoint"] = dict(
        counts=rep["counts"], launches=rep["launches"],
        library_s=rep["library_s"], wall_s=walls[
            "sweep --complex --checkpoint"], pickle_arrays=layout,
        stored_growth_rates=int(np.sum(np.abs(om_c.imag) > 0)),
        bit_equal_run_case=_same_roots("cli KH store", stored,
                                       sets["kh_w1e5"], 1e-12, imag=True))

    roots.save_pickle(str(tmp / "cyl.pickle"), sets["cyl_co_09"])
    cyl_args = ("--case", "cylinder_density_coronal", "--width", "0.9")
    # figures and the movie need matplotlib, which a machine may lack:
    # there the commands run without their figures, and the movie is not
    # made (the CPU tests draw them)
    plots = importlib.util.find_spec("matplotlib") is not None
    res["matplotlib"] = dict(installed=plots)
    commands = [
        ("analyze", ("analyze", s_pickle, *case_args)
         + (("--plot", tmp / "d.png", "--analytic") if plots else ())),
        ("eigenfunction", ("eigenfunction", s_pickle, *case_args, "--k",
                           EF_K, "--branch", "kink")
         + (("--plot", tmp / "ef.png") if plots else ())),
        ("vtk", ("vtk", s_pickle, *case_args, "--k", EF_K, "--branch",
                 "kink", "--frames", 2, "-o", tmp / "field")),
        ("vtk cylinder", ("vtk", tmp / "cyl.pickle", *cyl_args, "--k", EF_K,
                          "--branch", "kink", "--frames", 2, "-o",
                          tmp / "tube"))]
    if plots:
        commands.append(("movie", ("movie", tmp / "cyl.pickle", *cyl_args,
                                   "--k", EF_K, "--branch", "kink",
                                   "--frames", 4, "-o", tmp / "wave.mp4")))
    kink = ref["kink"]
    for key, args in commands:
        stdout, walls[key] = _cli(tmp, *args)
        res[key] = dict(wall_s=walls[key])
        if key == "analyze":
            rep = json.loads(stdout.splitlines()[0])
            if rep["counts"] != ref.counts():
                raise AssertionError(f"cli analyze: {rep}")
        if key == "eigenfunction":
            rep = json.loads(stdout.splitlines()[0])
            i = int(np.argmin(np.abs(kink.ks - EF_K)))
            if (rep["omega"], rep["k"]) != (float(kink.omegas[i]),
                                            float(kink.ks[i])):
                raise AssertionError(f"cli eigenfunction: {rep}")
            res[key]["v_phase"] = rep["v_phase"]
        if "saved" in stdout:
            p = _saved(stdout)
            res[key].update(file=p.name, bytes=p.stat().st_size)
        elif key.startswith("vtk") or plots:
            raise AssertionError(f"cli {key}: nothing saved: {stdout}")
    if so.stat().st_mtime_ns != stamp:
        raise AssertionError("the CLI built the kernel library again")
    out["cli"] = res
    for key, r in res.items():
        line(f"phase 20 cli {key}", **r)
    return res


def _nearest(br, k: float) -> tuple:
    i = int(np.argmin(np.abs(br.ks - k)))
    return float(br.omegas[i]), float(br.ks[i])


def phase_eigenfunctions(out: dict, sets: dict) -> dict:
    """Phase 21: eigenfunctions on the card (float64 shoots, eager
    PyTorch): reconstruct_slab at the slab_ph_09 kink and sausage roots
    nearest k = 1.5 (phase 19's float64 sweep) and at one
    slab_flow_gaussian_coronal root (the shear form), reconstruct_cylinder
    at the cyl_co_09 m = 0 and m = 1 roots nearest k = 1.5 and at one
    twist_v01_p1 root; each field on the card within 1e-10 of its largest
    value of the same call on the CPU, and within 1e-9 at the cylinder's
    points r < 10 eps by the axis cutoff eps (there the reference's
    axis-regular combination of two basis solutions cancels ~1e6-fold, so
    that the card's exp, which differs from the CPU's in the last bit on
    ~8% of arguments, moves the Gaussian tube's xi_r and xi_phi by ~1e-10;
    the shoots are otherwise the same operations: the twisted tube, which
    calls no exp, is bit-equal); the uniform slab's kink mode
    cosh(m0 x) inside (rtol 1e-6, tests/test_eigenfunctions.py:86-99) on
    the card; the wall of each reconstruction on the card (after a
    warm-up, median of 3)."""
    import torch
    from eigensolver_tpu_torch import analytic, cases, eigenfunctions, search
    from eigensolver_tpu_torch import sweep
    import warnings
    warnings.simplefilter("ignore")
    cfg64 = search.SearchConfig(n_omega=256, n_bisect=18)
    flow = cases.slab_flow_gaussian_coronal()
    flow_rs, _ = sweep.run_case(flow, cfg64, device="cuda")
    tw = twisted_cases()["twist_v01_p1"]
    tw_rs, _ = sweep.run_case(tw, cfg64, device="cuda")
    slab, cyl = sets["slab_ph_09 float64"], sets["cyl_co_09"]
    jobs = {
        "slab_ph_09 kink": (eigenfunctions.reconstruct_slab,
                            cases.slab_density_photospheric(0.9), 1,
                            _nearest(slab["kink"], EF_K)),
        "slab_ph_09 sausage": (eigenfunctions.reconstruct_slab,
                               cases.slab_density_photospheric(0.9), 0,
                               _nearest(slab["sausage"], EF_K)),
        "flow_gauss kink (shear)": (eigenfunctions.reconstruct_slab, flow, 1,
                                    _nearest(flow_rs["kink"], EF_K)),
        "cyl_co_09 m=0": (eigenfunctions.reconstruct_cylinder,
                          cases.cylinder_density_coronal(0.9), 0,
                          _nearest(cyl["sausage"], EF_K)),
        "cyl_co_09 m=1": (eigenfunctions.reconstruct_cylinder,
                          cases.cylinder_density_coronal(0.9), 1,
                          _nearest(cyl["kink"], EF_K)),
        "twist_v01_p1 m=1": (eigenfunctions.reconstruct_cylinder, tw, 1,
                             _nearest(tw_rs["kink"], EF_K)),
    }
    res = {}
    for key, (fn, case, mode, (om, k)) in jobs.items():
        card = fn(case, mode, om, k, device="cuda")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            _, w = _timed(lambda: fn(case, mode, om, k, device="cuda"))
            walls.append(w)
        cpu, cpu_wall = _timed(lambda: fn(case, mode, om, k, device="cpu"))
        # off the axis cutoff: r >= 10 eps (a slab: everywhere)
        off = (np.abs(cpu.x) >= 10 * case.grid.axis_epsilon
               if fn is eigenfunctions.reconstruct_cylinder
               else np.ones(len(cpu.x), bool))
        worst = {"all": 0.0, "off_axis": 0.0}
        for f in ("x", "P_T", "xi_r", "vx", "xi_phi", "xi_z", "v_r",
                  "v_phi", "v_z"):
            a, b = getattr(card, f), getattr(cpu, f)
            if b is None:
                continue
            if not (np.all(np.isfinite(a)) and a.shape == b.shape):
                raise AssertionError(f"{key} {f}: non-finite or misshapen")
            scale = np.max(np.abs(b))
            d = np.abs(a - b) / scale if scale else np.zeros_like(a)
            for where, sel, tol in (("all", slice(None), 1e-9),
                                    ("off_axis", off, 1e-10)):
                err = float(np.max(d[sel]))
                if not err <= tol:
                    raise AssertionError(
                        f"{key} {f}: card vs CPU {err:.3e} of its largest "
                        f"value ({where}; held to {tol})")
                worst[where] = max(worst[where], err)
        res[key] = dict(omega=om, k=k, points=len(card.x),
                        wall_s=statistics.median(walls), walls_s=walls,
                        cpu_wall_s=cpu_wall,
                        max_rel_diff_vs_cpu=worst["all"],
                        max_rel_diff_vs_cpu_off_axis=worst["off_axis"])

    # the uniform slab's kink surface mode, on the card
    case = cases.slab_density_photospheric(width=1e5)
    rg, k = case.regime, 1.5
    v = analytic.scan_relation(
        lambda v: analytic.slab_relation(rg, v, k, 1), 1.115, 1.13)
    om = float(v[0] * k)
    ef = eigenfunctions.reconstruct_slab(case, 1, om, k, device="cuda")
    m0 = np.sqrt((k**2 * rg.c_i0**2 - om**2) * (k**2 * rg.vA_i0**2 - om**2)
                 / ((rg.c_i0**2 + rg.vA_i0**2)
                    * (k**2 * rg.cT_i0**2 - om**2)))
    inside = np.abs(ef.x) <= 1.0
    want = np.cosh(m0 * ef.x[inside])
    got = ef.vx[inside] / ef.vx[np.argmin(np.abs(ef.x))]
    rel = float(np.max(np.abs(got / want - 1)))
    if not rel <= 1e-6:
        raise AssertionError(f"uniform slab kink: cosh off by {rel:.3e}")
    res["uniform slab kink cosh"] = dict(omega=om, k=k, max_rel_err=rel)
    out["eigenfunctions"] = res
    for key, r in res.items():
        line(f"phase 21 eigenfunction {key}", **r)
    return res


# -- phase 26: the profile paths no shipped case takes -----------------------

def profiles_config(name: str, **grid):
    """A tools_torch/profiles_cases.py configuration with the port's
    modules; `grid` replaces fields of its GridConfig."""
    from eigensolver_tpu_torch import cases, config
    from tools_torch import profiles_cases
    return profiles_cases.configure(name, cases, config, **grid)


def _bits_equal(what: str, got, want) -> int:
    """Hold a dispersion result's (det, mismatch_pct, valid) bit-equal to
    want's, non-finite values where want's are (NaN where NaN); return
    its non-finite dets."""
    import torch
    if not torch.equal(got.valid, want.valid):
        raise AssertionError(f"{what}: valid differs")
    for f in ("det", "mismatch_pct"):
        a, b = (getattr(r, f).cpu().numpy() for r in (got, want))
        bad = ~_same_bits(a, b)
        if bad.any():
            raise AssertionError(f"{what}: {int(bad.sum())} {f} values "
                                 f"differ from the plain version")
    return int((~got.det.isfinite()).sum())


def _profile_brackets(case, n: int, seed: int, dtype):
    """n brackets (lo, hi, k, mode) between neighbouring points of the
    case's n_omega = 256 ladder, drawn at random, the mode from 0 and 1,
    as CUDA tensors."""
    import torch
    from tools_torch import batches
    om, ks, _ = batches.ladder_arrays(case, 256)
    rng = np.random.default_rng(seed)
    row = rng.integers(0, om.shape[0], n)
    col = rng.integers(0, om.shape[1] - 1, n)
    m = rng.integers(0, 2, n).astype(np.float64)
    return [torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dtype)
            for a in (om[row, col], om[row, col + 1], ks[row], m)]


def _profile_draws(case, n: int, dtype):
    """PROFILE_N_CHECK candidates (omega, k, mode) of the case's ladder: a
    slab's n / 2 random (omega, k) at parity 0, then the same at parity 1
    (the paired scan's layout); a twisted tube's n random draws; a density
    or axial-flow tube's n / 2 random draws, then n / 2 of the ladder in
    ladder order (whole rows: the scan's row table)."""
    import torch
    from tools_torch import batches
    if case.geometry.value == "slab":
        om, k, _ = batches.ladder_draws(case, n // 2, 26, dtype)
        par = torch.cat([torch.zeros_like(om), torch.ones_like(om)])
        return [torch.cat([om, om]), torch.cat([k, k]), par]
    if case.twist_profile is not None:
        return batches.ladder_draws(case, n, 26, dtype)
    draws = batches.ladder_draws(case, n // 2, 26, dtype)
    rows = [x[:n // 2] for x in batches.flat_ladder(case, 256, dtype)]
    return [torch.cat([a, b]) for a, b in zip(draws, rows)]


def _profile_real_kernels(name: str, case, dtype) -> dict:
    """Phase 26's real-omega checks of one configuration and type at a
    quarter of the depth (`shallower`), each kernel bit-equal to its plain
    version: the scan on PROFILE_N_CHECK candidates (`_profile_draws`; the
    twisted chain's scan and small-batch path; a slab's paired scan on
    their pairs; a density or axial-flow tube's scan with the numeric
    exterior too), and the fused bisection at NUM_PLAIN_N_ITER on
    PROFILE_N_BR brackets to the loop over the plain version, taken two
    levels a round (`search.bisect_loop(levels=2)`, the loop's bits). The
    plain version's time is set by the chain's serial steps, not by the
    batch, so the scan's candidates ride in the bisection's one plain
    call."""
    import torch
    from eigensolver_tpu_torch import search
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    dt = str(dtype).split(".")[1]
    pcase = shallower(case)
    kern, plain = (f(dtype) for f in _physics(pcase))
    n = PROFILE_N_CHECK
    twisted = pcase.twist_profile is not None
    slab = pcase.geometry.value == "slab"
    args = _profile_draws(pcase, n, dtype)
    br = _profile_brackets(pcase, PROFILE_N_BR, 27, dtype)
    scan = {}

    def plain_too(om, k, mode):
        # the loop's one call, with the scan's candidates first
        res = plain(torch.cat([args[0], om]), torch.cat([args[1], k]),
                    torch.cat([args[2], mode]))
        scan["want"] = type(res)(*(getattr(res, f)[:n] for f in
                                   ("det", "mismatch_pct", "valid")))
        return type(res)(*(getattr(res, f)[n:] for f in
                           ("det", "mismatch_pct", "valid")))
    t0 = time.perf_counter()
    loop = search.bisect_loop(plain_too, *br, NUM_PLAIN_N_ITER, levels=2)
    torch.cuda.synchronize()
    r = dict(n=n, brackets=PROFILE_N_BR,
             plain_n_interior=pcase.grid.n_interior,
             plain_ms=1e3 * (time.perf_counter() - t0))
    want = scan["want"]
    before = read_counters()
    fused = kern.bisect(*br, NUM_PLAIN_N_ITER)
    for x, y, f in zip(fused, loop, ("root", "mismatch")):
        bad = ~_same_bits(x.cpu().numpy(), y.cpu().numpy())
        if bad.any():
            raise AssertionError(f"{name} {dt} bisection: {int(bad.sum())} "
                                 f"{f} values differ from the plain loop")
    launched = {f"{pcase.geometry.value}_bisect": 1}
    if twisted:
        params = kcyl.disp_params(pcase)
        r["non_finite"] = _bits_equal(
            f"{name} {dt} twisted scan", kcyl.cylinder_disp(
                *args, params, shape=kcyl.TW_SCAN_SHAPE[dtype]), want)
        _bits_equal(f"{name} {dt} twisted small batch",
                    kcyl.cylinder_disp(*args, params), want)
        launched.update(cylinder_disp=2, cylinder_disp_small=1)
    else:
        r["non_finite"] = _bits_equal(f"{name} {dt} scan", kern(*args), want)
        launched[f"{pcase.geometry.value}_disp"] = 1
    if slab:
        # both parities of each (omega, k) of the first half in one thread
        half = [x[:n // 2].contiguous() for x in args[:2]]
        _bits_equal(f"{name} {dt} paired scan", kern.both_parities(*half),
                    want)
        launched.update(slab_disp=2, slab_paired=n)
    if not slab and not twisted:
        num = with_numeric(pcase, 3.0)
        nk, npl = (f(dtype) for f in _physics(num))
        t0 = time.perf_counter()
        nwant = npl(*args)
        torch.cuda.synchronize()
        r["plain_numeric_ms"] = 1e3 * (time.perf_counter() - t0)
        _bits_equal(f"{name} {dt} numeric scan", nk(*args), nwant)
        launched["cylinder_disp"] = 2
    # the kernels' launches (the plain versions' calls apart)
    check_launches(f"phase 26 {name} {dt}",
                   {k: v for k, v in counts_since(before).items()
                    if not k.startswith("plain_")}, launched)
    return r


def _profile_complex_kernels(name: str, case, dtype) -> dict:
    """Phase 26's complex-omega checks of one configuration and type at
    PROFILE_CX_GRID's depth: the case's complex-omega kernel (the slab's
    shear-form newton_kernel or flux_kernel, the cylinder's newton_kernel)
    on PROFILE_CX_N of the sweep's seeds (mode i mod 2), its Newton mode
    at NUM_PLAIN_N_ITER step with the value round in the launch and its
    evaluation mode at the roots, bit-equal to the plain Newton loop over
    the dual shoot and to the plain value dispersion."""
    import torch
    from eigensolver_tpu_torch import sweep
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    from eigensolver_tpu_torch.kernels import slab as kslab
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    from eigensolver_tpu_torch.search import newton_loop
    dt = str(dtype).split(".")[1]
    slab = case.geometry.value == "slab"
    grid = PROFILE_CX_GRID["slab" if slab else "cylinder"]
    ccase = dataclasses.replace(case, complex_omega=True,
                                grid=dataclasses.replace(case.grid, **grid))
    om0, k0 = sweep.complex_seeds(ccase)
    sel = np.random.default_rng(28).choice(len(k0), PROFILE_CX_N, False)
    seeds, kk = _cx_pairs(om0[sel], k0[sel], dtype)
    mode = (torch.arange(PROFILE_CX_N, device="cuda") % 2).to(dtype)
    if slab:
        ph, kmod = SlabPhysics.from_case(ccase), kslab
        dual = ph.make_dispersion_dual_plain(parity=None, dtype=dtype)
        plain = ph.make_dispersion_plain(parity=None, dtype=dtype)
        newton, evaluate = kslab.slab_newton, kslab.slab_disp_complex
    else:
        ph, kmod = CylinderPhysics.from_case(ccase), kcyl
        dual = ph.make_dispersion_dual_plain(m=None, dtype=dtype)
        plain = ph.make_dispersion_plain(m=None, dtype=dtype)
        newton, evaluate = kcyl.cylinder_newton, kcyl.cylinder_disp_complex
    params = kmod.disp_params(ccase, True) if slab else kmod.disp_params(ccase)
    t0 = time.perf_counter()
    want = newton_loop(dual, seeds, kk, mode, NUM_PLAIN_N_ITER)
    at_roots = plain(want, kk, mode)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    before = read_counters()
    got, res = newton(seeds, kk, mode, NUM_PLAIN_N_ITER, 1.0, params,
                      final_eval=True)
    ev = evaluate(got, kk, mode, params)
    torch.cuda.synchronize()
    geo = "slab" if slab else "cylinder"
    variant = {}
    if slab and not params.struct.shear:
        variant = {"slab_complex_flux": 2}
    if not slab and case.twist_profile is not None:
        variant = {"cylinder_complex_twisted": 2}
    check_launches(f"phase 26 {name} {dt} complex", counts_since(before),
                   {f"{geo}_newton": 1, f"{geo}_disp_complex": 1, **variant})
    err = _cx_bits(f"phase 26 {name} {dt} {geo}_newton",
                   {"re": got.re, "im": got.im},
                   {"re": want.re, "im": want.im})
    for what, r in (("value round", res), ("evaluation", ev)):
        if not torch.equal(r.valid, at_roots.valid):
            raise AssertionError(f"phase 26 {name} {dt} {what}: valid "
                                 f"differs")
        _cx_bits(f"phase 26 {name} {dt} {what}",
                 {"det_re": r.det.re, "det_im": r.det.im,
                  "mismatch": r.mismatch_pct},
                 {"det_re": at_roots.det.re, "det_im": at_roots.det.im,
                  "mismatch": at_roots.mismatch_pct})
    return dict(n=PROFILE_CX_N, n_iter=NUM_PLAIN_N_ITER, grid=grid,
                plain_ms=plain_ms, max_abs_err=err,
                finite=float((got.re.isfinite() & got.im.isfinite())
                             .float().mean()))


def _profile_sweeps(name: str, case) -> dict:
    """The configuration's full sweep on the card at float64, counted (2
    launches: the scan, the slab's paired, and the fused bisection; never
    the plain dispersion) and held to the JAX package's counts exactly,
    and at float32 held to the IEEE-compiled JAX package's within
    PROFILE_BANDS (to the port's own CPU run where the target gives one:
    profiles_cases.py)."""
    import torch
    from eigensolver_tpu_torch import search, sweep
    from tools_torch import profiles_cases
    target = profiles_cases.TARGETS[name]
    slab = case.geometry.value == "slab"
    geo = "slab" if slab else "cylinder"
    res = {}
    for dtype in ("float64", "float32"):
        cfg = profiles_cases.search_config(search.SearchConfig, dtype)
        reset_counters()
        rs, st = sweep.run_case(case, cfg, device="cuda")
        torch.cuda.synchronize()
        got = read_counters()
        want = {f"{geo}_disp": 1, f"{geo}_bisect": 1}
        if slab:
            want["slab_paired"] = st.n_candidates
        check_launches(f"phase 26 {name} {dtype} path", got, want)
        if st.n_candidates != target["candidates"]:
            raise AssertionError(f"{name}: {st.n_candidates} candidates")
        _check_roots(rs, case)
        if dtype == "float64":
            refs = [("jax", target["float64"], 0.0)]
        elif "float32_port_cpu" in target:
            # the port's own plain versions on a CPU, where the twisted
            # chain's tangents, ordered otherwise than jax.jvp's, move the
            # IEEE-compiled JAX package's f32 count beyond the band
            # (profiles_cases.py); JAX's printed beside
            refs = [("port_cpu", target["float32_port_cpu"],
                     PROFILE_BANDS[geo]),
                    ("jax_ieee", target["float32_ieee"], None)]
        else:
            refs = [("jax_ieee", target["float32_ieee"],
                     PROFILE_BANDS[geo])]
        res[dtype] = dict(counts=rs.counts(), wall_s=st.wall_s,
                          launches={k: v for k, v in got.items() if v},
                          root_digest=root_digest(rs),
                          minus_refs=_check_counts(f"{name} {dtype}",
                                                   rs.counts(), refs))
    return res


def _profile_complex_sweep(name: str) -> dict:
    """run_case_complex of a profiles_cases.COMPLEX configuration on its k
    subset on the card (2 launches a mode), held to the JAX package's
    float64 run: the roots off the axis and the audit exactly, per seed
    (`_check_cx_seeds`), and each branch's count where the JAX package's
    unconverged accepted seeds add no root."""
    from eigensolver_tpu_torch import cases, config, sweep
    from tools_torch import profiles_cases
    case, kw = profiles_cases.complex_case(name, cases, config)
    target = profiles_cases.COMPLEX_TARGETS[name]
    slab = case.geometry.value == "slab"
    geo = "slab" if slab else "cylinder"
    n_modes = len(case.modes)
    reset_counters()
    rs, stats = sweep.run_case_complex(case, **kw, device="cuda")
    got = read_counters()
    check_launches(f"phase 26 {name} complex path", got, {
        f"{geo}_newton": n_modes, f"{geo}_disp_complex": n_modes})
    if stats.n_candidates != target["candidates"]:
        raise AssertionError(f"{name}: {stats.n_candidates} seeds")
    seeds = _check_cx_seeds(name, case, kw, rs, target)
    exact = {b: target["counts_converged"][b] == n
             for b, n in target["counts"].items()}
    for b, n in rs.counts().items():
        if exact[b] and n != target["counts"][b]:
            raise AssertionError(f"{name} {b}: {n} roots, JAX "
                                 f"{target['counts'][b]}")
    margin = 0.05 * case.imag_band
    off_axis = {b: int(np.sum(np.abs(br.omegas_imag) > margin))
                for b, br in rs.branches.items()}
    if off_axis != target["counts_off_axis"]:
        raise AssertionError(f"{name}: off-axis counts {off_axis}, JAX "
                             f"{target['counts_off_axis']}")
    if stats.completeness != target["completeness"]:
        raise AssertionError(f"{name}: completeness {stats.completeness}, "
                             f"JAX {target['completeness']}")
    return dict(k_stride=profiles_cases.COMPLEX[name], wall_s=stats.wall_s,
                counts=rs.counts(), counts_jax=target["counts"],
                counts_exact=exact, counts_off_axis=off_axis,
                completeness=stats.completeness,
                launches={k: v for k, v in got.items() if v}, seeds=seeds)


def phase_profiles(out: dict) -> None:
    """Phase 26 (see the module's docstring)."""
    import torch
    from tools_torch import profiles_cases
    t0 = time.perf_counter()
    res = {}
    for name in profiles_cases.CONFIGS:
        case = profiles_config(name)
        r = {}
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).split(".")[1]
            r[f"kernels {dt}"] = _profile_real_kernels(name, case, dtype)
            if name in PROFILE_CX_CHECKS:
                r[f"complex {dt}"] = _profile_complex_kernels(name, case,
                                                              dtype)
        r["sweeps"] = _profile_sweeps(name, case)
        if name in profiles_cases.COMPLEX:
            r["complex sweep"] = _profile_complex_sweep(name)
        line(f"phase 26 profiles {name}", **r)
        res[name] = r
    res["seconds"] = time.perf_counter() - t0
    line("phase 26 profiles", seconds=res["seconds"])
    out["profiles"] = res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", help="also write the full report here")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on a "
                           "CUDA card")
    import eigensolver_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    out: dict = {"nvidia_smi": smi}
    phase_build()
    phase_kve_ratio(out)
    phase_cylinder_disp(out)
    cyl_launches = phase_sweep(out)
    phase_slab_disp(out)
    slab_launches = phase_slab_sweep(out)
    from eigensolver_tpu_torch import cases
    cyl_case = cases.cylinder_density_coronal(0.9)
    slab_case = cases.slab_density_photospheric(0.9)
    flow_case = cases.slab_flow_gaussian_coronal()
    cg, sg, fg = cyl_case.grid, slab_case.grid, flow_case.grid
    # the K_m ratio of each evaluation counted at the bracket's lower end;
    # a step's first chain once where the kernel keeps it (and, for the
    # count before, 3 chains a step)
    from eigensolver_tpu_torch.kernels import cylinder as kcyl

    def cyl_bisect_ops(br, dt, ne, every_chain=False):
        return cyl_ops(br[0].numel(), ne, cg.n_interior, cg.n_axis_log,
                       exterior_args(cyl_case, br[0], br[2], dt),
                       distinct(br[2], br[3]),
                       None if every_chain else kcyl.chain_kept(cyl_case, dt))
    phase_bisect(out, "phase 8 cylinder_bisect", "cylinder_bisect", cyl_case,
                 N_BR_CYL, cyl_bisect_ops, chain="cylinder",
                 ops_every_chain=lambda *a: cyl_bisect_ops(*a, True))
    _, slab_refine = refine_stage(slab_case)
    phase_bisect(out, "phase 9 slab_bisect flux", "slab_bisect", slab_case,
                 N_BR_SLAB,
                 lambda br, dt, ne: slab_ops(br[0].numel(), ne,
                                             sg.n_interior),
                 refine=slab_refine, chain="slab")
    phase_bisect(out, "phase 9 slab_bisect shear", "slab_bisect", flow_case,
                 N_BR_FLOW,
                 lambda br, dt, ne: slab_ops(br[0].numel(), ne,
                                             fg.n_interior, shear=True),
                 key="slab_bisect_shear")
    phase_twisted_disp(out)
    tw_launches, tw_refined_launches = phase_twisted_sweep(out)
    tw_case = twisted_cases()["twist_v01_p1"]
    phase_bisect(out, "phase 12 twisted cylinder_bisect", "cylinder_bisect",
                 tw_case, N_BR_TWIST,
                 lambda br, dt, ne: cyl_tw_ops(
                     tw_case, br[0].numel(), ne,
                     exterior_args(tw_case, br[0], br[2], dt)),
                 key="twisted_bisect", plain_n_iter=TWIST_PLAIN_N_ITER,
                 plain_types=("float32",), loop_small=True)
    phase_twisted_levels(out)
    phase_numeric_kernels(out)
    tw_num_launches = phase_twisted_numeric_path()
    par_launches = phase_parity(out)
    phase_oracles(out)
    phase_complex_kernels(out)
    kh_launches = phase_kh_sweeps(out)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        sets, ck_launches = phase_checkpointed(out, Path(tmp))
        phase_cli(out, Path(tmp), sets)
        phase_eigenfunctions(out, sets)
        cx_launches = phase_complex_slab(out)
        phase_sharded(out, Path(tmp))
    phase_complex_cylinder_kernels(out)
    cx_cyl_launches = phase_complex_cylinder(out)
    phase_profiles(out)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    kve = out["kve_ratio"]
    cyl = out["cylinder_disp"]["full_ms"]
    slab = out["slab_disp"]["full"]
    ladder = out["slab_disp"]["ladder paired"]
    sf32 = ladder["flux slab_ph_09 float32"]
    cbis = out["cylinder_bisect"]["float32"]
    sbis = out["slab_bisect"]["float32"]
    kve_f32 = kve["shuffled float32"]
    tw = out["twisted_disp"]["full_ms"]["twist_v01_p1"]
    tw_mag = out["twisted_disp"]["full_ms"]["magnetic_p125"]
    tw_win = out["twisted_disp"]["window float64"]
    tw_small = out["twisted_disp"]["twist_v01_p1 float32"]
    tbis = out["twisted_bisect"]
    tlev = out["twisted_levels"]
    kernels = [{
        "name": "cylinder_disp",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/cylinder_disp.cu",
        # the XLA-fused program of physics/cylinder.py, with the Pallas
        # kernel's math (csrc/kve_ratio.cuh) inlined for the exterior
        "replaces": "eigensolver_tpu/physics/cylinder.py:236",
        "launches": cyl_launches["cylinder_disp"],
        # det, poles masked, on the candidates that "ms" and "plain_ms" time
        "max_abs_err": cyl["check_float32"]["max_abs_err_det"],
        "ms": cyl["float32"],
        "plain_ms": cyl["plain_float32"],
        **cyl["bound_float32"],
        "library_ms": None,
        # the sweep's own scan in ladder order, as the main path runs it,
        # every candidate through its block's row table
        "ladder_ms": cyl["ladder_float32"]["ms"],
        "ladder_bound_ms": cyl["ladder_float32"]["bound_ms"],
        "ladder_tabled_rows": cyl["ladder_float32"]["tabled_rows"],
        "float64_ladder_ms": cyl["ladder_float64"]["ms"],
    }, {
        # the twisted chain's scan (csrc/cylinder_twisted.cu; the XLA
        # program's coefficients with jax.jvp, physics/cylinder.py:189), on
        # twist_v01_p1's 76,800 ladder candidates: its launches on the
        # twisted main path (phase 11), float32 unless said
        "name": "cylinder_disp_twisted",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/cylinder_twisted.cu",
        "replaces": "eigensolver_tpu/physics/cylinder.py:189",
        "launches": (tw_launches["cylinder_disp"]
                     - tw_launches["cylinder_disp_small"]),
        "n": N_TWIST,
        "max_abs_err": tw["check_float32"]["max_abs_err_det"],
        "ms": tw["float32"], "plain_ms": tw["plain_float32"],
        "plain_n_interior": tw["plain_n_interior"],
        **tw["bound_float32"],
        "library_ms": None,
        "float64_ms": tw["float64"],
        "float64_bound_ms": tw["bound_float64"]["bound_ms"],
        # the magnetic case's 76,800 (every term of the chain live)
        "magnetic_p125": {
            "ms": tw_mag["float32"],
            "bound_ms": tw_mag["bound_float32"]["bound_ms"],
            "float64_ms": tw_mag["float64"],
            "float64_bound_ms": tw_mag["bound_float64"]["bound_ms"]},
    }, {
        # the twisted chain's small-batch path (the fused kernel's
        # evaluation mode, csrc/bisect.cuh::spec_kernel): the refine stage's
        # 3,090 float64 window ends of twist_v01_p1's float32 sweep; its
        # launches on the refined main path (phase 11)
        "name": "cylinder_disp_twisted_small",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/cylinder_twisted.cu",
        "replaces": "eigensolver_tpu/physics/cylinder.py:189",
        "launches": tw_refined_launches["cylinder_disp_small"],
        "n": tw_win["n"],
        "max_abs_err": tw_win["check"]["max_abs_err_det"],
        "ms": tw_win["ms"], "plain_ms": tw_win["plain_ms"],
        "plain_n_interior": tw_win["plain_n_interior"],
        "bound_ms": tw_win["bound_ms"], "bound_by": tw_win["bound_by"],
        "library_ms": None,
        "scan_ms": tw_win["scan_ms"],
        # 8,192 float32 ladder draws: this path and the scan
        "float32_8192_ms": tw_small["ms"],
        "float32_8192_scan_ms": tw_small["scan_ms"],
    }, {
        "name": "kve_ratio",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/kve_ratio.cu",
        "replaces": "eigensolver_tpu/kernels/bessel.py:125",
        # no main path launches it: its math (csrc/kve_ratio.cuh) runs inside
        # cylinder_disp's thread. Its own launch is phase 3's standalone run
        # on the cylinder sweep's exterior arguments; the other numbers here
        # are from phase 3's 552,960 shuffled float32 arguments.
        "launches": cyl_launches["kve_ratio"] + slab_launches["kve_ratio"],
        "inlined_in": "cylinder_disp",
        "standalone_launches": kve["standalone"]["launches"],
        "max_abs_err": kve_f32["max_abs_err"],
        "ms": kve_f32["ms"],
        "plain_ms": kve_f32["plain_ms"],
        "bound_ms": kve_f32["bound_ms"],
        "bound_by": kve_f32["bound_by"],
        # torch.special.modified_bessel_k0/_k1 and the ratios, a yardstick
        "library_ms": kve_f32["library_ms"],
    }, {
        "name": "slab_disp",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/slab_disp.cu",
        # the XLA-fused lax.scan program of physics/slab.py (no Pallas
        # original), flux and shear forms
        "replaces": "eigensolver_tpu/physics/slab.py:285",
        "launches": slab_launches["slab_disp"],
        # the main path's scan: slab_ph_09's 161,280 ladder candidates in
        # ladder order through the paired scan (flux form, f32), every one
        # counted as paired; det, poles masked, bit-equal there and on
        # every other set of phase 6
        "paired_candidates": slab_launches["slab_paired"],
        "max_abs_err": sf32["check"]["max_abs_err_det"],
        "ms": sf32["ms"],
        "paired_ms": sf32["ms"],
        "unpaired_ms": sf32["unpaired_ms"],
        "plain_ms": sf32["plain_ms"],
        "bound_ms": sf32["bound_ms"],
        "bound_by": sf32["bound_by"],
        # the bound before the paired scan: 3 chains a step, every candidate
        "bound_3_chains_ms": sf32["bound_3_chains_ms"],
        "library_ms": None,
        "launch_shape": sf32["shape"],
        # the other forms and types; the unpaired scan on random draws of
        # each sweep's size and on the refine stage's window launch
        **{key: {f: r[f] for f in ("n", "shape", "ms", "unpaired_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "bound_3_chains_ms") if f in r}
           for key, r in (("flux float64", ladder["flux slab_ph_09 float64"]),
                          ("shear float32",
                           ladder["shear flow_gauss float32"]),
                          ("shear float64",
                           ladder["shear flow_gauss float64"]),
                          ("random flux float32",
                           slab["flux slab_ph_09 float32"]),
                          ("random shear float32",
                           slab["shear flow_gauss float32"]),
                          ("window float64",
                           out["slab_disp"]["window float64"]))},
    }, {
        # on cyl_co_09's 17,280 brackets: csrc/bisect.cuh::spec_kernel over
        # SpecChain<T, false> (the r-only table, the K_m ratio), float32
        # unless said
        "name": "cylinder_bisect",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/cylinder_disp.cu",
        # the XLA fori_loop of search.bisect over physics/cylinder.py
        "replaces": "eigensolver_tpu/search.py:142",
        "launches": cyl_launches["cylinder_bisect"],
        "shape": cbis["shape"],
        # roots against the plain loop at plain_n_iter (bit-equal)
        "max_abs_err": cbis["max_abs_err_vs_plain"],
        "ms": cbis["ms"],
        "plain_ms": cbis["plain_ms"],
        "plain_n_iter": PLAIN_N_ITER,
        "plain_n_interior": cbis["plain_n_interior"],
        "ms_plain_n_iter": cbis["ms_plain_n_iter"],
        "launch_loop_ms": cbis["loop_ms"],
        # a step's first chain once where the kernel keeps it; 3 a step
        "bound_ms": cbis["bound_ms"],
        "bound_every_chain_ms": cbis["bound_every_chain_ms"],
        "bound_by": cbis["bound_by"],
        "library_ms": None,
        **float64_of(out["cylinder_bisect"]["float64"]),
    }, {
        # the twisted chain's speculative fused bisection on twist_v01_p1's
        # 2,400 brackets (phase 12), its launches on the twisted main path;
        # the bound counts the evaluations the loop needs
        "name": "cylinder_bisect_twisted",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/cylinder_twisted.cu",
        "replaces": "eigensolver_tpu/search.py:142",
        "launches": tw_launches["cylinder_bisect"],
        "n": N_BR_TWIST,
        "levels": tlev["sweep float32"]["default"][1],
        "max_abs_err": tbis["float32"]["max_abs_err_vs_plain"],
        "ms": tbis["float32"]["ms"],
        "plain_ms": tbis["float32"]["plain_ms"],
        "plain_n_iter": TWIST_PLAIN_N_ITER,
        "plain_n_interior": tbis["float32"]["plain_n_interior"],
        "ms_plain_n_iter": tbis["float32"]["ms_plain_n_iter"],
        "launch_loop_ms": tbis["float32"]["loop_ms"],
        "bound_ms": tbis["float32"]["bound_ms"],
        "bound_by": tbis["float32"]["bound_by"],
        "library_ms": None,
        "float64_ms": tbis["float64"]["ms"],
        "float64_bound_ms": tbis["float64"]["bound_ms"],
        # the refine stage's float64 bisection of the float32 sweep's roots
        "refine_float64": {k: tlev["refine float64"][k] for k in (
            "n", "n_iter", "default", "ms", "bound_ms", "evals_needed",
            "evals", "loop_ms", "plain_ms", "plain_n_iter",
            "plain_n_interior", "max_abs_err_vs_plain")},
    }, {
        # on slab_ph_09's 5,040 brackets (flux form): spec_kernel over
        # slab::SpecChain<T, kShear, false> (the x-only table, the exact
        # exterior); its launches on the slab main path (phase 7: the
        # bracket stage, and the refine stage's when refined)
        "name": "slab_bisect",
        "route": "cuda",
        "source": "eigensolver_tpu_torch/csrc/slab_disp.cu",
        # the XLA fori_loop of search.bisect over physics/slab.py
        "replaces": "eigensolver_tpu/search.py:142",
        "launches": slab_launches["slab_bisect"],
        "shape": sbis["shape"],
        "max_abs_err": sbis["max_abs_err_vs_plain"],
        "ms": sbis["ms"],
        "plain_ms": sbis["plain_ms"],
        "plain_n_iter": PLAIN_N_ITER,
        "plain_n_interior": sbis["plain_n_interior"],
        "ms_plain_n_iter": sbis["ms_plain_n_iter"],
        "launch_loop_ms": sbis["loop_ms"],
        "bound_ms": sbis["bound_ms"],
        "bound_by": sbis["bound_by"],
        "library_ms": None,
        **float64_of(out["slab_bisect"]["float64"]),
        # the refine stage's float64 bisection of the float32 sweep's roots
        "refine_float64": {k: out["slab_bisect"]["refine float64"][k] for k in (
            "n", "n_iter", "shape", "ms", "bound_ms", "evals_needed", "evals",
            "L0_ms", "loop_ms", "plain_ms", "plain_n_iter",
            "max_abs_err_vs_plain")},
        # slab_flow_gaussian_coronal's 5,600 brackets, the shear form
        "shear": {**{k: out["slab_bisect_shear"]["float32"][k] for k in (
            "n", "shape", "ms", "loop_ms", "bound_ms", "plain_ms",
            "max_abs_err_vs_plain")},
            **float64_of(out["slab_bisect_shear"]["float64"])},
    }]
    kernels += numeric_kernel_entries(out["numeric_kernels"], par_launches,
                                      tw_num_launches)
    kernels += complex_kernel_entries(out["complex_kernels"], kh_launches)
    kernels += complex_variant_entries(out["complex_slab"], cx_launches)
    kernels += complex_cylinder_entries(out["complex_cylinder"],
                                        out["complex_cylinder_kernels"],
                                        cx_cyl_launches)
    # the launches of phase 19's checkpointed paths (slab_ph_09 and
    # cyl_co_09 at float32, kh_w1e5), beside each main path's own
    ck_path = {"slab_disp": "slab_ph_09 float32",
               "slab_bisect": "slab_ph_09 float32",
               "cylinder_disp": "cyl_co_09 float32",
               "cylinder_bisect": "cyl_co_09 float32",
               "slab_newton": "kh_w1e5"}
    for k in kernels:
        if k["name"] in ck_path:
            k["checkpointed_launches"] = ck_launches[ck_path[k["name"]]][
                k["name"]]
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1, default=float))
    line("total", seconds=time.perf_counter() - _T0)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
