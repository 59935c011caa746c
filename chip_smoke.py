"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the final line):
  0. require CUDA; print the card (nvidia-smi name and power limit) and
     the torch / CUDA versions;
  1. build the kernels of polystokes_tpu_torch/csrc with nvcc (sm_90a, one
     nvcc per source, all started together); print each kernel's
     registers, static shared memory and spill bytes from the ptxas report,
     and for the five plane-window kernels (grid_mom_pap, moments,
     apply_reduced and the two uniform kernels) the planned geometry (the
     column, and the run of the apply kernels at 128^3), the window's
     dynamic shared memory and the blocks per SM the occupancy calculator
     allows;
  2. each of the thirteen kernels against its plain PyTorch twin at the
     main-path shapes (honey_coil 128^3, tile 16, float32; the uniform
     kernels on the uniform setup's 14-channel stack): max |diff| <= 1e-5
     max |twin| on every output, on the summed <x, A x> partials and on the
     three dots of the update kernels, with median times over 20 launches
     (each timed alone, host call included, as in earlier records), the
     device time of one launch (20 launches replayed from a CUDA graph) and
     the HBM bound; then the device time of both uniform kernels and of
     apply_reduced at each geometry (column and run) of UNIFORM_GEOMETRIES,
     from which packed_apply.uniform_plan takes its pick, and of moments at
     each column of MOMENT_COLUMNS at tile 16.  The update kernels run on
     the real CELL_ARROW
     (kind arrow) and DIAGONAL (kind diag) factors: cg_update with every
     kind, finish_update and exp_finish_update with arrow and none; the
     kernel table reports kind arrow, the kind of every path below;
  3. the applies on the card: symmetry |<y, A x> - <A y, x>| <= 1e-5
     |<y, A x>| of the reduced and the uniform apply, and each fused
     apply_dot against (apply(x), <x, apply(x)>): A x within 1e-5 of max,
     <x, A x> within 1e-5 relative; combine(x, forward_s(x), u) against
     apply_reduced(x, u) within 1e-5 of max; the moments kernel bit-equal
     to grid_mom_pap's moments at the planned column; apply_reduced(x, 0)
     against apply_uniform(x) on the 17-channel stack at one geometry
     (bit-equal expected and printed, held within 1e-6 of max); the
     REGION_ARROW solve's symmetry |<y, M x> - <M y, x>| <= 1e-5 |<y, M x>|;
  4. Path A, the main path: step() with fuse_pap=True (the bench default)
     on honey_coil 128^3 (untiled cube regions, max_regions 64, CELL_ARROW,
     tol 1e-3), once to warm and twice timed: converged, error < 1e-3,
     boundary_active == 0, equal iteration counts and bit-equal velocities
     in the two timed runs, and each kernel's launches as the CG's passes
     dictate.  The loop (krylov.PCGLoop) replays its pass from a CUDA graph
     and polls done every POLL_PASSES passes, so it launches n passes,
     the k iterations and the gated passes after convergence; with a = 1 +
     n applies launched (pcg_init's and one per pass):
       moments 1, apply_reduced 1, expand a, grid_mom_pap and finish a - 1,
       the others 0;
  5. Path A with REGION_ARROW at 128^3, the same checks and the setup
     seconds of its factors: moments a + 1, expand 2a, apply_reduced 1,
     grid_mom_pap and finish a - 1, transpose_u a, the others 0;
  6. the fuse_pap=False path at 128^3: moments, expand and apply_reduced
     once per apply, the others 0;
  7. Path B, the uniform baseline (do_reduced_regions=False) at 128^3 with
     fuse_pap=True (apply_uniform 1, apply_uniform_pap a - 1), warm and
     twice timed with phase 4's checks, and fuse_pap=False (apply_uniform
     once per apply); no reduced kernel;
  8. Path F, fuse_update with fuse_expand (CELL_ARROW) at 128^3, warm and
     twice timed with phase 4's checks: moments, expand and apply_reduced 1
     (pcg_init), grid_mom_pap and exp_finish_update a - 1, the others 0
     (finish among them); its ms per apply beside Path A's;
  9. at 128^3, once each: F' (fuse_expand off): moments and apply_reduced
     1, expand a, grid_mom_pap and finish_update a - 1; B_u (the uniform
     step with fuse_update): apply_uniform 1, apply_uniform_pap and
     cg_update a - 1; REGION_ARROW with fuse_update, which has no fused
     update in either package: phase 5's counts, no update kernel;
 10. Path A and Path B on the card against the port on the CPU at 32^3,
     float32, tol 1e-5: both converge, velocities within 2e-4 max |v|;
 11. at 32^3 on the card, tol 1e-5: IDENTITY and DIAGONAL with fuse_update
     against the same step without it, and Path F on the card against the
     CPU: all converge, velocities within 2e-4 max |v|;
 12. graph against eager at 128^3 on every path of phases 4-9: krylov.pcg
     on one Krylov system through the graph and through the eager loop:
     equal k and passes, x bit-equal, equal launches; ms per apply of
     each (solve wall / applies), the capture seconds and the graph pool's
     memory; each loop's device busy time, idle share and top kernels over
     one poll block (torch.profiler); then each path's ms per apply from
     the graphed step (phases 4-9) beside the eager and graphed loops';
 13. solve_chunked at 128^3 on Path A, segment_iters=100: bit-equal to
     step with equal iterations; stopped by a callback after 2 segments
     with a state file in a temporary directory (interrupted, 200
     iterations), then resumed from it, bit-equal to the whole; with
     max_seconds=0.0 one segment (100 iterations), not converged;
 14. tiled mode (do_tile=True, tile 16, padding 2; the JAX suite's config
     3): A_t, Path A on honey_coil 128^3, warm and once timed with phase
     4's checks (n_regions beside the TPU record's 152, printed); F_t (A_t
     with fuse_update and fuse_expand) and R_t (A_t with REGION_ARROW), one
     timed step each, converged with their paths' launches; S16 and S8,
     Path A on armadillo_melt_si 256^3 at tile 16 and tile 8 (the suite's
     configs 16 and 18, at the scene's density 1000, which
     solver.sample_density reads off its field as the suite's does;
     n_regions beside 753 and 3542, printed),
     converged with their launches, with the setup seconds, ms per apply
     and peak device memory; and the tiled 32^3 step at tile 8 on the card
     against the CPU port (phase 10's bound).
 15. the affine basis (BasisOrder.AFFINE, the CLI's --affine), tiled (tile
     16, padding 2) on honey_coil 128^3, f32, tol 1e-3: A_aff (Path A,
     CELL_ARROW, fuse_pap) and F_aff (fuse_update with fuse_expand), each
     warm and once timed with phase 4's checks (converged, exact launches
     of the K = 4 kernels, bit-equal repeats); the CLI test's
     configuration (affine, DIAGONAL, tile 8) at 128^3, one step; and the
     affine 32^3 step on the card against the CPU port (phase 10's bound).
 16. the frame loop (sim.simulate through solver.sample_density, the two
     configurations of the JAX package's benchmarks/frames_ab.py),
     honey_coil 128^3, f32, tol 1e-3, CELL_ARROW, fuse_pap, FRAMES frames
     a run: tiled (tile 16, padding 2) with the device warm start, the
     same again, tiled cold, and uniform with the warm start.  Every frame
     converged with error < 1e-3, finite velocities and SDF, and the
     launches of A_t (tiled) or B_fused (uniform) from counters set to 0
     before the frame; the two warm tiled runs with equal iterations and
     bit-equal velocities and SDF; the warm x0 of frame 1 non-zero;
     device memory after frames 2-FRAMES at most one scene's bytes above
     frame 1's.  Printed per frame: iterations, solve and frame seconds,
     advection ms, capture seconds, peak device memory.  Then the
     windowed and the gather advection of the SDF at 128^3 (ms a call and
     device ms), agreeing within 1e-6 of max on a constant velocity; and
     one 32^3 frame (tile 8, tol 1e-5) on the card against the CPU port:
     velocities and SDF each within phase 10's bound of their max.
 17. the cropped solve (domain.solve_cropped, the CLI's --crop) on
     armadillo_melt_si 256^3 with S16's parameters (the JAX suite's
     config 23): the box (checked by check_pallas) and its share of the
     domain, then a warm and a timed solve on it: converged, exact
     launches of A (C16), bit-equal repeats, the DOF and region counts of
     S16, the input velocity outside the box and no valid face there;
     printed beside S16's (phase 14 keeps its velocities and figures):
     iterations, n_regions, seconds, ms per apply, capture seconds, peak
     device memory, and the velocities inside the box against S16's.
     Kernels 1-5 against their twins at the box's shape (224^3), as in
     phase 2.  Then one solution through both systems: the cropped system's CG
     (bit-equal to the timed runs), its x in fp64 through the cropped
     system and, embedded, through the full-domain one, whose residual
     b - A x inside the box agrees with the cropped one's within
     CROP_RTOL of max(|A x|, |b|) (and is within it of 0 outside) and
     whose write-back inside the box is within CROP_RTOL of max |v| of
     the cropped one's.  Two tol-1e-3 solves of this scene need not agree to
     that bound (S16 moved 20 % of max |v| between tol 1e-3 and 1e-5;
     PERF.md section 7), so the cropped and the uncropped tol-1e-3
     velocities are printed, not held;
 18. the other solvers: solver_type BICGSTAB (tol 1e-5), MINRES (20
     iterations) and the BiCGStab fallback (PCG stopped at 20 iterations,
     then 20 of BiCGStab) at 32^3 in fp64 on the card against the CPU
     port, each within phase 10's bound (fp64: in f32 this BiCGStab meets
     a tol-1e-5 test only by letting x grow, and this MINRES overflows
     within 10 iterations); one BICGSTAB step at 128^3, tol 1e-3, in f32
     (at most 1500 iterations) and in fp64 (iterations, converged,
     seconds, ms per apply) with the launches of kernels 1-3, 1 + 3
     passes each; then the f32 fallback at 128^3 on Path A's system
     (IDENTITY PCG, tol 1e-5, stopped at 1500 iterations, then BiCGStab
     to 1500): the step writes back BiCGStab's x only where it is finite
     and its true residual |b - A x| is no larger than PCG's, and the x
     written back is finite with a residual no larger than PCG's; both
     residuals printed, the launches of both solves and of the residual
     applies held;
 19. the CLI end to end, each run a process of its own: python -m
     polystokes_tpu_torch.run with JAX's default flags on honey_coil 64^3
     (IDENTITY, BiCGStab fallback, the unpacked apply) for 2 steps with a
     checkpoint (written with use_pallas=False, as the JAX CLI's default
     writes it), resumed for 1 (printing step 2), with --crop --chunked,
     with --sim for 2 frames, with --pallas (the packed kernels), with
     --profile (profiling.step_instrumented), with --bf16-coeffs --pallas,
     with --deflation and with --deflation --pallas: each exits with 0 and
     prints its step or frame lines with converged=True;
 20. the unpacked apply (use_pallas=False, JAX's default: no hand-written
     kernel) on honey_coil 128^3, f32, tol 1e-3, CELL_ARROW, each path
     warm and once timed with phase 4's checks (converged, error < 1e-3,
     bit-equal repeats) and 0 launches of every kernel: U_t (A_t
     unpacked; iterations beside A_t's and the JAX record 3545, ms per
     apply beside A_t's), U (A unpacked), G (untiled general regions,
     cube_regions=False: n_regions beside U's) and P0 (tiled, tile_padding
     0), with each step's peak device memory; the device time of one
     J-coupling reduce and expand on each (cube-major or segmented); one
     apply of A's and A_t's systems, unpacked against packed on one x,
     within 1e-5 of max; the
     JAX suite's config 19 (honey_coil 64^3, fp64, unpacked, untiled,
     max_regions 64): converged, iterations beside the JAX record 162;
 21. at N_21^3 (16^3), tol 1e-5: the unpacked step with IDENTITY, DIAGONAL,
     CELL_ARROW and REGION_ARROW, and G, on the card against the CPU port
     (phase 10's bound); check_pallas on a 16^3 all-liquid box (liquid on
     the index-0 planes) warns and returns use_pallas=False, and the step
     then converges with no kernel launched; honey_coil 72^3 at tile 16
     (which the tile does not divide) with use_pallas=True runs unpacked,
     converged, no kernel launched;
 22. FLIP (flip.simulate_flip: 2^20 particle slots, reseeding on) on
     honey_coil 128^3 with A_t's packed parameters, FLIP_FRAMES frames,
     twice: every frame preflighted by check_pallas on its own particle
     surface (a frame whose liquid reaches the index-0 planes runs
     unpacked and says so), converged, and launching kernels 1-5 as A_t
     does (none where it ran unpacked), from counters set to 0 before the
     frame; per frame the iterations, particles alive, peak device memory
     and the wall split into P2G, the surface rebuilds, the preflight,
     the solve, G2P, advection and reseeding; the two runs bit-equal
     (velocities, positions, particle velocities, alive).  Then the CLI's
     --flip 262144 at 64^3 for 2 frames, with its default flags and with
     --pallas, each a process: exit 0, converged=True on every frame line;
     and one flip_frame (reseeding on) at 32^3, tile 8, tol 1e-5 on the
     card against the CPU port (phase 10's bound);
 23. MULTIGRID (unpacked, as in JAX) on honey_coil 128^3 tiled at tile 16
     (A_t's system), warm and timed: converged, captured as a CUDA graph,
     bit-equal, no kernel launched; iterations and ms per apply beside
     U_t's (phase 20); at N_MG^3 (16^3; tile 8, tol 1e-5, the cheaper
     MG_CHEAP cycle) on the card against the CPU port, both converged
     (phase 10's bound); --precond multigrid through the CLI at 32^3;
 24. the host connected components (cc_host_callback=True) on Path A
     untiled at 128^3: the device propagation's partition, n_regions and
     labels; the two forms timed alone (host clock, transfers included);
     the step converged with A's launches;
 25. the bf16 coefficient stack (coeff_bf16): each of the twelve kernels
     that read the stack in its bf16 form (entry points
     ps_<name>[_k<K>]_<f32|f64>_bf16, counted as <name>_bf16) against its
     twin on the bf16 stack at phase 2's shapes and inputs, within
     KERNEL_RTOL of max |twin|, timed as in phase 2 beside its f32 form,
     its bound with the coefficient channels (COEFF_CHANNELS) at 2 bytes;
     the bf16 reduced and uniform applies symmetric to SYM_RTOL and within
     3 % of the f32 stack's; A, A_t, F and B with coeff_bf16 twice each
     (converged, the bf16 forms' exact launches, bit-equal), R and F' once:
     iterations, error and ms per apply beside the f32 paths';
 26. A-DEF2 deflation (k = 3584): A_t and B deflated at 128^3 and S16
     (armadillo_melt_si 256^3 T16) at deflation_tile 32: E built twice,
     bit-equal, with its setup seconds (DEFL_PROBES probe applies, the
     assembly, the inverse); two deflated steps each, converged, captured
     in the CUDA graph, bit-equal, with their launches (the probes, the
     projected guess and one unfused apply a pass besides the path's own);
     iterations, ms per apply and step seconds beside the undeflated
     step's; a deflated 32^3 step (tile 8, tol 1e-5) on the card against
     the CPU port (phase 10's bound);
 27. the x-slab step (polystokes_tpu_torch/parallel): the halo forms of
     kernels 1 (K = 10 and 4), 3 and 7 (halo=HALO_X, counted as
     <name>_halo[_bf16]) on each of SLABS slabs cut from phase 2's inputs,
     the stack in f32 and in bf16, each within KERNEL_RTOL of its twin,
     the slabs joined bit-equal to phase 2's form without a halo; the
     middle slab's halo form timed beside the form without a halo on the
     same slab (device ms, bound over the input planes the kernel reads:
     the slab's and one halo plane a side); the sharded apply
     at 2 and 4 slabs of the card bit-equal to the unsharded one on A's,
     A_t's and B's systems, its device ms beside the unfused apply's;
     sharded_step on A_t's system at SLABS slabs twice (converged,
     graphed, bit-equal to the unsharded unfused step A_t_unfused with
     equal iterations, SLABS launches of kernels 1-3 an apply, none of
     4-11; ms per apply and peak memory), and once on B's, A_aff's and
     the bf16 A_t's and B's systems (the launches of the other halo
     forms); a 2 x 2 mesh warns and runs unpacked with no launch;
     dryrun_multichip(8) on the card; with two cards or more, the apply
     and the step on a mesh of cuda:0 and cuda:1.
 28. the host surfaces (export, host_solve, viz) on the card's state, with
     (d)'s processes started first and running beside (a)-(c): (a) the
     explicit blocks (export.ExplicitOperators: G JG Dt JDt Mc McInv u
     uInv Mr BInv B uRed uInvRed JDtRed) and vectors() from the card's
     assembled state of honey_coil 32^3 (fp64, tile 8, CELL_ARROW) against
     the CPU port's: identical sparsity, values within 1e-12 of max; (b) on
     A's configuration (untiled, tile 16, f32) at 32^3, 64^3 and 128^3 (phase
     2's system): the exported Schur operator on a seeded x in the DOF order
     against the fused apply (kernels 4, 2, 5) and the unfused one (1, 2, 3),
     within 1e-5 of max, <x, A x> within 1e-5; the Schur matrix itself at
     32^3 only (its region blocks are dense: their size is printed at each
     n), elsewhere its factored form (schur_operator); the seconds of
     ExplicitOperators, schur_operator and export_component_matrices and the
     peak RSS; (c) solve_explicit at tol 1e-10 on the 32^3 system of (a),
     export_solution, solution_guess_ptau onto the card and step from it:
     converged in fewer than max(cold // 4, 2) iterations with A's exact
     launches (path A_warm), and the loaded guess through solve_explicit
     with info 0; (d) the CLI: --solver eigen --fp64 at 32^3, with --scheme
     all_dofs, pressure_velocity and all_dofs_explicit_interior_stress at
     16^3, --export-prefix --viz --pallas at 64^3 and --export-mtx at 16^3:
     exit 0, converged=True, the files, the "exported to" and "rendered"
     lines; the phase's wall printed.
Every packed phase checks that check_pallas's fallback did not fire
(packed_preflight) and that the packed layout takes its configuration.
Phase 2 also holds the tile-dependent kernels (moments, expand,
grid_mom_pap, exp_finish_update) against their twins at tile 8 on the
tiled armadillo_melt_si 256^3 setup of S8, with their device times and
shares of the bound, and the K = 4 forms of those four kernels (the
affine basis: 12 moments and coefficients a cube) at both shapes; the
kernel table lists them as <name>_k4, with the launches of A_aff (F_aff
for exp_finish_update_k4).  Phases 2-13 run untiled (do_tile=False).
Every launch count is read from counters set to 0 just before that run.
forward_s and combine (kernels 12 and 13) have no caller in either
package: they are checked in phases 2 and 3 and run on no path.
The kernel table is printed as JSON two lines before the last, then the
nvidia-smi line of the card; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

N_MAIN = 128
N_CPU = 32
TILE = 16
KERNEL_RTOL = 1e-5  # f32 sums of up to 4096 terms in another order than the twin
SYM_RTOL = 1e-5
PAP_RTOL = 1e-5  # the fused <x, A x> against the unfused one: f32, the symmetry bound
VEL_ATOL = 2e-4  # times max |v|: the packed-against-XLA bound of the JAX tests
CROP_RTOL = 1e-9  # the cropped system against the full one on one x, fp64: sums in another order
# (by, bz, L) of the uniform kernels timed in phase 2 at 128^3: 16 x 16 as
# grid_mom_pap's column, 8 x 32 and 4 x 32 for 128-byte z rows, 4 x 64 for
# 256-byte ones, runs of 16-32 planes
UNIFORM_GEOMETRIES = ((16, 16, 16), (16, 16, 32), (8, 32, 16), (8, 32, 24), (8, 32, 32), (4, 32, 32), (4, 64, 32))
# (by, bz) of the moments kernel timed in phase 2 at tile 16: the whole
# plane (grid_mom_plan's) and its halves and quarter
MOMENT_COLUMNS = ((16, 16), (8, 16), (16, 8), (8, 8))
CROSS_RTOL = 1e-6  # apply_reduced(x, 0) against apply_uniform(x): one march, bit-equal expected
HBM_BYTES_PER_S = 3.35e12  # H100 SXM at 700 W
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PA = "polystokes_tpu/pallas_apply.py"
KERNELS = {
    # name: (source, TPU kernel replaced, full-size channels read, written,
    #        flops per slot counted from the formulas in the source notes)
    "moments": ("fused_apply.cu", f"{PA}:1329", 17, 0, 123),
    "expand": ("packed_apply.cu", f"{PA}:362", 3, 3, 81),
    "apply_reduced": ("fused_apply.cu", f"{PA}:552", 24, 7, 87),
    "grid_mom_pap": ("fused_apply.cu", f"{PA}:762", 24, 7, 179),
    "finish": ("fused_apply.cu", f"{PA}:817", 17, 7, 37),
    "apply_uniform_pap": ("fused_apply.cu", f"{PA}:797", 21, 7, 98),
    "apply_uniform": ("fused_apply.cu", f"{PA}:502", 21, 7, 84),
    "transpose_u": ("transpose_apply.cu", f"{PA}:720", 10, 7, 51),
    "forward_s": ("transpose_apply.cu", f"{PA}:520", 14, 3, 42),
    "combine": ("transpose_apply.cu", f"{PA}:536", 26, 7, 78),
    # the update kernels with CELL_ARROW's 13 factor channels, the kind of
    # every path this script drives; DIAGONAL reads 7, IDENTITY none
    # (UPDATE_FACTORS)
    "cg_update": ("update_apply.cu", f"{PA}:1253", 41, 21, 89),
    "finish_update": ("update_apply.cu", f"{PA}:897", 51, 21, 133),
    "exp_finish_update": ("update_apply.cu", f"{PA}:1091", 51, 21, 469),
}
UPDATE_FACTORS = {"arrow": 13, "diag": 7, "none": 0}
# the path whose launches the kernel table reports; None: no caller in
# either package, so no path runs the kernel
MAIN_PATH = {"moments": "A", "expand": "A", "apply_reduced": "A", "grid_mom_pap": "A", "finish": "A",
             "apply_uniform_pap": "B_fused", "apply_uniform": "B_fused", "transpose_u": "A_region",
             "forward_s": None, "combine": None, "cg_update": "B_u", "finish_update": "F_prime",
             "exp_finish_update": "F"}


# the tiled paths of phase 14 and the affine ones of phase 15 launch as
# their untiled quadratic counterparts
TILED_PATHS = {"A_t": "A", "F_t": "F", "R_t": "A_region", "S16": "A", "S8": "A", "C16": "A"}
AFFINE_PATHS = {"A_aff": "A", "F_aff": "F", "D8_aff": "A"}
# the kernels that read the basis: their K = 4 forms are rows <name>_k4 of
# the kernel table, launched on the affine paths
BASIS_KERNELS = ("moments", "expand", "grid_mom_pap", "exp_finish_update")
K4 = "_k4"
MAIN_PATH.update({"moments_k4": "A_aff", "expand_k4": "A_aff", "grid_mom_pap_k4": "A_aff",
                  "exp_finish_update_k4": "F_aff"})
# the bf16-storage forms (coeff_bf16): rows <name>_bf16 of the kernel
# table, counted under that name, launched on the bf16 paths; each reads
# these of its channels from the coefficient stack (or the reduced-face
# masks), at 2 bytes a value in its bf16 form
BF16 = "_bf16"
COEFF_CHANNELS = {"moments": 10, "expand": 3, "apply_reduced": 14, "grid_mom_pap": 17, "finish": 7,
                  "apply_uniform_pap": 14, "apply_uniform": 14, "transpose_u": 7, "forward_s": 7, "combine": 14,
                  "finish_update": 7, "exp_finish_update": 10}
COUNTERS = tuple(KERNELS) + tuple(k + BF16 for k in COEFF_CHANNELS)  # packed_apply.LAUNCHES' keys
# the bf16 paths of phase 25 launch as their f32 counterparts, in the bf16 forms
BF16_PATHS = {"A_bf16": "A", "A_t_bf16": "A", "F_bf16": "F", "B_bf16": "B_fused", "R_bf16": "A_region",
              "F_prime_bf16": "F_prime"}
MAIN_PATH.update({"moments_bf16": "A_bf16", "expand_bf16": "A_bf16", "apply_reduced_bf16": "A_bf16",
                  "grid_mom_pap_bf16": "A_bf16", "finish_bf16": "A_bf16", "apply_uniform_pap_bf16": "B_bf16",
                  "apply_uniform_bf16": "B_bf16", "transpose_u_bf16": "R_bf16", "forward_s_bf16": None,
                  "combine_bf16": None, "finish_update_bf16": "F_prime_bf16", "exp_finish_update_bf16": "F_bf16"})
# the x-slab paths of phase 27: a sharded step on SLABS slabs of the card
# launches each halo form (or expand) SLABS times an apply; (base path,
# whether its stack is bf16)
SLABS = 4
HALO = "_halo"
HALO_FORMS = ("moments", "apply_reduced", "apply_uniform")
COUNTERS += tuple(k + HALO for k in HALO_FORMS) + tuple(k + HALO + BF16 for k in HALO_FORMS)
SHARD_PATHS = {"A_t_s4": ("A", False), "B_s4": ("B", False), "A_aff_s4": ("A", False), "A_t_s4_bf16": ("A", True),
               "B_s4_bf16": ("B", True)}
MAIN_PATH.update({"moments_halo": "A_t_s4", "apply_reduced_halo": "A_t_s4", "apply_uniform_halo": "B_s4",
                  "moments_halo_k4": "A_aff_s4", "moments_halo_bf16": "A_t_s4_bf16",
                  "apply_reduced_halo_bf16": "A_t_s4_bf16", "apply_uniform_halo_bf16": "B_s4_bf16"})
TILED_PATHS["A_t_unfused"] = "unfused"
# the deflated paths of phase 26: the 189 probe applies of E, the projected
# guess, pcg_init's apply and deflated preconditioner, then per pass the
# step's fused apply and the preconditioner's unfused apply
DEFL_PROBES = 189
DEFL_PATHS = {"A_t_defl": "A_defl", "S16_defl": "A_defl", "B_defl": "B_defl"}
TILE_8 = 8
N_SI = 256
# the JAX suite's TPU records (BENCH_SUITE.json), printed beside ours, not held
JAX_REGIONS = {"A_t": 152, "S16": 753, "S8": 3542, "C16": 753}
# and its iteration records of the tiled 128^3 cell and of config 19
# (single_region_honey_coil_64_f64)
JAX_ITERS = {"U_t": 3545, "config 19": 162}
# the JAX suite's record of its cropped config 23 (crop_tiled_armadillo_si_256):
# iterations and the box's resolution, printed beside ours
JAX_CROP = {"iterations": 836, "res": (224, 224, 224)}
N_21 = 16  # phase 21's card-against-CPU size (32 before phases 22-24 took their time)
FRAMES = 2  # phase 16's frames per run (4 before phases 20-21, 3 before phases 22-24 took their time)


def ptxas_summary(report: str):
    """One dict per compiled kernel of nvcc's -Xptxas -v report: the mangled
    entry, registers, static shared memory and spill bytes."""
    kernels, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"entry": m.group(1), "registers": 0, "smem": 0, "spill_stores": 0, "spill_loads": 0}
            kernels.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["smem"] = int(sm.group(1)) if sm else 0
    return kernels


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=False,
        )
    except FileNotFoundError:
        return "nvidia-smi unavailable"
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "nvidia-smi unavailable"


def params(dtype, tol, max_iters, **kw):
    """The untiled main path's parameters (every path of phases 2-13: the
    packed kernels, CELL_ARROW, stated, since SolverParams' defaults are
    the JAX package's IDENTITY and unpacked apply), with ``kw`` over them
    (phase 14 sets do_tile=True, phase 20 use_pallas=False)."""
    from polystokes_tpu_torch import PreconditionerType, SolverParams

    base = dict(dtype=dtype, do_tile=False, tile_size=TILE, tile_padding=2, max_regions=64, tolerance=tol,
                max_iterations=max_iters, bicgstab_fallback=False, preconditioner=PreconditionerType.CELL_ARROW,
                use_pallas=True)
    return SolverParams(**{**base, **kw})


def packed_preflight(grid, scene, p, label):
    """solver.check_pallas on a packed phase's scene: its fallback to the
    unpacked apply must not fire there (boundary_active == 0), or the phase
    would silently leave the kernels."""
    from polystokes_tpu_torch import solver

    q = solver.check_pallas(grid, scene, p)
    if q != p or not solver._use_packed(grid, p):
        fail(f"{label}: the packed path is not taken (check_pallas returned use_pallas={q.use_pallas})")
    return q


def median_ms(fn, n=20):
    """Median of n single-launch times from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, n=20, reps=5):
    """Median device time of one launch: n calls captured in a CUDA graph and
    replayed, so the host's per-call cost (which median_ms includes) drops
    out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm on a side stream before the capture, as torch.cuda.graphs asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def bound(name, plane, small_bytes, itemsize, kind="arrow", stored_itemsize=None, slots_in=None):
    """(ms, 'bytes' or 'operations'): the larger of the HBM time of the
    channels the kernel must read and write once (plus its small per-cube
    arrays) and the float32 time of its flops; an update kernel reads the
    factor channels of its preconditioner kind.  ``stored_itemsize`` (2:
    the bf16 form) is the size of a value of the coefficient channels;
    ``slots_in`` (a halo form: the padded slab's) the slots of each input
    channel, ``plane`` by default."""
    _, _, read, written, flops = KERNELS[name]
    if name in ("cg_update", "finish_update", "exp_finish_update"):
        read += UPDATE_FACTORS[kind] - UPDATE_FACTORS["arrow"]
    stored = 0 if stored_itemsize is None else COEFF_CHANNELS[name] * (itemsize - stored_itemsize)
    slots_in = plane if slots_in is None else slots_in
    t_bytes = ((read * itemsize - stored) * slots_in + written * itemsize * plane + small_bytes) / HBM_BYTES_PER_S
    t_ops = flops * plane / F32_FLOPS_PER_S
    return (1e3 * t_bytes, "bytes") if t_bytes >= t_ops else (1e3 * t_ops, "operations")


def expected_launches(path, applies):
    if path in SHARD_PATHS:  # each halo form (and expand) once a slab
        base, bf16 = SHARD_PATHS[path]
        names = ("apply_uniform_halo",) if base == "B" else ("moments_halo", "expand", "apply_reduced_halo")
        counts = dict.fromkeys(COUNTERS, 0)
        counts.update({name + (BF16 if bf16 else ""): SLABS * applies for name in names})
        return counts
    if path in BF16_PATHS:  # the same counts, of the bf16 forms
        counts = expected_launches(BF16_PATHS[path], applies)
        for name in COEFF_CHANNELS:
            counts[name + BF16], counts[name] = counts[name], 0
        return counts
    counts = dict.fromkeys(COUNTERS, 0)
    path = {**TILED_PATHS, **AFFINE_PATHS, **DEFL_PATHS}.get(path, path)
    if path == "A_defl":
        # the apply of the probes, the guess, pcg_init and every preconditioner
        unfused = DEFL_PROBES + 3 + (applies - 1)
        counts.update(moments=unfused, apply_reduced=unfused, expand=unfused + applies - 1,
                      grid_mom_pap=applies - 1, finish=applies - 1)
    elif path == "B_defl":
        counts.update(apply_uniform=DEFL_PROBES + 3 + (applies - 1), apply_uniform_pap=applies - 1)
    elif path == "A":
        counts.update(moments=1, apply_reduced=1, expand=applies, grid_mom_pap=applies - 1, finish=applies - 1)
    elif path == "A_region":
        # each apply's solve adds moments, expand and transpose_u
        counts.update(moments=applies + 1, apply_reduced=1, expand=2 * applies, grid_mom_pap=applies - 1,
                      finish=applies - 1, transpose_u=applies)
    elif path == "unfused":
        counts.update(moments=applies, expand=applies, apply_reduced=applies)
    elif path == "F":
        # the update kernel expands and finishes: expand only in pcg_init
        counts.update(moments=1, apply_reduced=1, expand=1, grid_mom_pap=applies - 1, exp_finish_update=applies - 1)
    elif path == "F_prime":
        counts.update(moments=1, apply_reduced=1, expand=applies, grid_mom_pap=applies - 1, finish_update=applies - 1)
    elif path == "B_u":
        counts.update(apply_uniform=1, apply_uniform_pap=applies - 1, cg_update=applies - 1)
    elif path == "B_fused":
        counts.update(apply_uniform=1, apply_uniform_pap=applies - 1)
    elif path == "BiCGStab":
        # three unfused reduced applies an iteration (applies = 1 + 3 passes)
        counts.update(moments=applies, expand=applies, apply_reduced=applies)
    else:
        counts.update(apply_uniform=applies)
    return counts


def compare(name, got, ref, label=None):
    """Max |diff| over the outputs (tuples: each, and the summed partials
    when the last is a partials vector); fails above KERNEL_RTOL of max |twin|."""
    label = label or name
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        pairs = [(g, r)]
        if name in ("grid_mom_pap", "apply_uniform_pap") and i == len(got) - 1:
            pairs = [(g.double().sum(), r.double().sum())]  # partials: any granularity, compare the sum
        for gg, rr in pairs:
            if gg.shape != rr.shape:
                fail(f"{name} output {i}: shape {tuple(gg.shape)} against the twin's {tuple(rr.shape)}")
            err, scale = float((gg - rr).abs().max()), float(rr.abs().max())
            print(f"phase 2 {label} output {i}: max|diff| {err:.3e} max|twin| {scale:.3e} rel {err / max(scale, 1e-30):.3e}",
                  flush=True)
            if not (err <= KERNEL_RTOL * scale) or scale == 0.0:
                fail(f"{label} kernel disagrees with its twin: {err} > {KERNEL_RTOL} * {scale}")
            worst = max(worst, err)
    return worst


def agree(label, v_a, v_b):
    """Velocities (or any fields) of two runs within VEL_ATOL of max |v_b|."""
    vmax = max(float(c.abs().max()) for c in v_b)
    dv = max(float((a - b).abs().max()) for a, b in zip(v_a, v_b))
    print(f"{label}: max|dv| {dv:.3e} max|v| {vmax:.3e} rel {dv / vmax:.3e}", flush=True)
    if not dv <= VEL_ATOL * vmax:
        fail(f"{label}: velocities differ: {dv} > {VEL_ATOL} * {vmax}")


def run_cli(label, argv, word, ks, timeout=300):
    """python -m polystokes_tpu_torch.run in a process of its own from the
    repository root: exit 0 and exactly the ``word k:`` lines of ``ks``,
    each with converged=True; returns the process's stdout."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "polystokes_tpu_torch.run", *argv], cwd=here,
                         capture_output=True, text=True, timeout=timeout, check=False)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith(f"{word} ")]
    print(f"{label} (python -m polystokes_tpu_torch.run {' '.join(argv)}): rc {res.returncode}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for ln in res.stdout.splitlines():
        if ln.startswith((f"{word} ", "seeded ")):
            print(f"  {ln}", flush=True)
    if res.returncode != 0:
        fail(f"{label} exited with {res.returncode}: {res.stderr[-2000:]}")
    if [ln.split(":")[0] for ln in lines] != [f"{word} {k}" for k in ks] or \
            not all("converged=True" in ln for ln in lines):
        fail(f"{label}: expected converged lines {word} {ks}, got {lines}")
    return res.stdout

def phase_18_fallback(grid, scene, p_a, cap=1500):
    """The f32 fallback at 128^3 on Path A's system: IDENTITY PCG (JAX's
    default preconditioner) at tol 1e-5 stopped at phase 18's cap, then
    BiCGStab to the same cap; the step keeps BiCGStab's x only where it is
    finite and its true residual no larger than PCG's (solver._fallback,
    whose inputs a wrapper reads: three more applies, counted in the
    launches)."""
    from polystokes_tpu_torch import PreconditionerType
    from polystokes_tpu_torch import solver
    from polystokes_tpu_torch import packed_apply as pa

    seen = {}
    orig_fallback = solver._fallback

    def fallback_spy(apply_k, b_k, pcg_res, fb):
        def resid(x):
            return float(torch.linalg.vector_norm((b_k - apply_k(x)).double()))

        seen.update(r_pcg=resid(pcg_res.x), r_fb=resid(fb.x), finite=bool(torch.isfinite(fb.x).all()),
                    pcg_passes=pcg_res.passes, fb_passes=fb.passes, fb_iterations=fb.iterations, fb_error=fb.error,
                    fb_max=float(fb.x.abs().max()))
        res, kept = orig_fallback(apply_k, b_k, pcg_res, fb)
        seen["r_kept"] = resid(res.x)
        return res, kept

    p_fb = p_a.replace(bicgstab_fallback=True, preconditioner=PreconditionerType.IDENTITY, tolerance=1e-5,
                       max_iterations=cap)
    solver._fallback = fallback_spy
    try:
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v_f, _, st_f = solver.step(grid, scene, p_fb)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        solver._fallback = orig_fallback
    launches = dict(pa.LAUNCHES)
    finite = all(bool(torch.isfinite(c).all()) for c in v_f)
    print(f"phase 18 fallback {N_MAIN}^3 f32 (IDENTITY PCG, tol 1e-5, at most {cap} iterations each): {seconds:.3f} s, "
          f"kept {st_f['fallback_kept']}, iterations {st_f['iterations']}, error {st_f['error']:.3e}, converged "
          f"{st_f['converged']}; PCG's |b - A x| {seen.get('r_pcg', float('nan')):.6e}, BiCGStab's "
          f"{seen.get('r_fb', float('nan')):.6e} (finite {seen.get('finite')}, max|x| {seen.get('fb_max', 0.0):.4e}, "
          f"its iterations {seen.get('fb_iterations')}, error {seen.get('fb_error', float('nan')):.3e}), the kept x's "
          f"{seen.get('r_kept', float('nan')):.6e}; velocities finite {finite}, max|v| "
          f"{max(float(c.abs().max()) for c in v_f):.4e}; launches {launches}", flush=True)
    if not seen:
        fail(f"phase 18: PCG converged within {cap} iterations, so the fallback did not run")
    want_kept = "bicgstab" if seen["finite"] and seen["r_fb"] <= seen["r_pcg"] else "pcg"
    if not (finite and st_f["fallback_kept"] == want_kept and seen["r_kept"] <= seen["r_pcg"]):
        fail(f"phase 18: the fallback wrote back a result worse than PCG's or not finite: {seen}, {st_f}")
    want = sum_launches(expected_launches("A", 1 + seen["pcg_passes"]),
                        expected_launches("BiCGStab", 1 + 3 * seen["fb_passes"] + 2 + 3))
    if launches != want:
        fail(f"phase 18 fallback {N_MAIN}^3: launches {launches}, expected {want}")


# -- phases 22-24: FLIP, MULTIGRID and the host connected components, each a
# function of the main path's 128^3 scene and parameters (phase 2's grid and
# scene, phase 14's A_t parameters, phase 2's A)
FLIP_FRAMES = 2  # 3 before phases 25-26 took their time
MG_CHEAP = dict(mg_levels=3, mg_smooth_degree=2, mg_coarse_iters=2)  # phase 23's card-against-CPU cycle
N_MG = N_21  # phase 23's card-against-CPU size (32 before phases 25-26 took their time)
FLIP_PARTS = ("p2g", "surface_from_particles", "step", "g2p_flip", "advect_particles", "reseed")


def sum_launches(*counts):
    return {name: sum(c[name] for c in counts) for name in COUNTERS}


def flip_run(label, grid, scene, p, frames, record):
    """simulate_flip (its defaults: 2^20 slots, reseeding on) for ``frames``
    frames.  Each frame's step is preflighted by check_pallas on the
    frame's own scene (the particle surface), so a frame whose liquid
    reaches the index-0 planes runs unpacked and says so.  Per frame: the
    stats, the launches (counters set to 0 before the frame), the wall and
    its split over P2G, the surface rebuilds, the solve, G2P, the
    advection and the reseed (synchronised host clocks around each
    call), the particles alive and the peak device memory."""
    import warnings

    from polystokes_tpu_torch import flip, solver
    from polystokes_tpu_torch import packed_apply as pa

    originals = {name: getattr(flip, name) for name in FLIP_PARTS}
    spent = dict.fromkeys(FLIP_PARTS + ("preflight",), 0.0)
    fired = []

    def timed(name):
        fn = originals[name]

        def wrapper(*args, **kw):
            if name == "step":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    q = solver.check_pallas(args[0], args[1], args[2])
                fired.append(q != args[2])
                args = args[:2] + (q,) + args[3:]
                spent["preflight"] += time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out

        return wrapper

    rec, clock = [], [0.0]

    def after_frame(k, sc, st, stats):
        torch.cuda.synchronize()
        rec.append({"frame": k, "stats": dict(stats), "launches": dict(pa.LAUNCHES), "fired": fired[-1],
                    "wall": time.perf_counter() - clock[0], "spent": dict(spent), "alive": int(st.alive.sum()),
                    "peak": torch.cuda.max_memory_allocated(),
                    "finite": all(bool(torch.isfinite(t).all()) for t in sc.velocity + (st.pos, st.vel))})
        spent.update(dict.fromkeys(spent, 0.0))
        pa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        clock[0] = time.perf_counter()

    for name in FLIP_PARTS:
        setattr(flip, name, timed(name))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seeded = flip.seed_particles(grid, scene.surface_sdf, 1 << 20, dtype=p.dtype)
        torch.cuda.synchronize()
        print(f"phase 22 {label}: seeded {int(seeded.alive.sum())} / {1 << 20} particles "
              f"({time.perf_counter() - t0:.3f} s)", flush=True)
        pa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        clock[0] = time.perf_counter()
        out, state, _ = flip.simulate_flip(grid, scene, p, frames, callback=after_frame)
    finally:
        for name in FLIP_PARTS:
            setattr(flip, name, originals[name])
    for r in rec:
        st, sp = r["stats"], r["spent"]
        print(f"phase 22 {label} frame {r['frame']}: iterations {st['iterations']}, error {st['error']:.3e}, converged "
              f"{st['converged']}, n_regions {st['n_regions']}, unpacked fallback fired {r['fired']}, particles alive "
              f"{r['alive']}, frame {r['wall']:.3f} s: P2G {sp['p2g']:.3f}, surface {sp['surface_from_particles']:.3f}, "
              f"preflight {sp['preflight']:.3f}, solve {sp['step']:.3f}, G2P {sp['g2p_flip']:.3f}, advection "
              f"{sp['advect_particles']:.3f}, reseed {sp['reseed']:.3f} s; capture {st['capture_seconds']:.3f} s; peak "
              f"device memory {r['peak'] / 2**30:.3f} GiB; launches {r['launches']}", flush=True)
        if not (st["converged"] and st["error"] < 1e-3 and r["finite"]):
            fail(f"phase 22 {label} frame {r['frame']} did not converge cleanly or is not finite: {st}")
        want = dict.fromkeys(COUNTERS, 0) if r["fired"] else expected_launches("A_t", 1 + st["loop_passes"])
        if r["launches"] != want:
            fail(f"phase 22 {label} frame {r['frame']}: launches {r['launches']}, expected {want}")
        if not r["fired"] and st["boundary_active"] != 0:
            fail(f"phase 22 {label} frame {r['frame']}: a packed frame with active DOFs on the index-0 planes")
        for name, n in r["launches"].items():
            if n and record is not None:
                record[name]["launches_by_path"].setdefault(f"flip_{label}", []).append(n)
    return out, state, rec


def phase_22_flip(grid, scene, p_t, table, p32t):
    """FLIP (flip.simulate_flip, the CLI's --flip) on honey_coil 128^3 with
    A_t's packed parameters, twice, bit-equal; the CLI at 64^3; one frame at
    32^3 on the card against the CPU port."""
    import dataclasses
    import warnings

    from polystokes_tpu_torch import flip, solver
    from polystokes_tpu_torch.scenes.builders import honey_coil

    p = solver.sample_density(scene, p_t)
    out1, st1, rec1 = flip_run("A_t", grid, scene, p, FLIP_FRAMES, table)
    out2, st2, rec2 = flip_run("A_t again", grid, scene, p, FLIP_FRAMES, None)
    its1 = [r["stats"]["iterations"] for r in rec1]
    its2 = [r["stats"]["iterations"] for r in rec2]
    same = all(torch.equal(a, b) for a, b in zip(out1.velocity + (st1.pos, st1.vel, st1.alive),
                                                  out2.velocity + (st2.pos, st2.vel, st2.alive)))
    print(f"phase 22 iterations per frame {its1} and {its2}; the repeat bit-equal (velocities, pos, vel, alive) "
          f"{same}", flush=True)
    if not (its1 == its2 and same):
        fail("phase 22: two FLIP runs from the same scene differ")
    del out1, out2, st1, st2
    torch.cuda.empty_cache()
    base = ["--scene", "honey_coil", "--n", "64", "--flip", "262144", "--steps", "2"]
    for label, argv in (("default", base), ("pallas", base + ["--pallas"])):
        text = run_cli(f"phase 22 CLI --flip {label}", argv, "frame", (0, 1))
        if "seeded " not in text:
            fail(f"phase 22 CLI --flip {label}: no seeded line")
    # one frame at 32^3, tol 1e-5, on the card against the CPU port
    vel = {}
    for where in ("cuda", "cpu"):
        g32, s32 = honey_coil(n=N_CPU, dtype=torch.float32, device=where)
        state = flip.seed_particles(g32, s32.surface_sdf, 1 << 16)
        surf = flip.surface_from_particles(state, g32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            q = solver.check_pallas(g32, dataclasses.replace(s32, surface_sdf=surf), p32t)
        t0 = time.perf_counter()
        o32, st32, stats = flip.flip_frame(g32, s32, state, q, do_reseed=True, frame_idx=0)
        print(f"phase 22 FLIP frame {N_CPU}^3 on {where}: {time.perf_counter() - t0:.2f} s, iterations "
              f"{stats['iterations']}, error {stats['error']:.3e}, converged {stats['converged']}, unpacked fallback "
              f"fired {q != p32t}, particles alive {int(st32.alive.sum())}", flush=True)
        if not stats["converged"]:
            fail(f"phase 22: the {N_CPU}^3 FLIP frame on {where} did not converge")
        vel[where] = [t.double().cpu() for t in o32.velocity]
    agree(f"phase 22 FLIP frame {N_CPU}^3 velocities, card against CPU", vel["cuda"], vel["cpu"])
    return rec1


def phase_23_multigrid(grid, scene, p_t, table, u_t=None):
    """MULTIGRID (unpacked, as JAX runs it) on honey_coil 128^3 tiled: warm
    and timed, converged, graphed, bit-equal, no kernel launched; 32^3
    card against CPU; --precond multigrid through the CLI."""
    from polystokes_tpu_torch import PreconditionerType, solver
    from polystokes_tpu_torch import packed_apply as pa
    from polystokes_tpu_torch.scenes.builders import honey_coil

    p_mg = p_t.replace(preconditioner=PreconditionerType.MULTIGRID, use_pallas=False)
    if solver._use_packed(grid, p_mg.replace(use_pallas=True)):
        fail("phase 23: MULTIGRID would run packed")
    runs = []
    for run in ("warm", "timed"):
        pa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vel, _, st = solver.step(grid, scene, p_mg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(pa.LAUNCHES)
        ms = 1e3 * seconds / st["operator_applies"]
        print(f"phase 23 MULTIGRID {N_MAIN}^3 tile {TILE} {run}: {seconds:.3f} s, iterations {st['iterations']}, error "
              f"{st['error']:.3e}, converged {st['converged']}, n_regions {st['n_regions']}, applies "
              f"{st['operator_applies']}, loop passes {st['loop_passes']}, ms per apply (step wall / applies, the "
              f"V-cycle included) {ms:.4f}, capture {st['capture_seconds']:.3f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches {launches}", flush=True)
        if not (st["converged"] and st["error"] < 1e-3):
            fail(f"phase 23 MULTIGRID {run} did not converge: {st}")
        if any(launches.values()):
            fail(f"phase 23: the MULTIGRID step launched hand-written kernels: {launches}")
        if not st["capture_seconds"] > 0.0:
            fail("phase 23: the MULTIGRID loop was not captured as a CUDA graph")
        if not all(bool(torch.isfinite(c).all()) for c in vel):
            fail("phase 23: non-finite velocities")
        runs.append((vel, st, ms))
    (v1, s1, ms1), (v2, s2, ms2) = runs
    same = all(torch.equal(a, b) for a, b in zip(v1, v2))
    beside = "" if u_t is None else (f"; U_t (the same system unpacked with CELL_ARROW, phase 20): "
                                     f"{u_t['iterations']} iterations at {u_t['ms_per_apply']:.4f} ms per apply")
    print(f"phase 23 MULTIGRID reproducible: iterations {s1['iterations']} and {s2['iterations']}, velocities "
          f"bit-equal {same}; ms per apply {ms1:.4f} and {ms2:.4f}{beside}", flush=True)
    if not (same and s1["iterations"] == s2["iterations"]):
        fail("phase 23: two MULTIGRID steps on the same inputs differ")
    for name in table:
        table[name]["launches_by_path"]["MG"] = 0
    del runs, v1, v2
    # N_MG^3 card against CPU, both converged at tol 1e-5, with the JAX
    # tests' cheaper cycle (MG_CHEAP): the default cycle costs the CPU 0.13 s
    # an iteration at 32^3, for 900 iterations.  Unconverged, the two part by
    # more than the bound (0.4 % of max |v| after 200 iterations): the f32
    # hash noise of the power iteration follows sin's last bits, which the
    # card and the CPU round otherwise, so lambda_max and the cycle differ
    p32m = p_mg.replace(tile_size=TILE_8, tolerance=1e-5, max_iterations=20000, **MG_CHEAP)
    vel = {}
    for where in ("cuda", "cpu"):
        g32, s32 = honey_coil(n=N_MG, dtype=torch.float32, device=where)
        t0 = time.perf_counter()
        v32, _, st32 = solver.step(g32, s32, p32m)
        print(f"phase 23 MULTIGRID {N_MG}^3 tile {TILE_8} {MG_CHEAP} on {where}: {time.perf_counter() - t0:.2f} s, "
              f"iterations {st32['iterations']}, error {st32['error']:.3e}, converged {st32['converged']}", flush=True)
        if not st32["converged"]:
            fail(f"phase 23: the {N_MG}^3 MULTIGRID step on {where} did not converge")
        vel[where] = [t.double().cpu() for t in v32]
    agree(f"phase 23 MULTIGRID {N_MG}^3 velocities, card against CPU", vel["cuda"], vel["cpu"])
    run_cli("phase 23 CLI --precond multigrid", ["--scene", "honey_coil", "--n", "32", "--precond", "multigrid"],
            "step", (0,))
    return s1, ms1, ms2


def phase_24_host_cc(grid, scene, p_a, table):
    """The untiled packed step A with the host connected components
    (cc_host_callback=True): the device propagation's partition and
    n_regions, converged, A's launches; host CC ms against device CC ms."""
    from polystokes_tpu_torch import classify, native, solver
    from polystokes_tpu_torch import packed_apply as pa

    p_h = p_a.replace(cc_host_callback=True)
    lib = native.build()
    print(f"phase 24 the host union-find: {lib} (g++ {'found' if lib else 'missing: the scipy form'})", flush=True)
    lw, fw = solver._weights(grid, scene, p_a)
    c_dev = classify.classify(grid, lw, fw, p_a)
    c_host = classify.classify(grid, lw, fw, p_h)
    a, b = c_host.cell_region.cpu().numpy(), c_dev.cell_region.cpu().numpy()
    n_pairs = len(set(zip(a[a >= 0].tolist(), b[a >= 0].tolist())))
    same = bool(((a >= 0) == (b >= 0)).all()) and n_pairs == int(c_dev.n_regions) == int(c_host.n_regions)
    labels_equal = torch.equal(c_host.cell_labels, c_dev.cell_labels)
    print(f"phase 24 host against device CC at {N_MAIN}^3 untiled: n_regions {int(c_host.n_regions)} and "
          f"{int(c_dev.n_regions)}, the same partition {same}, the same labels {labels_equal}", flush=True)
    if not (same and labels_equal):
        fail("phase 24: the host connected components differ from the device's")
    # the two CC forms alone on the classification's REDUCED cells
    cells = classify.construct_reduced_regions(classify.classify_cells(lw, fw), lw, p_a)
    times = {}
    for label, fn in (("host", lambda: classify.connected_components_host(cells, lw)),
                      ("device", lambda: classify.connected_components(cells, lw, sum(grid.res)))):
        fn()
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        times[label] = statistics.median(ts)
    print(f"phase 24 connected components at {N_MAIN}^3 untiled (median of 3, host clock, the transfers included): "
          f"host {times['host']:.3f} ms, device {times['device']:.3f} ms", flush=True)
    del c_dev, c_host, cells, lw, fw
    pa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vel, _, st = solver.step(grid, scene, p_h)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(pa.LAUNCHES)
    print(f"phase 24 step A with cc_host_callback {N_MAIN}^3: {seconds:.3f} s, iterations {st['iterations']}, error "
          f"{st['error']:.3e}, converged {st['converged']}, n_regions {st['n_regions']}, launches {launches}", flush=True)
    if not (st["converged"] and st["error"] < 1e-3 and st["boundary_active"] == 0):
        fail(f"phase 24: the host-CC step did not converge cleanly: {st}")
    want = expected_launches("A", 1 + st["loop_passes"])
    if launches != want:
        fail(f"phase 24: launches {launches}, expected {want}")
    for name, n in launches.items():
        if n:
            table[name]["launches_by_path"]["A_host_cc"] = n
    return times


# -- phase 28: the host surfaces (export, host_solve, viz) on the card's
# assembled state
P28_ATOL = 1e-12  # (a) card against CPU in fp64: each block's values and each vector, times its max
APPLY_RTOL = 1e-5  # (b) the exported Schur operator against the kernels' applies in f32, times max |S x|
N_EXPORT = 64  # (b)'s resolution: the CLI's default n
BLOCKS_28 = ("G", "JG", "Dt", "JDt", "Mc", "McInv", "u", "uInv", "Mr", "BInv", "B", "uRed", "uInvRed", "JDtRed")
EIGEN_SCHEMES = ("all_dofs", "pressure_velocity", "all_dofs_explicit_interior_stress")


def peak_rss_gib() -> float:
    """The process's peak resident set (ru_maxrss: KiB on Linux)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def region_fill(ops) -> int:
    """Sum over regions of (DOF columns their reduced rows touch)^2: the
    entries that ExplicitOperators.schur_matrix's dense region blocks hold
    (an upper bound of their union)."""
    import scipy.sparse as sp

    if not ops.R:
        return 0
    jgd = sp.hstack([ops.JG(), ops.JDt()]).tocoo()
    touched = sp.csr_matrix((np.ones(jgd.nnz, np.int32), (jgd.row // ops.D, jgd.col)),
                            shape=(ops.R, jgd.shape[1]))  # duplicates summed: one entry per column
    counts = np.diff(touched.indptr).astype(np.int64)
    return int(np.sum(counts * counts))


def same_sparse(a, b):
    """(identical sparsity after sum_duplicates and sorting, max |diff| over
    max |a|) of two scipy sparse matrices."""
    import scipy.sparse as sp

    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    for m in (a, b):
        m.sum_duplicates()
        m.sort_indices()
    same = a.shape == b.shape and np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
    scale = float(np.abs(a.data).max()) if a.nnz else 0.0
    rel = float(np.abs(a.data - b.data).max(initial=0.0)) / scale if same and scale else 0.0
    return same, rel


def phase_28_export(grid, scene, cls, asm, p_a, table):
    """The host surfaces on the card: (d)'s CLI processes start first and
    run beside (a)-(c); every check fails the run."""
    from polystokes_tpu_torch import export as ex
    from polystokes_tpu_torch import packed_apply as pa
    from polystokes_tpu_torch import solver
    from polystokes_tpu_torch.classify import effective_max_regions
    from polystokes_tpu_torch.scenes.builders import honey_coil

    t28 = time.perf_counter()
    dev = scene.surface_sdf.device
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="phase28_")
    print(f"phase 28 peak RSS before the phase: {peak_rss_gib():.2f} GiB", flush=True)

    # (d) the CLI, each run a process of its own, started now
    cli = [("eigen pressure_stress 32^3", ["--n", "32", "--fp64", "--solver", "eigen"], "scheme=pressure_stress", [])]
    cli += [(f"eigen {sc} 16^3", ["--n", "16", "--fp64", "--solver", "eigen", "--scheme", sc], f"scheme={sc}", [])
            for sc in EIGEN_SCHEMES]
    cli += [("export viz pallas 64^3", ["--n", "64", "--export-prefix", f"{tmp}/x.", "--viz", "--pallas"], "iters=",
             ["x.grids.npz", "x.components.npz", "x.stats.json", "x.grids_a2.png"]),
            ("export mtx 16^3", ["--n", "16", "--export-mtx", "--export-prefix", f"{tmp}/m."], "iters=",
             ["m.grids.npz", "m.stats.json", "m.Mat_G.mtx", "m.Mat_JDt.mtx", "m.Vec_stressRHS.mtx"])]
    procs, exited = [], {}
    for i, (label, argv, marker, files) in enumerate(cli):
        out, err = open(os.path.join(tmp, f"cli{i}.out"), "w+"), open(os.path.join(tmp, f"cli{i}.err"), "w+")
        proc = subprocess.Popen([sys.executable, "-m", "polystokes_tpu_torch.run", *argv], cwd=here, stdout=out,
                                stderr=err, text=True)
        # a thread stamps each process's exit, so its wall is its own
        threading.Thread(target=lambda i=i, proc=proc: (proc.wait(), exited.__setitem__(i, time.perf_counter())),
                         daemon=True).start()
        procs.append((label, argv, marker, files, out, err, time.perf_counter(), proc))

    # (a) the explicit blocks from the card's assembled state against the
    # CPU port's: honey_coil 32^3, fp64, tile 8, CELL_ARROW
    p32 = params(torch.float64, 1e-3, 12000, do_tile=True, tile_size=TILE_8)
    ops32 = {}
    for where in (dev, "cpu"):
        g, s = honey_coil(n=N_CPU, dtype=torch.float64, device=where)
        lw, fw = solver._weights(g, s, p32)
        c, a = solver._setup(g, s, p32)
        ops32[str(where)] = ex.ExplicitOperators(g, c, a, p32, weights=(lw, fw), viscosity=s.viscosity)
    o_card, o_cpu = ops32[str(dev)], ops32["cpu"]
    worst = 0.0
    for name in BLOCKS_28:
        m_card, m_cpu = getattr(o_card, name)(), getattr(o_cpu, name)()
        same, rel = same_sparse(m_cpu, m_card)
        worst = max(worst, rel)
        print(f"phase 28a {name}: shape {m_card.shape}, nnz {m_card.nnz}, the same sparsity {same}, values rel {rel:.3e}",
              flush=True)
        if not (same and rel <= P28_ATOL):
            fail(f"phase 28a: block {name} from the card's state differs from the CPU's (sparsity {same}, rel {rel})")
    v_card, v_cpu = o_card.vectors(), o_cpu.vectors()
    for k in v_cpu:
        rel = float(np.abs(v_card[k] - v_cpu[k]).max(initial=0.0)) / max(float(np.abs(v_cpu[k]).max(initial=0.0)), 1e-300)
        worst = max(worst, rel)
        if not (v_card[k].shape == v_cpu[k].shape and rel <= P28_ATOL):
            fail(f"phase 28a: vector {k} from the card's state differs from the CPU's (rel {rel})")
    print(f"phase 28a {N_CPU}^3 tile {TILE_8} fp64: {len(BLOCKS_28)} blocks and {len(v_cpu)} vectors, card against "
          f"CPU, worst rel {worst:.3e} (nP {o_card.nP}, nS {o_card.nS}, R {o_card.R})", flush=True)
    del ops32, o_card, o_cpu

    # (b) the exported operator against the hand kernels on A's
    # configuration: the Schur matrix at 32^3, its factored form at 64^3 and
    # on A's 128^3 system, applied to a seeded x in the DOF order, against
    # the fused apply (kernels 4, 2, 5) and the unfused one (1, 2, 3)
    systems = []
    for n in (N_CPU, N_EXPORT):
        g, s = honey_coil(n=n, dtype=torch.float32, device=dev)
        packed_preflight(g, s, p_a, f"phase 28b {n}^3")
        systems.append((n, g, s) + solver._setup(g, s, p_a))
    systems.append((N_MAIN, grid, scene, cls, asm))
    export_times = {}
    for n, g, s, c, a in systems:
        R = effective_max_regions(g, p_a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops = ex.ExplicitOperators(g, c, a, p_a)
        t_ops = time.perf_counter() - t0
        t0 = time.perf_counter()
        op = ex.ExplicitOperators(g, c, a, p_a).schur_operator()
        t_op = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex.export_component_matrices(os.path.join(tmp, f"b{n}."), ops)
        t_npz = time.perf_counter() - t0
        npz_mib = os.path.getsize(os.path.join(tmp, f"b{n}.components.npz")) / 2**20
        fill = region_fill(ops)
        t_mat = None
        if n == N_CPU:
            t0 = time.perf_counter()
            S = ops.schur_matrix()
            t_mat = time.perf_counter() - t0
        rng = np.random.default_rng(28)
        x = rng.standard_normal(ops.nP + ops.nS).astype(np.float32).astype(np.float64)  # the card's f32 x, exactly
        sx = op @ x
        scale = float(np.abs(sx).max())
        if t_mat is not None:
            rel_mat = float(np.abs(S @ x - sx).max()) / scale
            print(f"phase 28b {n}^3 schur_matrix: nnz {S.nnz}, formed in {t_mat:.3f} s; S x against the factored "
                  f"operator rel {rel_mat:.3e}", flush=True)
            if not rel_mat <= APPLY_RTOL:
                fail(f"phase 28b {n}^3: schur_matrix and schur_operator disagree: {rel_mat}")
            del S
        xp = pa.pack_ptau(ex.ptau_from_dofs(x[:ops.nP], x[ops.nP:], ops, torch.float32, dev))
        fused = solver.make_apply_packed_pap(g, c, a, p_a, R)
        unfused = solver.make_apply_packed(g, c, a, p_a, R)
        rels = {}
        for label, fn, want in (("fused", lambda: fused(xp), {"grid_mom_pap": 1, "expand": 1, "finish": 1}),
                                ("unfused", lambda: (unfused(xp), None), {"moments": 1, "expand": 1, "apply_reduced": 1})):
            pa.reset_launches()
            ax, pap = fn()
            torch.cuda.synchronize()
            launched = {k: v for k, v in pa.LAUNCHES.items() if v}
            if launched != want:
                fail(f"phase 28b {n}^3 {label}: launches {launched}, expected {want}")
            got = np.concatenate(ex.dofs_from_ptau(pa.unpack_ptau(ax), ops)).astype(np.float64)
            rels[label] = float(np.abs(got - sx).max()) / scale
            if pap is not None:
                xsx = float(x @ sx)
                rels["pap"] = abs(float(pap) - xsx) / abs(xsx)
        export_times[n] = dict(operators=t_ops, schur_operator=t_op, components_npz=t_npz, schur_matrix=t_mat)
        print(f"phase 28b {n}^3 A (untiled, tile {TILE}, f32): nP {ops.nP}, nS {ops.nS}, R {ops.R}; ExplicitOperators "
              f"{t_ops:.3f} s, schur_operator (G, Dt, JG, JDt, McInv, BInv, uInv) {t_op:.3f} s, export_component_matrices "
              f"{t_npz:.3f} s ({npz_mib:.1f} MiB); schur_matrix's region blocks hold up to {fill} entries; exported "
              f"operator against the kernels: fused (4, 2, 5) rel {rels['fused']:.3e}, unfused (1, 2, 3) rel "
              f"{rels['unfused']:.3e}, <x, A x> rel {rels['pap']:.3e}; peak RSS {peak_rss_gib():.2f} GiB", flush=True)
        if not max(rels.values()) <= APPLY_RTOL:
            fail(f"phase 28b {n}^3: the exported operator disagrees with the kernels: {rels}")
        del ops, op, fused, unfused, xp, ax
    del systems

    # (c) warm start from an exported solution: the explicit solve at tol
    # 1e-10, export_solution, solution_guess_ptau onto the card, step from it
    g, s = honey_coil(n=N_CPU, dtype=torch.float64, device=dev)
    packed_preflight(g, s, p32, "phase 28c")

    def counted_step(label, guess=None):
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, st = solver.step(g, s, p32, initial_guess=guess)
        torch.cuda.synchronize()
        launches = dict(pa.LAUNCHES)
        want = expected_launches("A", 1 + st["loop_passes"])
        print(f"phase 28c {label} step {N_CPU}^3 tile {TILE_8} fp64: {time.perf_counter() - t0:.3f} s, iterations "
              f"{st['iterations']}, error {st['error']:.3e}, converged {st['converged']}, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        if not (st["converged"] and st["boundary_active"] == 0) or launches != want:
            fail(f"phase 28c {label}: {st}, launches {launches}, expected {want}")
        return st, launches

    cold, _ = counted_step("cold")
    c, a = solver._setup(g, s, p32)
    iters = [0]
    t0 = time.perf_counter()
    x, ops, info = ex.solve_explicit(g, c, a, p32, tol=1e-10, warm_start=False,
                                     callback=lambda _x: iters.__setitem__(0, iters[0] + 1))
    t_solve = time.perf_counter() - t0
    prefix = os.path.join(tmp, "ws.")
    ex.export_solution(prefix, ex.ptau_from_dofs(x[:ops.nP], x[ops.nP:], ops, torch.float64, dev), ops)
    guess = ex.solution_guess_ptau(prefix, ops, torch.float64)
    print(f"phase 28c solve_explicit tol 1e-10: info {info}, {iters[0]} iterations, {t_solve:.3f} s; the guess on "
          f"{guess.p.device}", flush=True)
    if info != 0 or guess.p.device != torch.device(dev):
        fail(f"phase 28c: the explicit solve failed (info {info}) or the guess is not on the card")
    warm, launches = counted_step("warm", guess)
    for name, k in launches.items():
        if k:
            table[name]["launches_by_path"]["A_warm"] = k
    if not warm["iterations"] < max(cold["iterations"] // 4, 2):
        fail(f"phase 28c: the warm step took {warm['iterations']} iterations against the cold {cold['iterations']}")
    x0 = ex.load_solution_guess(prefix, ops)
    _, _, info2 = ex.solve_explicit(g, c, a, p32, warm_start=False, x0=x0)
    print(f"phase 28c warm against cold: {warm['iterations']} against {cold['iterations']} iterations; the loaded "
          f"guess through solve_explicit: info {info2}", flush=True)
    if info2 != 0:
        fail(f"phase 28c: solve_explicit from the loaded guess returned info {info2}")
    del x, ops, guess, c, a

    # (d) the CLI processes: exit 0, converged=True, their files and lines
    for i, (label, argv, marker, files, out, err, t0, proc) in enumerate(procs):
        rc = proc.wait(timeout=600)
        while i not in exited:
            time.sleep(0.01)
        out.seek(0)
        err.seek(0)
        text = out.read()
        lines = [ln for ln in text.splitlines() if ln.startswith("step ")]
        print(f"phase 28d CLI {label} (python -m polystokes_tpu_torch.run {' '.join(argv)}): rc {rc}, process wall "
              f"{exited[i] - t0:.1f} s", flush=True)
        for ln in text.splitlines():
            if ln.startswith(("step ", "exported to", "rendered")):
                print(f"  {ln}", flush=True)
        if rc != 0:
            fail(f"phase 28d {label} exited with {rc}: {err.read()[-2000:]}")
        if len(lines) != 1 or "converged=True" not in lines[0] or marker not in lines[0]:
            fail(f"phase 28d {label}: expected one converged step line with {marker}, got {lines}")
        missing = [f for f in files if not os.path.exists(os.path.join(tmp, f))]
        if missing or (files and "exported to" not in text) or ("--viz" in argv and "rendered " not in text):
            fail(f"phase 28d {label}: missing files {missing} or the export / render lines")
        out.close()
        err.close()
    shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t28
    print(f"phase 28 wall: {wall:.1f} s", flush=True)
    return export_times, wall


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    from polystokes_tpu_torch import packed_apply as pa
    from polystokes_tpu_torch import BasisOrder, PreconditionerType, solver
    from polystokes_tpu_torch.classify import effective_max_regions
    from polystokes_tpu_torch.parallel import make_apply_packed_sharded, make_mesh, sharded_step
    from polystokes_tpu_torch.parallel.dryrun import dryrun_multichip
    from polystokes_tpu_torch.scenes.builders import honey_coil

    # -- phase 1: build
    t0 = time.perf_counter()
    path, nvcc_s, ptxas = pa.build_kernels()
    print(f"phase 1 build: {path} nvcc {nvcc_s:.1f} s (build step {time.perf_counter() - t0:.1f} s)", flush=True)
    for k in ptxas_summary(ptxas):
        print(f"  ptxas: {k['entry']}: {k['registers']} registers, {k['smem']} bytes static shared memory, "
              f"spill stores {k['spill_stores']} B, spill loads {k['spill_loads']} B", flush=True)
    uniform_plan = pa.uniform_plan((N_MAIN,) * 3)
    for dtype in (torch.float32, torch.float64):
        by, bz = pa.grid_mom_plan(TILE)
        for name in ("grid_mom_pap", "moments"):
            window, blocks = pa.window_occupancy(name, dtype, by, bz)
            blocks16 = pa.window_occupancy(name, dtype, by, bz, torch.bfloat16)[1]
            print(f"  {name} {dtype} at tile {TILE}: column {by} x {bz}, "
                  f"{window} bytes dynamic shared memory, {blocks} blocks per SM ({blocks16} with the bf16 stack)",
                  flush=True)
        for name in ("apply_reduced", "apply_uniform", "apply_uniform_pap"):
            window, blocks = pa.window_occupancy(name, dtype, *uniform_plan[:2])
            blocks16 = pa.window_occupancy(name, dtype, *uniform_plan[:2], torch.bfloat16)[1]
            print(f"  {name} {dtype} at {N_MAIN}^3: column {uniform_plan[0]} x {uniform_plan[1]}, run "
                  f"{uniform_plan[2]}, {window} bytes dynamic shared memory, {blocks} blocks per SM ({blocks16} with "
                  f"the bf16 stack)", flush=True)

    # -- phase 2: each kernel against its twin at the main-path shapes
    t0 = time.perf_counter()
    grid, scene = honey_coil(n=N_MAIN, dtype=torch.float32, device=dev)
    p_a = params(torch.float32, 1e-3, 12000, fuse_pap=True)
    p_b = p_a.replace(do_reduced_regions=False)
    cls, asm = solver._setup(grid, scene, p_a)
    cls_u, asm_u = solver._setup(grid, scene, p_b)
    R = effective_max_regions(grid, p_a)
    coeffs, coeffs_u = pa.pack_coeffs(asm, cls), pa.pack_coeffs(asm_u)
    algebra, red = solver._region_algebra_packed(grid, cls, asm, p_a, R)
    gen = torch.Generator(device=dev).manual_seed(0)
    mask, mask_u = pa.packed_masks(cls, torch.float32), pa.packed_masks(cls_u, torch.float32)
    xp = (torch.randn((7,) + grid.res, generator=gen, device=dev) * mask).contiguous()
    xu = (torch.randn((7,) + grid.res, generator=gen, device=dev) * mask_u).contiguous()
    torch.cuda.synchronize()
    print(f"phase 2 setup {N_MAIN}^3 (reduced and uniform): {time.perf_counter() - t0:.2f} s, n_regions {int(cls.n_regions)}, "
          f"stacks {coeffs.shape[0]} and {coeffs_u.shape[0]} channels", flush=True)

    mom_twin = pa.moments_packed_plain(xp, coeffs, TILE)
    v = algebra(mom_twin)
    u_twin = pa.expand_packed_plain(v, red, TILE)
    out_grid = pa.grid_mom_pap_packed_plain(xp, coeffs, TILE)[0]
    s_twin = pa.forward_s_packed_plain(xp, coeffs)
    plane = xp[0].numel()
    mom_bytes = mom_twin.numel() * mom_twin.element_size()
    cases = {
        "moments": (lambda: pa.moments_packed(xp, coeffs, TILE), lambda: pa.moments_packed_plain(xp, coeffs, TILE),
                    mom_bytes),
        "expand": (lambda: pa.expand_packed(v, red, TILE), lambda: pa.expand_packed_plain(v, red, TILE), mom_bytes),
        "apply_reduced": (lambda: pa.apply_reduced_packed(xp, coeffs, u_twin),
                          lambda: pa.apply_reduced_packed_plain(xp, coeffs, u_twin), 0),
        "grid_mom_pap": (lambda: pa.grid_mom_pap_packed(xp, coeffs, TILE),
                         lambda: pa.grid_mom_pap_packed_plain(xp, coeffs, TILE), 2 * mom_bytes),
        "finish": (lambda: pa.finish_packed(coeffs, out_grid, u_twin),
                   lambda: pa.finish_packed_plain(coeffs, out_grid, u_twin), 0),
        "apply_uniform_pap": (lambda: pa.apply_uniform_pap_packed(xu, coeffs_u),
                              lambda: pa.apply_uniform_pap_packed_plain(xu, coeffs_u), 0),
        "apply_uniform": (lambda: pa.apply_uniform_packed(xu, coeffs_u),
                          lambda: pa.apply_uniform_packed_plain(xu, coeffs_u), 0),
        "transpose_u": (lambda: pa.transpose_u_packed(coeffs, u_twin),
                        lambda: pa.transpose_u_packed_plain(coeffs, u_twin), 0),
        "forward_s": (lambda: pa.forward_s_packed(xp, coeffs), lambda: pa.forward_s_packed_plain(xp, coeffs), 0),
        "combine": (lambda: pa.combine_packed(xp, coeffs, s_twin, u_twin),
                    lambda: pa.combine_packed_plain(xp, coeffs, s_twin, u_twin), 0),
    }
    def measure(name, kernel, twin, small_bytes, kind=None, slots=plane, where="", stored_itemsize=None, slots_in=None):
        """Compare a kernel with its twin, time both and reckon its bound
        over ``slots`` slots of each channel (the coefficient channels at
        ``stored_itemsize`` bytes a value where given; each input channel
        over ``slots_in`` slots where given: a halo form's padded slab)."""
        label = (name if kind is None else f"{name} kind {kind}") + where
        got, ref = kernel(), twin()
        torch.cuda.synchronize()
        err = compare(name, got, ref, label)
        ms_twin = median_ms(twin)
        ms_kernel = median_ms(kernel)
        ms_device = graph_ms(kernel)
        bound_ms, bound_by = bound(name, slots, small_bytes, xp.element_size(), kind or "arrow", stored_itemsize,
                                   slots_in)
        print(f"phase 2 {label}: kernel {ms_kernel:.4f} ms (device {ms_device:.4f} ms) twin {ms_twin:.4f} ms "
              f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms_kernel:.1f} % of the bound "
              f"({100 * bound_ms / ms_device:.1f} % on device time)", flush=True)
        return {"max_abs_err": err, "ms": ms_kernel, "device_ms": ms_device, "plain_ms": ms_twin, "bound_ms": bound_ms,
                "bound_by": bound_by}

    table = {}
    for name, (kernel, twin, small_bytes) in cases.items():
        src, replaces = KERNELS[name][:2]
        table[name] = {"name": name, "route": "cuda", "source": f"polystokes_tpu_torch/csrc/{src}", "replaces": replaces,
                       "launches": None, **measure(name, kernel, twin, small_bytes), "library_ms": None,
                       "launches_by_path": {}}

    # the apply kernels at each geometry of the sweep and the moments at
    # each column (device time)
    sweeps = {"apply_uniform": lambda geo: pa._apply_uniform_cuda(xu, coeffs_u, *geo, pap=False),
              "apply_uniform_pap": lambda geo: pa._apply_uniform_cuda(xu, coeffs_u, *geo, pap=True),
              "apply_reduced": lambda geo: pa._apply_reduced_cuda(xp, coeffs, u_twin, *geo)}
    for geo in UNIFORM_GEOMETRIES:
        for name, run in sweeps.items():
            ms = graph_ms(lambda: run(geo))
            print(f"phase 2 {name} geometry (by, bz, L) {geo}: device {ms:.4f} ms, "
                  f"{100 * table[name]['bound_ms'] / ms:.1f} % of the bound"
                  f"{' (the plan)' if geo == pa.uniform_plan(grid.res) else ''}", flush=True)
    for col in MOMENT_COLUMNS:
        ms = graph_ms(lambda: pa._moments_cuda(xp, coeffs, TILE, *col))
        print(f"phase 2 moments column (by, bz) {col} at tile {TILE}: device {ms:.4f} ms, "
              f"{100 * table['moments']['bound_ms'] / ms:.1f} % of the bound"
              f"{' (the plan)' if col == pa.grid_mom_plan(TILE) else ''}", flush=True)

    # the update kernels: kernel 9 with every preconditioner kind, 10 and 11
    # with arrow and none, on the real CELL_ARROW and DIAGONAL factors; the
    # table's numbers are the arrow kind's, the kind of every path driven
    gen_u = torch.Generator(device=dev).manual_seed(1)
    rp, pp = ((torch.randn((7,) + grid.res, generator=gen_u, device=dev) * mask).contiguous() for _ in range(2))
    alpha = torch.tensor(0.37, device=dev)
    factors = {"arrow": pa.pack_arrow_factors(solver.precond_factors_packed(grid, cls, asm, p_a)),
               "diag": solver.precond_factors_packed(grid, cls, asm, p_a.replace(
                   preconditioner=PreconditionerType.DIAGONAL))["inv_packed"],
               "none": None}
    for kind, f in factors.items():
        runs = [("cg_update", lambda f=f, k=kind: pa.cg_update_packed(xp, rp, pp, out_grid, alpha, f, k),
                 lambda f=f, k=kind: pa.cg_update_packed_plain(xp, rp, pp, out_grid, alpha, f, k), 0)]
        if kind != "diag":
            runs += [
                ("finish_update", lambda f=f, k=kind: pa.finish_update_packed(xp, rp, pp, alpha, coeffs, out_grid, u_twin, f, k),
                 lambda f=f, k=kind: pa.finish_update_packed_plain(xp, rp, pp, alpha, coeffs, out_grid, u_twin, f, k), 0),
                ("exp_finish_update",
                 lambda f=f, k=kind: pa.exp_finish_update_packed(xp, rp, pp, alpha, coeffs, out_grid, v, TILE, f, k),
                 lambda f=f, k=kind: pa.exp_finish_update_packed_plain(xp, rp, pp, alpha, coeffs, out_grid, v, TILE, f, k),
                 mom_bytes),
            ]
        for name, kernel, twin, small_bytes in runs:
            m = measure(name, kernel, twin, small_bytes, kind)
            if name not in table:
                src, replaces = KERNELS[name][:2]
                table[name] = {"name": name, "route": "cuda", "source": f"polystokes_tpu_torch/csrc/{src}",
                               "replaces": replaces, "launches": None, **m, "library_ms": None,
                               "launches_by_path": {}, "kinds": {}}
            table[name]["kinds"][kind] = m

    # the K = 4 forms of the kernels that read the basis (the affine basis:
    # 12 moments and coefficients a cube), on the same inputs; the affine
    # coefficients are the first four monomials of each axis of v.  Bounds:
    # the same channels, the smaller per-cube arrays, the quadratic form's
    # flop count (the bytes bound either way)
    aff = BasisOrder.AFFINE

    def affine_v(v10):
        return torch.cat([v10[:, :, 10 * a:10 * a + 4] for a in range(3)], dim=2).contiguous()

    def affine_cases(x_, c_, v_, red_, og_, r_, p_, f_, t_):
        """(kernel, twin, per-cube bytes) of each K = 4 form at tile t_."""
        mb = v_.numel() * v_.element_size()
        return {
            "moments": (lambda: pa.moments_packed(x_, c_, t_, aff), lambda: pa.moments_packed_plain(x_, c_, t_, aff), mb),
            "expand": (lambda: pa.expand_packed(v_, red_, t_, aff), lambda: pa.expand_packed_plain(v_, red_, t_, aff), mb),
            "grid_mom_pap": (lambda: pa.grid_mom_pap_packed(x_, c_, t_, aff),
                             lambda: pa.grid_mom_pap_packed_plain(x_, c_, t_, aff), 2 * mb),
            "exp_finish_update": (
                lambda: pa.exp_finish_update_packed(x_, r_, p_, alpha, c_, og_, v_, t_, f_, "arrow", basis=aff),
                lambda: pa.exp_finish_update_packed_plain(x_, r_, p_, alpha, c_, og_, v_, t_, f_, "arrow", aff), mb),
        }

    for name, (kernel, twin, small_bytes) in affine_cases(xp, coeffs, affine_v(v), red, out_grid, rp, pp,
                                                          factors["arrow"], TILE).items():
        src, replaces = KERNELS[name][:2]
        table[name + K4] = {"name": name + K4, "route": "cuda", "source": f"polystokes_tpu_torch/csrc/{src}",
                            "replaces": replaces, "basis": "affine (K = 4)", "launches": None,
                            **measure(name, kernel, twin, small_bytes, "arrow" if name == "exp_finish_update" else None,
                                      where=" affine K=4"),
                            "library_ms": None, "launches_by_path": {}}
    del rp, pp, factors, kernel, twin  # the last lambdas hold their inputs

    # the tile-dependent kernels at tile 8, on the tiled armadillo_melt_si
    # 256^3 setup of phase 14's S8, kind arrow on its CELL_ARROW factors
    from polystokes_tpu_torch.scenes.builders import armadillo_melt_si

    grid_si, scene_si = armadillo_melt_si(n=N_SI, dtype=torch.float32, device=dev)
    # the constant density of the scene's field (1000), set through
    # solver.sample_density as the JAX suite sets it (benchmarks/suite.py:64);
    # step does not read the field
    p_s8 = solver.sample_density(scene_si, params(torch.float32, 1e-3, 12000, fuse_pap=True, do_tile=True,
                                                  tile_size=TILE_8))
    print(f"phase 2 armadillo_melt_si density through sample_density: {p_s8.constant_density}", flush=True)
    t0 = time.perf_counter()
    cls8, asm8 = solver._setup(grid_si, scene_si, p_s8)
    coeffs8 = pa.pack_coeffs(asm8, cls8)
    algebra8, red8 = solver._region_algebra_packed(grid_si, cls8, asm8, p_s8, effective_max_regions(grid_si, p_s8))
    f8 = pa.pack_arrow_factors(solver.precond_factors_packed(grid_si, cls8, asm8, p_s8))
    mask8 = pa.packed_masks(cls8, torch.float32)
    gen8 = torch.Generator(device=dev).manual_seed(2)
    x8, r8, q8 = ((torch.randn((7,) + grid_si.res, generator=gen8, device=dev) * mask8).contiguous() for _ in range(3))
    v8 = algebra8(pa.moments_packed_plain(x8, coeffs8, TILE_8))
    og8 = pa.grid_mom_pap_packed_plain(x8, coeffs8, TILE_8)[0]
    torch.cuda.synchronize()
    print(f"phase 2 setup {N_SI}^3 tile {TILE_8} (armadillo_melt_si, tiled): {time.perf_counter() - t0:.2f} s, "
          f"n_regions {int(cls8.n_regions)}, R {effective_max_regions(grid_si, p_s8)}", flush=True)
    mom8 = v8.numel() * v8.element_size()
    cases8 = {
        "moments": (lambda: pa.moments_packed(x8, coeffs8, TILE_8), lambda: pa.moments_packed_plain(x8, coeffs8, TILE_8),
                    mom8),
        "expand": (lambda: pa.expand_packed(v8, red8, TILE_8), lambda: pa.expand_packed_plain(v8, red8, TILE_8), mom8),
        "grid_mom_pap": (lambda: pa.grid_mom_pap_packed(x8, coeffs8, TILE_8),
                         lambda: pa.grid_mom_pap_packed_plain(x8, coeffs8, TILE_8), 2 * mom8),
        "exp_finish_update": (
            lambda: pa.exp_finish_update_packed(x8, r8, q8, alpha, coeffs8, og8, v8, TILE_8, f8, "arrow"),
            lambda: pa.exp_finish_update_packed_plain(x8, r8, q8, alpha, coeffs8, og8, v8, TILE_8, f8, "arrow"), mom8),
    }
    for name, (kernel, twin, small_bytes) in cases8.items():
        m = measure(name, kernel, twin, small_bytes, "arrow" if name == "exp_finish_update" else None,
                    slots=x8[0].numel(), where=f" tile {TILE_8} {N_SI}^3")
        table[name]["tile8"] = {"res": N_SI, **m}
    for name, (kernel, twin, small_bytes) in affine_cases(x8, coeffs8, affine_v(v8), red8, og8, r8, q8, f8,
                                                          TILE_8).items():
        m = measure(name, kernel, twin, small_bytes, "arrow" if name == "exp_finish_update" else None,
                    slots=x8[0].numel(), where=f" affine K=4 tile {TILE_8} {N_SI}^3")
        table[name + K4]["tile8"] = {"res": N_SI, **m}
    del cls8, asm8, coeffs8, algebra8, red8, f8, mask8, x8, r8, q8, v8, og8, cases8, kernel, twin
    torch.cuda.empty_cache()

    # -- phase 3: the applies on the card
    yp = (torch.randn((7,) + grid.res, generator=gen, device=dev) * mask).contiguous()
    yu = (torch.randn((7,) + grid.res, generator=gen, device=dev) * mask_u).contiguous()
    for label, p, x, y, c_cls, c_asm, r in (("reduced", p_a, xp, yp, cls, asm, R),
                                            ("uniform", p_b, xu, yu, cls_u, asm_u, effective_max_regions(grid, p_b))):
        apply_k = solver.make_apply_packed(grid, c_cls, c_asm, p, r)
        apply_dot = solver.make_apply_packed_pap(grid, c_cls, c_asm, p, r)
        ax, ay = apply_k(x), apply_k(y)
        y_ax = float((y.double() * ax.double()).sum())
        ay_x = float((ay.double() * x.double()).sum())
        asym = abs(y_ax - ay_x) / abs(y_ax)
        print(f"phase 3 {label} symmetry: <y,Ax> {y_ax:.9e} <Ay,x> {ay_x:.9e} rel {asym:.3e}", flush=True)
        if not asym <= SYM_RTOL:
            fail(f"{label} kernel apply is not symmetric: {asym} > {SYM_RTOL}")
        ax_f, pap_f = apply_dot(x)
        pap_u = float((x.double() * ax.double()).sum())
        d_ax = float((ax_f - ax).abs().max()) / float(ax.abs().max())
        d_pap = abs(float(pap_f) - pap_u) / abs(pap_u)
        print(f"phase 3 {label} fused against unfused: A x rel {d_ax:.3e}, <x,Ax> fused {float(pap_f):.9e} "
              f"unfused {pap_u:.9e} rel {d_pap:.3e}", flush=True)
        if not (d_ax <= KERNEL_RTOL and d_pap <= PAP_RTOL):
            fail(f"{label} fused apply_dot disagrees with the unfused apply: {d_ax}, {d_pap}")
    ar = pa.apply_reduced_packed(xp, coeffs, u_twin)
    d_comb = float((pa.combine_packed(xp, coeffs, pa.forward_s_packed(xp, coeffs), u_twin) - ar).abs().max())
    print(f"phase 3 combine(forward_s(x)) against apply_reduced: max|diff| {d_comb:.3e} max {float(ar.abs().max()):.3e}",
          flush=True)
    if not d_comb <= KERNEL_RTOL * float(ar.abs().max()):
        fail(f"combine(x, forward_s(x), u) disagrees with apply_reduced(x, u): {d_comb}")
    # the cross-checks of the shared march: moments alone against
    # grid_mom_pap's at the planned column, and the reduced apply with u = 0
    # against the uniform one at the uniform plan, on the 17-channel stack
    mom_bit = torch.equal(pa.moments_packed(xp, coeffs, TILE), pa.grid_mom_pap_packed(xp, coeffs, TILE)[1])
    print(f"phase 3 moments against grid_mom_pap's moments at column {pa.grid_mom_plan(TILE)}: bit-equal {mom_bit}",
          flush=True)
    if not mom_bit:
        fail("the moments kernel is not bit-equal to grid_mom_pap's moments at one column")
    geo = pa.uniform_plan(grid.res)
    ar0 = pa._apply_reduced_cuda(xp, coeffs, torch.zeros_like(u_twin), *geo)
    au = pa._apply_uniform_cuda(xp, coeffs, *geo, pap=False)
    d_u = float((ar0 - au).abs().max())
    print(f"phase 3 apply_reduced(x, 0) against apply_uniform(x) at {geo}: bit-equal {torch.equal(ar0, au)}, "
          f"max|diff| {d_u:.3e} max {float(au.abs().max()):.3e}", flush=True)
    if not d_u <= CROSS_RTOL * float(au.abs().max()):
        fail(f"apply_reduced(x, 0) disagrees with apply_uniform(x): {d_u}")
    p_r = p_a.replace(preconditioner=PreconditionerType.REGION_ARROW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factors_r = solver.precond_factors_packed(grid, cls, asm, p_r)
    torch.cuda.synchronize()
    print(f"phase 3 REGION_ARROW factors {N_MAIN}^3: {time.perf_counter() - t0:.3f} s", flush=True)
    m_r = solver.make_preconditioner_packed(grid, cls, asm, p_r, factors_r)
    y_mx = float((yp.double() * m_r(xp).double()).sum())
    my_x = float((m_r(yp).double() * xp.double()).sum())
    asym = abs(y_mx - my_x) / abs(y_mx)
    print(f"phase 3 REGION_ARROW solve symmetry: <y,Mx> {y_mx:.9e} <My,x> {my_x:.9e} rel {asym:.3e}", flush=True)
    if not asym <= SYM_RTOL:
        fail(f"the REGION_ARROW solve is not symmetric: {asym} > {SYM_RTOL}")

    # -- phases 4-7: the paths, each with its own launch counts
    def drive(label, p, n_check=None, case=None, mesh=None):
        """step() on ``case`` (grid, scene), honey_coil 128^3 by default;
        with ``mesh``, sharded_step's, which must take the x-slab path."""
        g, sc = case or (grid, scene)
        if p.use_pallas and not solver._use_packed(g, p):
            fail(f"{label}: use_pallas=True but the packed layout does not take this configuration")
        pa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if mesh is None:
            vel, _, stats = solver.step(g, sc, p)
        else:
            vel, _, stats = sharded_step(g, p, mesh)(sc)
            if not stats["sharded"]:
                fail(f"{label}: the solve did not take the x-slab path")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(pa.LAUNCHES)
        applies = stats["operator_applies"]
        print(f"{label}: {seconds:.3f} s, iterations {stats['iterations']}, error {stats['error']:.3e}, "
              f"converged {stats['converged']}, boundary_active {stats['boundary_active']}, "
              f"n_regions {stats['n_regions']}, applies {applies}, loop passes {stats['loop_passes']}, "
              f"ms per apply (step wall / applies) {1e3 * seconds / max(applies, 1):.4f}, peak device memory "
              f"{stats['peak_gib']:.3f} GiB, launches {launches}", flush=True)
        if not (stats["converged"] and stats["error"] < 1e-3 and stats["boundary_active"] == 0):
            fail(f"{label} did not converge cleanly: {stats}")
        if n_check is not None and not n_check(stats["n_regions"]):
            fail(f"{label}: unexpected region count {stats['n_regions']}")
        if not all(bool(torch.isfinite(c).all()) for c in vel):
            fail(f"{label}: non-finite velocities")
        stats["ms_per_apply"] = 1e3 * seconds / max(applies, 1)
        stats["seconds"] = seconds
        return vel, stats, launches

    step_ms = {}  # path: ms per apply of each timed (graphed) step

    def check_launches(path, label, stats, launches, record=True):
        want = expected_launches(path, 1 + stats["loop_passes"])
        if launches != want:
            fail(f"{label}: launches {launches}, expected {want}")
        for name, n in launches.items():
            if n and record:
                # an affine path's launches of a kernel that reads the basis
                # are its K = 4 form's
                affine = path in AFFINE_PATHS or path == "A_aff_s4"
                row = name + K4 if affine and name in BASIS_KERNELS + ("moments_halo",) else name
                table[row]["launches_by_path"][path] = n
        if record:
            step_ms.setdefault(path, []).append(stats["ms_per_apply"])

    def check_repeat(label, vel1, st1, vel2, st2):
        bit_equal = all(torch.equal(a, b) for a, b in zip(vel1, vel2))
        print(f"{label} reproducible: iterations {st1['iterations']} and {st2['iterations']}, "
              f"velocities bit-equal {bit_equal}", flush=True)
        if not (st1["iterations"] == st2["iterations"] and bit_equal):
            fail(f"{label}: two steps on the same inputs differ")

    packed_preflight(grid, scene, p_a, "phase 4")
    drive(f"phase 4 Path A {N_MAIN}^3 warm", p_a, lambda n: n >= 1)
    vel1, st1, l1 = drive(f"phase 4 Path A {N_MAIN}^3 timed 1", p_a, lambda n: n >= 1)
    vel2, st2, l2 = drive(f"phase 4 Path A {N_MAIN}^3 timed 2", p_a, lambda n: n >= 1)
    check_launches("A", "phase 4 Path A", st1, l1)
    check_launches("A", "phase 4 Path A", st2, l2)
    check_repeat("phase 4 Path A", vel1, st1, vel2, st2)
    vel_a, st_a = vel1, st1

    drive(f"phase 5 REGION_ARROW {N_MAIN}^3 warm", p_r, lambda n: n >= 1)
    vel1, sr1, l1 = drive(f"phase 5 REGION_ARROW {N_MAIN}^3 timed 1", p_r, lambda n: n >= 1)
    vel2, sr2, l2 = drive(f"phase 5 REGION_ARROW {N_MAIN}^3 timed 2", p_r, lambda n: n >= 1)
    check_launches("A_region", "phase 5 REGION_ARROW", sr1, l1)
    check_launches("A_region", "phase 5 REGION_ARROW", sr2, l2)
    check_repeat("phase 5 REGION_ARROW", vel1, sr1, vel2, sr2)
    # the step's setup, timed apart from it: weights, classify and assemble;
    # the factors of each preconditioner (REGION_ARROW's include the D probes
    # of region_schur_inv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cls_s, asm_s = solver._setup(grid, scene, p_r)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    fac_s = {}
    for label, p in (("CELL_ARROW", p_a), ("REGION_ARROW", p_r)):
        t0 = time.perf_counter()
        solver.precond_factors_packed(grid, cls_s, asm_s, p)
        torch.cuda.synchronize()
        fac_s[label] = time.perf_counter() - t0
    print(f"phase 5 setup seconds: weights, classify, assemble {t_setup:.3f}; factors CELL_ARROW "
          f"{fac_s['CELL_ARROW']:.3f}, REGION_ARROW {fac_s['REGION_ARROW']:.3f}; iterations REGION_ARROW "
          f"{sr1['iterations']} against Path A's CELL_ARROW {st1['iterations']}", flush=True)

    _, st, launches = drive(f"phase 6 fuse_pap=False {N_MAIN}^3", p_a.replace(fuse_pap=False), lambda n: n >= 1)
    check_launches("unfused", "phase 6", st, launches)
    drive(f"phase 7 Path B fuse_pap=True {N_MAIN}^3 warm", p_b, lambda n: n == 0)
    vel1, sb1, l1 = drive(f"phase 7 Path B fuse_pap=True {N_MAIN}^3 timed 1", p_b, lambda n: n == 0)
    vel2, sb2, l2 = drive(f"phase 7 Path B fuse_pap=True {N_MAIN}^3 timed 2", p_b, lambda n: n == 0)
    check_launches("B_fused", "phase 7 B_fused", sb1, l1)
    check_launches("B_fused", "phase 7 B_fused", sb2, l2)
    check_repeat("phase 7 Path B", vel1, sb1, vel2, sb2)
    _, st, launches = drive(f"phase 7 Path B fuse_pap=False {N_MAIN}^3", p_b.replace(fuse_pap=False), lambda n: n == 0)
    check_launches("B_unfused", "phase 7 B_unfused", st, launches)

    # -- phase 8: Path F, fuse_update with fuse_expand: the update kernel
    # expands, finishes and updates in one pass
    p_f = p_a.replace(fuse_update=True)
    drive(f"phase 8 Path F {N_MAIN}^3 warm", p_f, lambda n: n >= 1)
    vel1, sf1, l1 = drive(f"phase 8 Path F {N_MAIN}^3 timed 1", p_f, lambda n: n >= 1)
    vel2, sf2, l2 = drive(f"phase 8 Path F {N_MAIN}^3 timed 2", p_f, lambda n: n >= 1)
    check_launches("F", "phase 8 Path F", sf1, l1)
    check_launches("F", "phase 8 Path F", sf2, l2)
    check_repeat("phase 8 Path F", vel1, sf1, vel2, sf2)
    print(f"phase 8 ms per apply (first reading, not a claim): Path F {sf1['ms_per_apply']:.4f} and "
          f"{sf2['ms_per_apply']:.4f}, Path A {st1['ms_per_apply']:.4f} and {st2['ms_per_apply']:.4f}; iterations "
          f"F {sf1['iterations']}, A {st1['iterations']}", flush=True)

    # -- phase 9: F' (fuse_expand off: the update finishes a stored u), B_u
    # (the uniform step's update), and REGION_ARROW with fuse_update, which
    # has no fused update in either package: phase 5's launches, none of an
    # update kernel
    _, st, launches = drive(f"phase 9 Path F' {N_MAIN}^3", p_f.replace(fuse_expand=False), lambda n: n >= 1)
    check_launches("F_prime", "phase 9 Path F'", st, launches)
    _, st, launches = drive(f"phase 9 Path B_u {N_MAIN}^3", p_b.replace(fuse_update=True), lambda n: n == 0)
    check_launches("B_u", "phase 9 Path B_u", st, launches)
    _, st, launches = drive(f"phase 9 REGION_ARROW fuse_update=True {N_MAIN}^3", p_r.replace(fuse_update=True),
                            lambda n: n >= 1)
    check_launches("A_region", "phase 9 REGION_ARROW fuse_update=True", st, launches, record=False)

    def step_32(where, p, n=N_CPU):
        g32, s32 = honey_coil(n=n, dtype=torch.float32, device=where)
        t0 = time.perf_counter()
        v32, _, st32 = solver.step(g32, s32, p)
        print(f"  {where} {n}^3 {p.preconditioner.name} fuse_pap={p.fuse_pap} fuse_update={p.fuse_update}: "
              f"{time.perf_counter() - t0:.2f} s, iterations {st32['iterations']}, error {st32['error']:.3e}, "
              f"converged {st32['converged']}", flush=True)
        if not st32["converged"]:
            fail(f"{n}^3 step on {where} did not converge: {p}")
        return [c.double().cpu() for c in v32]

    # -- phase 10: Paths A and B on the card against the CPU port at 32^3
    p32 = params(torch.float32, 1e-5, 12000, fuse_pap=True)
    for label, p in (("Path A", p32), ("Path B", p32.replace(do_reduced_regions=False))):
        print(f"phase 10 {label} {N_CPU}^3, card and CPU:", flush=True)
        agree(f"phase 10 {label} velocities, card against CPU", step_32("cuda", p), step_32("cpu", p))

    # -- phase 11: at 32^3 on the card, IDENTITY and DIAGONAL with the fused
    # update against the unfused loop (identity-PCG needs thousands of
    # iterations at 128^3), and Path F on the card against the CPU
    for pc in (PreconditionerType.IDENTITY, PreconditionerType.DIAGONAL):
        p = p32.replace(preconditioner=pc)
        print(f"phase 11 {pc.name} {N_CPU}^3, fuse_update on and off:", flush=True)
        agree(f"phase 11 {pc.name} fuse_update on against off", step_32("cuda", p.replace(fuse_update=True)),
              step_32("cuda", p))
    print(f"phase 11 Path F {N_CPU}^3, card and CPU:", flush=True)
    p32f = p32.replace(fuse_update=True)
    agree("phase 11 Path F velocities, card against CPU", step_32("cuda", p32f), step_32("cpu", p32f))

    # -- phase 12: the CG loop through the CUDA graph against the eager loop,
    # on one Krylov system per path
    from polystokes_tpu_torch import krylov

    def profile_passes(loop, n):
        """(device ms per pass, device span ms per pass, top kernels) of n
        passes of a loop, from torch.profiler's device events; None where
        the profiler records no device time."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop._passes(n)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            return None
        span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        busy = sum(by_name.values())
        return busy / n / 1e3, span / n / 1e3, [(name[:60], us / n / 1e3) for name, us in top], len(kernels) / n

    loop_ms = {}
    for path, p in (("A", p_a), ("A_region", p_r), ("unfused", p_a.replace(fuse_pap=False)), ("B_fused", p_b),
                    ("B_unfused", p_b.replace(fuse_pap=False)), ("F", p_f), ("F_prime", p_f.replace(fuse_expand=False)),
                    ("B_u", p_b.replace(fuse_update=True))):
        c_cls, c_asm = solver._setup(grid, scene, p)
        apply_k, apply_dot, fused, precond, b_k, x0_k = solver._build_krylov_system(grid, c_cls, c_asm, scene, p)
        runs = {}
        for graph in (False, True):
            pa.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry = krylov.pcg_init(apply_k, b_k, x0_k, precond)
            loop = krylov.PCGLoop(apply_k, precond, tol=p.tolerance, max_iters=p.max_iterations, apply_dot=apply_dot,
                                  fused_update=fused, graph=graph)
            res = krylov.pcg_result(loop.segment(carry), loop.passes)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            runs[graph] = (res, seconds, dict(pa.LAUNCHES), loop)
        (r_e, s_e, l_e, _), (r_g, s_g, l_g, loop_g) = runs[False], runs[True]
        bit_equal = torch.equal(r_g.x, r_e.x)
        ms_e, ms_g = 1e3 * s_e / r_e.applies, 1e3 * s_g / r_g.applies
        cap = loop_g.capture_seconds or 0.0
        ms_g_run = 1e3 * (s_g - cap) / r_g.applies
        loop_ms[path] = (ms_e, ms_g, ms_g_run)
        print(f"phase 12 {path} {N_MAIN}^3 graph against eager: iterations {r_g.iterations} / {r_e.iterations}, "
              f"passes {r_g.passes} / {r_e.passes} for {r_g.applies} applies, x bit-equal {bit_equal}, launches equal "
              f"{l_g == l_e}; ms per apply (solve wall / applies) graph {ms_g:.4f} ({ms_g_run:.4f} without the "
              f"capture), eager {ms_e:.4f}; capture {cap:.3f} s, graph pool {(loop_g.pool_bytes or 0) / 2**20:.1f} MiB",
              flush=True)
        if not (r_g.converged and r_e.converged):
            fail(f"phase 12 {path}: a loop did not converge")
        if r_g.passes > krylov.POLL_PASSES and loop_g.capture_seconds is None:
            fail(f"phase 12 {path}: the graphed loop did not capture")
        if not (r_g.iterations == r_e.iterations and r_g.passes == r_e.passes and bit_equal and l_g == l_e):
            fail(f"phase 12 {path}: the graphed loop differs from the eager one")
        if l_g != expected_launches(path, 1 + r_g.passes):
            fail(f"phase 12 {path}: launches {l_g}, expected {expected_launches(path, 1 + r_g.passes)}")
        # the device's busy and idle time over one poll block of each loop
        # (converged, so every pass is gated: the same launches)
        for label, lp in (("graph", loop_g), ("eager", runs[False][3])):
            try:
                prof = profile_passes(lp, krylov.POLL_PASSES)
            except RuntimeError as err:  # the profiler itself, not the loop: the passes ran above
                print(f"phase 12 {path} {label} profile failed (not measured): {err}", flush=True)
                continue
            if prof is None:
                print(f"phase 12 {path} {label} profile: no device events recorded (not measured)", flush=True)
                continue
            busy, span, top, n_k = prof
            print(f"phase 12 {path} {label} profile over {krylov.POLL_PASSES} passes: device busy {busy:.4f} ms a pass "
                  f"of a {span:.4f} ms device span, idle share {1 - busy / span:.3f}, {n_k:.0f} kernels a pass; top: "
                  + "; ".join(f"{name} {ms:.4f}" for name, ms in top), flush=True)
        del runs, loop_g, carry, loop
    for path, (ms_e, ms_g, ms_g_run) in loop_ms.items():
        steps = " ".join(f"{m:.4f}" for m in step_ms.get(path, []))
        print(f"phase 12 ms per apply {path}: graphed step {steps}; loop graph {ms_g:.4f} ({ms_g_run:.4f} without the "
              f"capture), loop eager {ms_e:.4f}", flush=True)

    # -- phase 13: solve_chunked on Path A
    seg = 100
    vel_c, _, st_c = solver.solve_chunked(grid, scene, p_a, segment_iters=seg)
    equal_step = all(torch.equal(a, b) for a, b in zip(vel_c, vel_a))
    print(f"phase 13 solve_chunked {N_MAIN}^3 Path A, segments of {seg}: iterations {st_c['iterations']} (step "
          f"{st_a['iterations']}), bit-equal to step {equal_step}, interrupted {st_c['interrupted']}", flush=True)
    if not (equal_step and st_c["iterations"] == st_a["iterations"] and not st_c["interrupted"]):
        fail("phase 13: solve_chunked differs from step")
    with tempfile.TemporaryDirectory() as tmp:
        sp = os.path.join(tmp, "pcg_state.npz")
        segs = [0]

        def stop_after_two(_):
            segs[0] += 1
            return segs[0] >= 2

        _, _, st_i = solver.solve_chunked(grid, scene, p_a, segment_iters=seg, callback=stop_after_two, state_path=sp)
        vel_r, _, st_r = solver.solve_chunked(grid, scene, p_a, segment_iters=seg, state_path=sp, resume=True)
    equal_resume = all(torch.equal(a, b) for a, b in zip(vel_r, vel_c))
    print(f"phase 13 interrupted after 2 segments: interrupted {st_i['interrupted']}, iterations {st_i['iterations']}; "
          f"resumed: iterations {st_r['iterations']}, bit-equal to the whole {equal_resume}", flush=True)
    if not (st_i["interrupted"] and st_i["iterations"] == 2 * seg):
        fail("phase 13: the callback did not stop the solve after 2 segments")
    if not (equal_resume and st_r["iterations"] == st_c["iterations"] and not st_r["interrupted"]):
        fail("phase 13: the resumed solve differs from the whole")
    _, _, st_t = solver.solve_chunked(grid, scene, p_a, segment_iters=seg, max_seconds=0.0)
    print(f"phase 13 max_seconds=0.0: interrupted {st_t['interrupted']}, iterations {st_t['iterations']}, converged "
          f"{st_t['converged']}", flush=True)
    if not (st_t["interrupted"] and st_t["iterations"] == seg and not st_t["converged"]):
        fail("phase 13: max_seconds=0.0 did not stop after one segment")

    # -- phase 14: tiled mode (the JAX suite's config 3 and, at 256^3, 16 and 18)
    p_t = params(torch.float32, 1e-3, 12000, fuse_pap=True, do_tile=True)
    packed_preflight(grid, scene, p_t, "phase 14")
    tiled = lambda n: n >= 1  # noqa: E731
    # a warm run and one timed, to leave time for phases 20 and 21
    vel1, sa1, l1 = drive(f"phase 14 A_t {N_MAIN}^3 tile {TILE} warm", p_t, tiled)
    vel2, sa2, l2 = drive(f"phase 14 A_t {N_MAIN}^3 tile {TILE} timed", p_t, tiled)
    check_launches("A_t", "phase 14 A_t", sa1, l1)
    check_launches("A_t", "phase 14 A_t", sa2, l2)
    check_repeat("phase 14 A_t", vel1, sa1, vel2, sa2)
    print(f"phase 14 A_t n_regions {sa1['n_regions']} (the JAX suite's TPU record: {JAX_REGIONS['A_t']}); ms per apply "
          f"{sa1['ms_per_apply']:.4f} and {sa2['ms_per_apply']:.4f} against Path A's {st1['ms_per_apply']:.4f} and "
          f"{st2['ms_per_apply']:.4f}; iterations {sa1['iterations']} against Path A's {st1['iterations']}", flush=True)
    _, st, launches = drive(f"phase 14 F_t {N_MAIN}^3 tile {TILE}", p_t.replace(fuse_update=True, fuse_expand=True), tiled)
    check_launches("F_t", "phase 14 F_t", st, launches)
    _, st, launches = drive(f"phase 14 R_t {N_MAIN}^3 tile {TILE}",
                            p_t.replace(preconditioner=PreconditionerType.REGION_ARROW), tiled)
    check_launches("R_t", "phase 14 R_t", st, launches)
    for label, T in (("S16", TILE), ("S8", TILE_8)):
        p_s = solver.sample_density(scene_si, p_t.replace(tile_size=T))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cls_s, _ = solver._setup(grid_si, scene_si, p_s)
        torch.cuda.synchronize()
        t_set = time.perf_counter() - t0
        peak_set = torch.cuda.max_memory_allocated()
        del cls_s
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vel_s, st, launches = drive(f"phase 14 {label} armadillo_melt_si {N_SI}^3 tile {T}", p_s, tiled,
                                    (grid_si, scene_si))
        peak = torch.cuda.max_memory_allocated()
        check_launches(label, f"phase 14 {label}", st, launches, record=False)
        print(f"phase 14 {label}: n_regions {st['n_regions']} (the JAX suite's TPU record: {JAX_REGIONS[label]}); "
              f"setup (weights, classify, assemble) {t_set:.3f} s; ms per apply of the step without that setup "
              f"{1e3 * (st['seconds'] - t_set) / st['operator_applies']:.4f}; capture {st['capture_seconds']:.3f} s; "
              f"peak device memory in the step {peak / 2**30:.3f} GiB, in its setup alone {peak_set / 2**30:.3f} GiB "
              f"({before / 2**30:.3f} GiB held before them)", flush=True)
        if label == "S16":
            s16 = (vel_s, st, peak, t_set)  # phase 17 holds the cropped solve against it
            s16_stats = st  # phase 26 sets the deflated S16 beside it
        del vel_s
    p32t = params(torch.float32, 1e-5, 12000, fuse_pap=True, do_tile=True, tile_size=TILE_8)
    print(f"phase 14 tiled {N_CPU}^3 tile {TILE_8}, card and CPU:", flush=True)
    agree(f"phase 14 tiled {N_CPU}^3 tile {TILE_8} velocities, card against CPU", step_32("cuda", p32t),
          step_32("cpu", p32t))

    # -- phase 15: the affine basis (the CLI's --affine), tiled as phase 14
    p_aff = p_t.replace(basis=BasisOrder.AFFINE)
    packed_preflight(grid, scene, p_aff, "phase 15")
    aff_steps = {}
    for label, p in (("A_aff", p_aff), ("F_aff", p_aff.replace(fuse_update=True, fuse_expand=True))):
        vel1, s1, l1 = drive(f"phase 15 {label} {N_MAIN}^3 tile {TILE} warm", p, tiled)
        vel2, s2, l2 = drive(f"phase 15 {label} {N_MAIN}^3 tile {TILE} timed", p, tiled)
        check_launches(label, f"phase 15 {label}", s1, l1)
        check_launches(label, f"phase 15 {label}", s2, l2)
        check_repeat(f"phase 15 {label}", vel1, s1, vel2, s2)
        aff_steps[label] = (s1, s2)
    (a1, a2), (f1, f2) = aff_steps["A_aff"], aff_steps["F_aff"]
    print(f"phase 15 affine: n_regions {a1['n_regions']}, iterations A_aff {a1['iterations']} F_aff "
          f"{f1['iterations']} (A_t {sa1['iterations']}); ms per apply A_aff {a1['ms_per_apply']:.4f} and "
          f"{a2['ms_per_apply']:.4f}, F_aff {f1['ms_per_apply']:.4f} and {f2['ms_per_apply']:.4f}, against A_t's "
          f"{sa1['ms_per_apply']:.4f} and {sa2['ms_per_apply']:.4f}", flush=True)
    # the CLI test's configuration (tests/test_io_cli.py: affine, DIAGONAL,
    # tile 8), tiled, at 128^3
    _, st, launches = drive(f"phase 15 D8_aff (affine, DIAGONAL, tile {TILE_8}) {N_MAIN}^3",
                            p_aff.replace(tile_size=TILE_8, preconditioner=PreconditionerType.DIAGONAL,
                                          max_iterations=20000), tiled)
    check_launches("D8_aff", "phase 15 D8_aff", st, launches, record=False)
    p32aff = p32t.replace(basis=BasisOrder.AFFINE)
    print(f"phase 15 affine {N_CPU}^3 tile {TILE_8}, card and CPU:", flush=True)
    agree(f"phase 15 affine {N_CPU}^3 tile {TILE_8} velocities, card against CPU", step_32("cuda", p32aff),
          step_32("cpu", p32aff))

    # -- phase 16: the frame loop (sim.simulate) with the device warm start,
    # the two configurations of the JAX package's benchmarks/frames_ab.py
    from polystokes_tpu_torch import sim

    frame_runs = {}

    def run_frames(label, p, path):
        """FRAMES frames of honey_coil 128^3 through sample_density and
        simulate; per frame its stats, launches (counters set to 0 before
        the frame), seconds, the solve's and the advection's share, device
        memory after it and its peak.  The solve and the advection are timed
        by wrapping sim.step and sim.advect_field with synchronised host
        clocks for this run."""
        p = packed_preflight(grid, scene, solver.sample_density(scene, p), f"phase 16 {label}")
        spent = {"step": 0.0, "advect_field": 0.0}
        originals = {name: getattr(sim, name) for name in spent}

        def timed(name):
            fn = originals[name]

            def wrapper(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t0
                return out

            return wrapper

        rec = []
        clock = [0.0]

        def after_frame(k, sc, st):
            torch.cuda.synchronize()
            frame_s = time.perf_counter() - clock[0]
            launches = dict(pa.LAUNCHES)
            finite = all(bool(torch.isfinite(t).all()) for t in sc.velocity + (sc.surface_sdf,))
            rec.append({"frame": k, "iterations": st["iterations"], "error": st["error"],
                        "converged": st["converged"], "boundary_active": st["boundary_active"],
                        "passes": st["loop_passes"], "applies": st["operator_applies"],
                        "n_regions": st["n_regions"], "capture_s": st["capture_seconds"], "frame_s": frame_s,
                        "solve_s": spent["step"], "advect_ms": 1e3 * spent["advect_field"],
                        "allocated": torch.cuda.memory_allocated(), "peak": torch.cuda.max_memory_allocated(),
                        "launches": launches, "finite": finite})
            spent.update(step=0.0, advect_field=0.0)
            pa.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            clock[0] = time.perf_counter()

        sim.step, sim.advect_field = timed("step"), timed("advect_field")
        try:
            pa.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            clock[0] = time.perf_counter()
            out, _ = sim.simulate(grid, scene, p, FRAMES, callback=after_frame)
        finally:
            sim.step, sim.advect_field = originals["step"], originals["advect_field"]
        for r in rec:
            print(f"phase 16 {label} frame {r['frame']}: iterations {r['iterations']}, error {r['error']:.3e}, "
                  f"converged {r['converged']}, n_regions {r['n_regions']}, solve {r['solve_s']:.3f} s, advection "
                  f"{r['advect_ms']:.2f} ms, capture {r['capture_s']:.3f} s, frame {r['frame_s']:.3f} s, peak device "
                  f"memory {r['peak'] / 2**30:.3f} GiB, allocated after it {r['allocated'] / 2**30:.3f} GiB, "
                  f"launches {r['launches']}", flush=True)
            if not (r["converged"] and r["error"] < 1e-3 and r["boundary_active"] == 0 and r["finite"]):
                fail(f"phase 16 {label} frame {r['frame']} did not converge cleanly or is not finite: {r}")
            want = expected_launches(path, 1 + r["passes"])
            if r["launches"] != want:
                fail(f"phase 16 {label} frame {r['frame']}: launches {r['launches']}, expected {want}")
        frame_runs[label] = (out, rec)
        return out, rec

    p_ft = p_t.replace(use_warm_start=True, device_warm_start=True)
    frame_paths = (("tiled_warm", p_ft, "A_t"), ("uniform_warm", p_ft.replace(do_reduced_regions=False), "B_fused"),
                   ("tiled_cold", p_ft.replace(use_warm_start=False, device_warm_start=False), "A_t"),
                   ("tiled_warm_again", p_ft, "A_t"))
    scene_bytes = sum(t.numel() * t.element_size() for t in
                      scene.velocity + scene.collision_velocity + (scene.surface_sdf, scene.collision_sdf, scene.viscosity))
    for label, p, path in frame_paths:
        _, rec = run_frames(label, p, path)
        rise = max(r["allocated"] for r in rec[1:]) - rec[0]["allocated"]
        print(f"phase 16 {label}: device memory after frames 2-{FRAMES} rises {rise / 2**20:.1f} MiB over frame 1's "
              f"(one scene {scene_bytes / 2**20:.1f} MiB)", flush=True)
        if rise > scene_bytes:
            fail(f"phase 16 {label}: device memory grows frame over frame ({rise} bytes > one scene, {scene_bytes})")
        for name, n in rec[0]["launches"].items():
            if n:
                table[name]["launches_by_path"][f"frame_{label}"] = [r["launches"][name] for r in rec]
    (out_w, rec_w), (out_r, rec_r) = frame_runs["tiled_warm"], frame_runs["tiled_warm_again"]
    same = all(torch.equal(a, b) for a, b in zip(out_w.velocity + (out_w.surface_sdf,),
                                                  out_r.velocity + (out_r.surface_sdf,)))
    its_w, its_r = [r["iterations"] for r in rec_w], [r["iterations"] for r in rec_r]
    its_c = [r["iterations"] for r in frame_runs["tiled_cold"][1]]
    its_u = [r["iterations"] for r in frame_runs["uniform_warm"][1]]
    print(f"phase 16 iterations per frame: tiled warm {its_w}, again {its_r}, tiled cold {its_c}, uniform warm "
          f"{its_u}; the repeat bit-equal (velocity and SDF) {same}", flush=True)
    if not (its_w == its_r and same):
        fail("phase 16: two tiled warm runs from the same scene differ")
    # the warm x0 of frame 1: the step's guess on the kicked scene, and the
    # initial residual |b - A x0| it gives beside |b| (the cold start's)
    kicked = sim._gravity_kick(scene, p_ft)
    cls_k, asm_k = solver._setup(grid, kicked, p_ft)
    apply_k, _, _, _, b_k, x0_k = solver._build_krylov_system(grid, cls_k, asm_k, kicked, p_ft)
    x0_norm = float(x0_k.double().norm())
    r0_norm, b_norm = float((b_k - apply_k(x0_k)).double().norm()), float(b_k.double().norm())
    print(f"phase 16 frame 1 warm x0: norm {x0_norm:.6e}; initial residual |b - A x0| {r0_norm:.6e} against "
          f"|b| {b_norm:.6e} (the cold start's)", flush=True)
    if not x0_norm > 0.0:
        fail("phase 16: the warm start of frame 1 is zero")
    vel_f = out_w.velocity
    del frame_runs, out_w, out_r, kicked, cls_k, asm_k, apply_k, b_k, x0_k

    # the windowed and the gather advection at 128^3 on the tiled warm run's
    # last velocity (substeps from its CFL), and on a constant velocity,
    # where the two agree to round-off
    dtdx = scene.dt / torch.tensor(grid.dx, dtype=torch.float32, device=dev)
    n_sub = sim.cfl_substeps(vel_f, float(dtdx))
    sdf = scene.surface_sdf
    for label, fn in (("windowed", lambda: sim.advect_field(sdf, vel_f, dtdx, (0.0, 0.0, 0.0), substeps=n_sub)),
                      ("gather", lambda: sim.advect_field_gather(sdf, vel_f, dtdx, (0.0, 0.0, 0.0)))):
        print(f"phase 16 {label} advection of the SDF {N_MAIN}^3 (substeps {n_sub}): {median_ms(fn, 5):.3f} ms a call "
              f"(host included), device {graph_ms(fn, 2, 3):.3f} ms", flush=True)
    # displacements of 0.7, 0.4 and 0.1 cells
    vel_c = tuple(torch.full(grid.face_shape(a), (0.7 - 0.3 * a) / float(dtdx), device=dev) for a in range(3))
    d_w = sim.advect_field(sdf, vel_c, dtdx, (0.0, 0.0, 0.0))
    d_g = sim.advect_field_gather(sdf, vel_c, dtdx, (0.0, 0.0, 0.0))
    d_adv = float((d_w - d_g).abs().max()) / float(d_g.abs().max())
    print(f"phase 16 windowed against gather on a constant velocity: max|diff| / max {d_adv:.3e}", flush=True)
    if not d_adv <= 1e-6:
        fail(f"phase 16: the windowed advection disagrees with the gather one on a constant velocity: {d_adv}")

    # one frame at 32^3, the card against the CPU port
    p32f = p32t.replace(device_warm_start=True)
    frames32 = {}
    for where in ("cuda", "cpu"):
        g32, s32 = honey_coil(n=N_CPU, dtype=torch.float32, device=where)
        n32 = sim.cfl_substeps(s32.velocity, float(s32.dt) / g32.dx)
        t0 = time.perf_counter()
        f32_, st32 = sim.simulate_frame(g32, s32, p32f, substeps=n32)
        print(f"phase 16 frame {N_CPU}^3 tile {TILE_8} on {where}: {time.perf_counter() - t0:.2f} s, substeps {n32}, "
              f"iterations {st32['iterations']}, error {st32['error']:.3e}, converged {st32['converged']}", flush=True)
        if not st32["converged"]:
            fail(f"phase 16: the {N_CPU}^3 frame on {where} did not converge")
        frames32[where] = [t.double().cpu() for t in f32_.velocity + (f32_.surface_sdf,)]
    agree(f"phase 16 frame {N_CPU}^3 velocities, card against CPU", frames32["cuda"][:3], frames32["cpu"][:3])
    agree(f"phase 16 frame {N_CPU}^3 surface SDF, card against CPU", frames32["cuda"][3:], frames32["cpu"][3:])

    # -- phase 17: the cropped solve (domain.solve_cropped) on
    # armadillo_melt_si 256^3, the JAX suite's config 23, against S16
    from polystokes_tpu_torch import domain

    p_c = solver.sample_density(scene_si, p_t)
    bbox = domain.active_bbox(scene_si, p_c)
    if bbox is None:
        fail("phase 17: armadillo_melt_si 256^3 gives no crop")
    grid_c, scene_c = domain.crop_scene(grid_si, scene_si, *bbox)
    packed_preflight(grid_c, scene_c, p_c, "phase 17")
    del scene_c
    print(f"phase 17 crop of armadillo_melt_si {N_SI}^3: lo {bbox[0]} hi {bbox[1]} res {grid_c.res} (the JAX suite's "
          f"record: {JAX_CROP['res']}), {100.0 * (grid_c.res[0] * grid_c.res[1] * grid_c.res[2]) / N_SI ** 3:.1f} % "
          f"of the box", flush=True)
    crops = []
    for run in ("warm", "timed"):
        pa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        vel_c, valid_c, st = domain.solve_cropped(grid_si, scene_si, p_c)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, peak = dict(pa.LAUNCHES), torch.cuda.max_memory_allocated()
        print(f"phase 17 C16 cropped {run}: {seconds:.3f} s, iterations {st['iterations']}, error {st['error']:.3e}, "
              f"converged {st['converged']}, boundary_active {st['boundary_active']}, n_regions {st['n_regions']}, "
              f"applies {st['operator_applies']}, loop passes {st['loop_passes']}, ms per apply (solve wall / "
              f"applies) {1e3 * seconds / st['operator_applies']:.4f}, capture {st['capture_seconds']:.3f} s, peak "
              f"device memory {peak / 2**30:.3f} GiB ({before / 2**30:.3f} GiB held before), crop {st['crop']}",
              flush=True)
        if not (st["converged"] and st["error"] < 1e-3 and st["boundary_active"] == 0 and not st["interrupted"]):
            fail(f"phase 17 cropped {run} did not converge cleanly: {st}")
        if st["crop"]["res"] != grid_c.res:
            fail(f"phase 17 cropped {run}: box {st['crop']}, expected {bbox}")
        st["ms_per_apply"], st["seconds"] = 1e3 * seconds / st["operator_applies"], seconds
        check_launches("C16", f"phase 17 cropped {run}", st, launches)
        crops.append((vel_c, valid_c, st, peak))
    (v1, _, c1, peak1), (v2, _, c2, _) = crops[0], crops[1]
    check_repeat("phase 17 cropped", v1, c1, v2, c2)
    vel_s16, st16, peak16, t_set16 = s16
    for key in ("n_regions", "n_pressures", "n_active_velocities", "n_stresses"):
        if c1[key] != st16[key]:
            fail(f"phase 17: {key} {c1[key]} cropped against {st16[key]} uncropped")
    lo, hi = bbox
    vmax = max(float(c.abs().max()) for c in vel_s16)
    d_in, same_out, valid_out = 0.0, True, False
    for a in range(3):
        inside = tuple(slice(lo[i], hi[i] + (i == a)) for i in range(3))
        d_in = max(d_in, float((v1[a][inside] - vel_s16[a][inside]).abs().max()))
        outside = torch.ones(v1[a].shape, dtype=torch.bool, device=dev)
        outside[inside] = False
        same_out &= torch.equal(v1[a][outside], scene_si.velocity[a][outside])
        valid_out |= bool(crops[0][1][a][outside].any())
    print(f"phase 17 cropped against S16: iterations {c1['iterations']} and {c2['iterations']} (S16 {st16['iterations']}, "
          f"the JAX record {JAX_CROP['iterations']}), n_regions {c1['n_regions']} (S16 {st16['n_regions']}), solve "
          f"seconds {c1['seconds']:.3f} and {c2['seconds']:.3f} (S16 step {st16['seconds']:.3f}), ms per apply "
          f"{c1['ms_per_apply']:.4f} and {c2['ms_per_apply']:.4f} (S16 {st16['ms_per_apply']:.4f}; without its setup "
          f"{1e3 * (st16['seconds'] - t_set16) / st16['operator_applies']:.4f}), capture {c1['capture_seconds']:.3f} "
          f"and {c2['capture_seconds']:.3f} s (S16 {st16['capture_seconds']:.3f}), peak device memory "
          f"{peak1 / 2**30:.3f} GiB (S16 {peak16 / 2**30:.3f}); velocities inside the box max|dv| {d_in:.3e} max|v| "
          f"{vmax:.3e} rel {d_in / vmax:.3e}; outside equal to the input {same_out}, valid there {valid_out}",
          flush=True)
    if not same_out or valid_out:
        fail("phase 17: outside the box the velocity is not the input's or a face is valid")
    del crops, v2, vel_c, valid_c
    # one solution through both systems: the cropped system's own CG in
    # f32 (step's loop, which solve_chunked's segments repeat bit for bit),
    # then its x in fp64 through the cropped system and, embedded, through
    # the full-domain one: the residual b - A x restricted to the box and
    # the write-back inside it.  In fp64, because the apply's f32 rounding
    # follows its intermediate terms (the moments reach 5e6 on this scene),
    # not its output; the two systems differ only in the order of their
    # region sums
    import dataclasses

    from polystokes_tpu_torch import krylov

    box = (slice(None),) + tuple(slice(lo[i], hi[i]) for i in range(3))
    grid_c, scene_c = domain.crop_scene(grid_si, scene_si, lo, hi)
    cls_c, asm_c = solver._setup(grid_c, scene_c, p_c)
    apply_c, dot_c, upd_c, pre_c, b_c, x0_c = solver._build_krylov_system(grid_c, cls_c, asm_c, scene_c, p_c)
    res_c = krylov.pcg(apply_c, b_c, x0_c, pre_c, tol=p_c.tolerance, max_iters=p_c.max_iterations, apply_dot=dot_c,
                       fused_update=upd_c)
    wv_c = solver._write_back(grid_c, scene_c, p_c, cls_c, asm_c, res_c)[0]
    # kernels 1-5 at the box's shape, against their twins
    coeffs_c = pa.pack_coeffs(asm_c, cls_c)
    alg_c, red_c = solver._region_algebra_packed(grid_c, cls_c, asm_c, p_c, effective_max_regions(grid_c, p_c))
    xr = (torch.randn((7,) + grid_c.res, generator=gen, device=dev) * pa.packed_masks(cls_c, torch.float32)).contiguous()
    mom_c = pa.moments_packed_plain(xr, coeffs_c, TILE)
    v_alg = alg_c(mom_c)
    u_c = pa.expand_packed_plain(v_alg, red_c, TILE)
    og_c = pa.grid_mom_pap_packed_plain(xr, coeffs_c, TILE)[0]
    at = f"at the box's {grid_c.res[0]}x{grid_c.res[1]}x{grid_c.res[2]} (phase 17)"
    compare("moments", pa.moments_packed(xr, coeffs_c, TILE), mom_c, f"moments {at}")
    compare("expand", pa.expand_packed(v_alg, red_c, TILE), u_c, f"expand {at}")
    compare("apply_reduced", pa.apply_reduced_packed(xr, coeffs_c, u_c),
            pa.apply_reduced_packed_plain(xr, coeffs_c, u_c), f"apply_reduced {at}")
    compare("grid_mom_pap", pa.grid_mom_pap_packed(xr, coeffs_c, TILE), pa.grid_mom_pap_packed_plain(xr, coeffs_c, TILE),
            f"grid_mom_pap {at}")
    compare("finish", pa.finish_packed(coeffs_c, og_c, u_c), pa.finish_packed_plain(coeffs_c, og_c, u_c), f"finish {at}")
    del coeffs_c, alg_c, red_c, xr, mom_c, v_alg, u_c, og_c
    same_run = all(torch.equal(wv_c[a], v1[a][tuple(slice(lo[i], hi[i] + (i == a)) for i in range(3))])
                   for a in range(3))
    x_c = res_c.x.double()
    del apply_c, dot_c, upd_c, pre_c, x0_c, b_c, cls_c, asm_c, wv_c
    p64c = p_c.replace(dtype=torch.float64)

    def through(g_, sc_, x):
        """(b - A x, max(|A x|, |b|), the write-back velocities) of x in the fp64 system of g_, sc_."""
        sc_ = dataclasses.replace(sc_, **{f.name: (tuple(t.double() for t in v) if isinstance(v, tuple) else v.double())
                                          for f in dataclasses.fields(sc_)
                                          if (v := getattr(sc_, f.name)) is not None})
        cls_, asm_ = solver._setup(g_, sc_, p64c)
        apply_, _, _, _, b_, _ = solver._build_krylov_system(g_, cls_, asm_, sc_, p64c)
        ax = apply_(x)
        vel_ = solver._write_back(g_, sc_, p64c, cls_, asm_, res_c._replace(x=x))[0]
        return b_ - ax, max(float(ax.abs().max()), float(b_.abs().max())), vel_

    r_c, r_scale, wv_c = through(grid_c, scene_c, x_c)
    x_f = torch.zeros((7,) + grid_si.res, dtype=torch.float64, device=dev)
    x_f[box] = x_c
    r_f, _, wv_f = through(grid_si, scene_si, x_f)
    d_r = float((r_f[box] - r_c).abs().max())
    r_f[box] = 0.0
    d_r_out = float(r_f.abs().max())
    d_wb = max(float((wv_f[a][tuple(slice(lo[i], hi[i] + (i == a)) for i in range(3))] - wv_c[a]).abs().max())
               for a in range(3))
    wmax = max(float(c.abs().max()) for c in wv_c)
    del x_c, x_f, r_c, r_f, wv_c, wv_f, res_c, scene_c
    print(f"phase 17 one solution through both systems: the cropped CG's velocities (f32) bit-equal to the timed "
          f"run's {same_run}; in fp64, residual b - A x of the full-domain system against the cropped one's inside "
          f"the box max|diff| {d_r:.3e}, outside it max {d_r_out:.3e}, max(|A x|, |b|) {r_scale:.3e} (rel "
          f"{d_r / r_scale:.3e}); write-back inside the box max|dv| {d_wb:.3e} max|v| {wmax:.3e} (rel "
          f"{d_wb / wmax:.3e})", flush=True)
    if not same_run:
        fail("phase 17: the cropped system's CG differs from solve_cropped's")
    if not (d_r <= CROP_RTOL * r_scale and d_r_out <= CROP_RTOL * r_scale):
        fail(f"phase 17: the cropped operator or right-hand side differs from the full one's: {d_r}, {d_r_out}")
    if not d_wb <= CROP_RTOL * wmax:
        fail(f"phase 17: the cropped write-back differs from the full one's: {d_wb} > {CROP_RTOL} * {wmax}")
    # (how far tol 1e-3 resolves this scene's velocities, S16 and the cropped
    # solve again at tol 1e-5, is recorded in PERF.md section 7 and no longer
    # re-solved here, to leave time for phases 25-26)
    del v1, vel_s16, s16

    # -- phase 18: the other solvers.  At 32^3 on the card against the CPU
    # port in fp64 (in f32 this BiCGStab meets its tol-1e-5 test only by
    # letting x grow, and this MINRES overflows within 10 iterations):
    # BICGSTAB to tol 1e-5, MINRES and the fallback at a fixed count
    from polystokes_tpu_torch import SolverType

    p64 = params(torch.float64, 1e-5, 5000, fuse_pap=True)
    cases = (("BICGSTAB", p64.replace(solver_type=SolverType.BICGSTAB), True),
             ("MINRES", p64.replace(solver_type=SolverType.MINRES, max_iterations=20), False),
             ("fallback", p64.replace(bicgstab_fallback=True, max_iterations=20), False))
    for label, p, converges in cases:
        out = {}
        for where in ("cuda", "cpu"):
            g32, s32 = honey_coil(n=N_CPU, dtype=torch.float64, device=where)
            t0 = time.perf_counter()
            v32, _, st32 = solver.step(g32, s32, p)
            print(f"phase 18 {label} {N_CPU}^3 fp64 on {where}: {time.perf_counter() - t0:.2f} s, iterations "
                  f"{st32['iterations']}, error {st32['error']:.3e}, converged {st32['converged']}, applies "
                  f"{st32['operator_applies']}", flush=True)
            if st32["converged"] != converges or not all(bool(torch.isfinite(c).all()) for c in v32):
                fail(f"phase 18 {label} on {where}: converged {st32['converged']} (expected {converges}) or not finite")
            out[where] = [c.cpu() for c in v32]
        agree(f"phase 18 {label} {N_CPU}^3 velocities, card against CPU", out["cuda"], out["cpu"])
    # one BICGSTAB step at full width, f32 as the main path and fp64: the
    # unfused reduced apply, three an iteration (in f32 this BiCGStab has
    # broken down to NaN by its 5000th iteration at 128^3; printed, not held)
    for dtype, label in ((torch.float32, "f32"), (torch.float64, "fp64")):
        g_b, s_b = (grid, scene) if dtype == torch.float32 else honey_coil(n=N_MAIN, dtype=dtype, device=dev)
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # f32 at most 1500 iterations (it broke down to NaN by 5000 when it ran
        # that far), fp64 to convergence
        cap = 5000 if dtype == torch.float64 else 1500
        v_b, _, st_b = solver.step(g_b, s_b, p_a.replace(solver_type=SolverType.BICGSTAB, max_iterations=cap,
                                                         dtype=dtype))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(pa.LAUNCHES)
        vmax_b = max(float(c.abs().max()) for c in v_b)
        print(f"phase 18 BICGSTAB {N_MAIN}^3 {label}: {seconds:.3f} s, iterations {st_b['iterations']}, error "
              f"{st_b['error']:.3e}, converged {st_b['converged']}, max|v| {vmax_b:.4e}, applies "
              f"{st_b['operator_applies']}, loop passes {st_b['loop_passes']}, ms per apply "
              f"{1e3 * seconds / st_b['operator_applies']:.4f}, launches moments {launches['moments']} expand "
              f"{launches['expand']} apply_reduced {launches['apply_reduced']}", flush=True)
        want = expected_launches("BiCGStab", 1 + 3 * st_b["loop_passes"])
        if launches != want:
            fail(f"phase 18 BICGSTAB {N_MAIN}^3 {label}: launches {launches}, expected {want}")
        if dtype == torch.float32:
            for name in ("moments", "expand", "apply_reduced"):
                table[name]["launches_by_path"]["BiCGStab"] = launches[name]
        del v_b, g_b, s_b
    phase_18_fallback(grid, scene, p_a)

    # -- phase 19: the CLI end to end on the card, each run a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        base = ["--scene", "honey_coil", "--n", "64"]
        runs = (("default", base + ["--steps", "2", "--checkpoint", ck], "step", (0, 1)),
                ("resume", ["--resume", ck, "--steps", "1"], "step", (2,)),
                ("crop chunked", base + ["--crop", "--chunked"], "step", (0,)),
                ("sim", base + ["--sim", "--steps", "2"], "frame", (0, 1)),
                ("pallas", base + ["--pallas"], "step", (0,)),
                ("profile", base + ["--profile"], "step", (0,)),
                ("bf16-coeffs pallas", base + ["--bf16-coeffs", "--pallas"], "step", (0,)),
                ("deflation", base + ["--deflation"], "step", (0,)),
                ("deflation pallas", base + ["--deflation", "--pallas"], "step", (0,)))
        for label, argv, word, ks in runs:
            run_cli(f"phase 19 CLI {label}", argv, word, ks)

    # -- phase 20: the unpacked apply (use_pallas=False, JAX's default) at
    # full width: no hand-written kernel on any of these paths
    def step_counted(g, sc, p):
        """(stats, launches) of one step from counters set to 0 before it."""
        pa.reset_launches()
        _, _, stats = solver.step(g, sc, p)
        torch.cuda.synchronize()
        return stats, dict(pa.LAUNCHES)

    def drive_unpacked(label, p, n_check=None, case=None):
        vel, st, launches = drive(label, p, n_check, case)
        if solver._use_packed((case or (grid, scene))[0], p) or any(launches.values()):
            fail(f"{label}: the unpacked step launched hand-written kernels: {launches}")
        return vel, st

    unpacked = {"U_t": p_t.replace(use_pallas=False), "U": p_a.replace(use_pallas=False),
                "G": p_a.replace(use_pallas=False, cube_regions=False),
                "P0": p_t.replace(use_pallas=False, tile_padding=0)}
    u_steps = {}
    for label, p in unpacked.items():
        vel1, s1 = drive_unpacked(f"phase 20 {label} {N_MAIN}^3 warm", p, lambda n: n >= 1)
        vel2, s2 = drive_unpacked(f"phase 20 {label} {N_MAIN}^3 timed", p, lambda n: n >= 1)
        check_repeat(f"phase 20 {label}", vel1, s1, vel2, s2)
        u_steps[label] = (s1, s2)
        for name in table:
            table[name]["launches_by_path"][label] = 0
        del vel1, vel2
    (ut1, ut2), (u1, u2), (g1, g2), (z1, z2) = (u_steps[k] for k in ("U_t", "U", "G", "P0"))
    print(f"phase 20 U_t: iterations {ut1['iterations']} (A_t {sa1['iterations']}, the JAX suite's TPU record "
          f"{JAX_ITERS['U_t']}); ms per apply {ut1['ms_per_apply']:.4f} and {ut2['ms_per_apply']:.4f} against A_t's "
          f"{sa1['ms_per_apply']:.4f} and {sa2['ms_per_apply']:.4f}", flush=True)
    print(f"phase 20 U: iterations {u1['iterations']} (A {st1['iterations']}); ms per apply {u1['ms_per_apply']:.4f} "
          f"and {u2['ms_per_apply']:.4f} against A's {st1['ms_per_apply']:.4f} and {st2['ms_per_apply']:.4f}", flush=True)
    print(f"phase 20 G (general regions): n_regions {g1['n_regions']} (U {u1['n_regions']}), iterations "
          f"{g1['iterations']}, ms per apply {g1['ms_per_apply']:.4f} and {g2['ms_per_apply']:.4f}; P0 (tiles without "
          f"padding): n_regions {z1['n_regions']}, iterations {z1['iterations']}, ms per apply "
          f"{z1['ms_per_apply']:.4f} and {z2['ms_per_apply']:.4f}; peak device memory U_t {ut1['peak_gib']:.3f}, U "
          f"{u1['peak_gib']:.3f}, G {g1['peak_gib']:.3f}, P0 {z1['peak_gib']:.3f} GiB", flush=True)
    # the J couplings alone, device time of one reduce and one expand: the
    # cube-major form (U_t, U) against the segmented sums (G at R = 64, P0
    # at the tiled R)
    from polystokes_tpu_torch.operators import forward_face_values
    from polystokes_tpu_torch.reduced import Coupling

    for label, p in unpacked.items():
        c_cls, c_asm = solver._setup(grid, scene, p)
        r = effective_max_regions(grid, p)
        coupling = Coupling(grid, c_cls, c_asm.com, p, r)
        x = pa.unpack_ptau((torch.randn((7,) + grid.res, generator=gen, device=dev)
                            * pa.packed_masks(c_cls, torch.float32)).contiguous())
        s_faces = forward_face_values(c_asm, x)
        w = torch.randn((r, p.reduced_dof), generator=gen, device=dev)
        print(f"phase 20 {label} J couplings ({'cube-major' if coupling.tiled else 'segmented'}, R {r}): reduce "
              f"{graph_ms(lambda: coupling.reduce(s_faces)):.4f} ms, expand {graph_ms(lambda: coupling.expand(w)):.4f} "
              f"ms on the device", flush=True)
        del c_cls, c_asm, coupling, x, s_faces, w
    # one apply of A's and A_t's systems, packed against unpacked, on one x
    for label, p in (("A", p_a), ("A_t", p_t)):
        c_cls, c_asm = solver._setup(grid, scene, p)
        r = effective_max_regions(grid, p)
        x = (torch.randn((7,) + grid.res, generator=gen, device=dev) * pa.packed_masks(c_cls, torch.float32)).contiguous()
        ref = solver.make_apply_packed(grid, c_cls, c_asm, p, r)(x)
        got = pa.pack_ptau(solver.make_apply(grid, c_cls, c_asm, p.replace(use_pallas=False), r)(pa.unpack_ptau(x)))
        d, scale = float((got - ref).abs().max()), float(ref.abs().max())
        print(f"phase 20 {label} apply, unpacked against packed on one x: max|diff| {d:.3e} max {scale:.3e} rel "
              f"{d / scale:.3e}", flush=True)
        if not d <= KERNEL_RTOL * scale:
            fail(f"phase 20 {label}: the unpacked apply disagrees with the packed one: {d} > {KERNEL_RTOL} * {scale}")
        del c_cls, c_asm, x, ref, got
    # the JAX suite's config 19: honey_coil 64^3 in fp64, unpacked, untiled
    g64, s64 = honey_coil(n=64, dtype=torch.float64, device=dev)
    _, s19 = drive_unpacked("phase 20 config 19 honey_coil 64^3 fp64", params(torch.float64, 1e-3, 5000,
                                                                               use_pallas=False), lambda n: n >= 1,
                            (g64, s64))
    print(f"phase 20 config 19: iterations {s19['iterations']} (the JAX suite's TPU record {JAX_ITERS['config 19']}), "
          f"n_regions {s19['n_regions']}, peak device memory {s19['peak_gib']:.3f} GiB", flush=True)
    del g64, s64
    torch.cuda.empty_cache()

    # -- phase 21: at N_21^3, tol 1e-5, unpacked on the card against the CPU;
    # check_pallas's fallback; a resolution the tile does not divide
    p32u = p32.replace(use_pallas=False)
    for pc in (PreconditionerType.IDENTITY, PreconditionerType.DIAGONAL, PreconditionerType.CELL_ARROW,
               PreconditionerType.REGION_ARROW):
        print(f"phase 21 unpacked {pc.name} {N_21}^3, card and CPU:", flush=True)
        p = p32u.replace(preconditioner=pc, max_iterations=20000)
        agree(f"phase 21 unpacked {pc.name} {N_21}^3 velocities, card against CPU", step_32("cuda", p, N_21),
              step_32("cpu", p, N_21))
    print(f"phase 21 G (general regions) {N_21}^3, card and CPU:", flush=True)
    p32g = p32u.replace(cube_regions=False)
    agree(f"phase 21 G {N_21}^3 velocities, card against CPU", step_32("cuda", p32g, N_21), step_32("cpu", p32g, N_21))
    # liquid on the index-0 planes (the all-liquid box of the JAX tests'
    # make_case): check_pallas warns and turns the packed path off
    import warnings

    gen21 = torch.Generator(device="cpu").manual_seed(21)
    res21 = (16, 16, 16)
    face21 = [tuple(res21[i] + (i == a) for i in range(3)) for a in range(3)]
    box = solver.Scene(
        surface_sdf=torch.full(res21, -1.0, device=dev), collision_sdf=torch.full(res21, 1.0, device=dev),
        velocity=tuple(torch.randn(s, generator=gen21).to(dev) for s in face21),
        collision_velocity=tuple(torch.randn(s, generator=gen21).to(dev) for s in face21),
        viscosity=(0.5 + 2.0 * torch.rand(res21, generator=gen21)).to(dev), dt=torch.tensor(0.04, device=dev))
    from polystokes_tpu_torch import Grid

    g21 = Grid(res=res21, dx=1.0 / 16)
    p21 = params(torch.float32, 1e-5, 5000, do_tile=True, tile_size=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        q21 = solver.check_pallas(g21, box, p21)
    fired = [str(w.message) for w in caught if "index-0 planes" in str(w.message)]
    print(f"phase 21 check_pallas on the all-liquid box: boundary activity "
          f"{solver.boundary_activity(g21, box, p21)}, warned {bool(fired)}, use_pallas {q21.use_pallas}", flush=True)
    if not fired or q21 != p21.replace(use_pallas=False):
        fail("phase 21: check_pallas did not fall back on liquid on the index-0 planes")
    st21, l21 = step_counted(g21, box, q21)
    print(f"phase 21 the all-liquid box after the fallback: iterations {st21['iterations']}, error "
          f"{st21['error']:.3e}, converged {st21['converged']}, boundary_active {st21['boundary_active']}, launches "
          f"{l21}", flush=True)
    if not st21["converged"] or any(l21.values()):
        fail(f"phase 21: the fallback step did not converge unpacked: {st21}, launches {l21}")
    # honey_coil 72^3 at tile 16 (72 = 4.5 tiles): the packed layout does
    # not take it, so use_pallas=True runs unpacked, without error
    g72, s72 = honey_coil(n=72, dtype=torch.float32, device=dev)
    p72 = p_t.replace(max_iterations=20000)
    if solver._use_packed(g72, p72):
        fail("phase 21: tile 16 does not divide 72, yet the packed path would be taken")
    st72, l72 = step_counted(g72, s72, p72)
    print(f"phase 21 honey_coil 72^3 tile 16 with use_pallas=True (unpacked): iterations {st72['iterations']}, error "
          f"{st72['error']:.3e}, converged {st72['converged']}, n_regions {st72['n_regions']}, launches {l72}",
          flush=True)
    if not st72["converged"] or any(l72.values()):
        fail(f"phase 21: honey_coil 72^3 at tile 16 did not run unpacked cleanly: {st72}, launches {l72}")
    del g72, s72

    # -- phases 22-24
    phase_22_flip(grid, scene, p_t, table, p32t)
    phase_23_multigrid(grid, scene, p_t, table, ut1)
    phase_24_host_cc(grid, scene, p_a, table)

    # -- phase 25: the bf16 coefficient stack (coeff_bf16).  Each bf16 form
    # against its twin on the bf16 stack at phase 2's shapes and inputs,
    # timed as there, its bound with the coefficient channels at 2 bytes,
    # beside its f32 form; the bf16 applies' symmetry at 128^3; the bf16
    # paths with their launches
    bf = torch.bfloat16
    c16, cu16, red16 = pa.pack_coeffs(asm, cls, storage_dtype=bf), pa.pack_coeffs(asm_u, storage_dtype=bf), red.to(bf)
    gen25 = torch.Generator(device=dev).manual_seed(25)
    r25, q25 = ((torch.randn((7,) + grid.res, generator=gen25, device=dev) * mask).contiguous() for _ in range(2))
    f25 = pa.pack_arrow_factors(solver.precond_factors_packed(grid, cls, asm, p_a))
    v25 = algebra(pa.moments_packed_plain(xp, c16, TILE))
    u25 = pa.expand_packed_plain(v25, red16, TILE)
    og25 = pa.grid_mom_pap_packed_plain(xp, c16, TILE)[0]
    s25 = pa.forward_s_packed_plain(xp, c16)
    cases25 = {
        "moments": (lambda: pa.moments_packed(xp, c16, TILE), lambda: pa.moments_packed_plain(xp, c16, TILE), mom_bytes),
        "expand": (lambda: pa.expand_packed(v25, red16, TILE), lambda: pa.expand_packed_plain(v25, red16, TILE),
                   mom_bytes),
        "apply_reduced": (lambda: pa.apply_reduced_packed(xp, c16, u25),
                          lambda: pa.apply_reduced_packed_plain(xp, c16, u25), 0),
        "grid_mom_pap": (lambda: pa.grid_mom_pap_packed(xp, c16, TILE), lambda: pa.grid_mom_pap_packed_plain(xp, c16, TILE),
                         2 * mom_bytes),
        "finish": (lambda: pa.finish_packed(c16, og25, u25), lambda: pa.finish_packed_plain(c16, og25, u25), 0),
        "apply_uniform_pap": (lambda: pa.apply_uniform_pap_packed(xu, cu16),
                              lambda: pa.apply_uniform_pap_packed_plain(xu, cu16), 0),
        "apply_uniform": (lambda: pa.apply_uniform_packed(xu, cu16), lambda: pa.apply_uniform_packed_plain(xu, cu16), 0),
        "transpose_u": (lambda: pa.transpose_u_packed(c16, u25), lambda: pa.transpose_u_packed_plain(c16, u25), 0),
        "forward_s": (lambda: pa.forward_s_packed(xp, c16), lambda: pa.forward_s_packed_plain(xp, c16), 0),
        "combine": (lambda: pa.combine_packed(xp, c16, s25, u25), lambda: pa.combine_packed_plain(xp, c16, s25, u25), 0),
        "finish_update": (lambda: pa.finish_update_packed(xp, r25, q25, alpha, c16, og25, u25, f25, "arrow"),
                          lambda: pa.finish_update_packed_plain(xp, r25, q25, alpha, c16, og25, u25, f25, "arrow"), 0),
        "exp_finish_update": (
            lambda: pa.exp_finish_update_packed(xp, r25, q25, alpha, c16, og25, v25, TILE, f25, "arrow"),
            lambda: pa.exp_finish_update_packed_plain(xp, r25, q25, alpha, c16, og25, v25, TILE, f25, "arrow"), mom_bytes),
    }
    for name, (kernel, twin, small_bytes) in cases25.items():
        kind = "arrow" if name in ("finish_update", "exp_finish_update") else None
        before = dict(pa.LAUNCHES)
        kernel()
        torch.cuda.synchronize()
        if pa.LAUNCHES[name + BF16] != before[name + BF16] + 1 or pa.LAUNCHES[name] != before[name]:
            fail(f"phase 25 {name}: the bf16 stack did not launch the bf16 form")
        m = measure(name, kernel, twin, small_bytes, kind, where=" bf16", stored_itemsize=2)
        f32 = table[name]
        src, replaces = KERNELS[name][:2]
        table[name + BF16] = {"name": name + BF16, "route": "cuda", "source": f"polystokes_tpu_torch/csrc/{src}",
                              "replaces": replaces, "storage": "bfloat16 coefficient stack", "launches": None, **m,
                              "library_ms": None, "launches_by_path": {}, "f32_device_ms": f32["device_ms"],
                              "f32_bound_ms": f32["bound_ms"]}
        print(f"phase 25 {name}: bf16 device {m['device_ms']:.4f} ms against f32 {f32['device_ms']:.4f} ms "
              f"({m['device_ms'] / f32['device_ms']:.3f}x); bound {m['bound_ms']:.4f} ms against {f32['bound_ms']:.4f}",
              flush=True)
    del cases25, kernel, twin
    for label, p, x, y, c_cls, c_asm in (("reduced", p_a, xp, yp, cls, asm), ("uniform", p_b, xu, yu, cls_u, asm_u)):
        r_ = effective_max_regions(grid, p)
        a16 = solver.make_apply_packed(grid, c_cls, c_asm, p.replace(coeff_bf16=True), r_)
        a32 = solver.make_apply_packed(grid, c_cls, c_asm, p, r_)
        ax16, ax32 = a16(x), a32(x)
        y_ax = float((y.double() * ax16.double()).sum())
        ay_x = float((a16(y).double() * x.double()).sum())
        asym, d16 = abs(y_ax - ay_x) / abs(y_ax), float((ax16 - ax32).abs().max()) / float(ax32.abs().max())
        print(f"phase 25 {label} bf16 apply: symmetry rel {asym:.3e}; against the f32 stack's apply rel {d16:.3e}",
              flush=True)
        if not (asym <= SYM_RTOL and d16 < 0.03):
            fail(f"phase 25 {label} bf16 apply: symmetry {asym}, distance from f32 {d16}")
    bf16_runs = {}
    for path, p, repeat, base in (("A_bf16", p_a, True, st1), ("A_t_bf16", p_t, True, sa1), ("F_bf16", p_f, True, sf1),
                                  ("B_bf16", p_b, True, sb1), ("R_bf16", p_r, False, sr1),
                                  ("F_prime_bf16", p_f.replace(fuse_expand=False), False, None)):
        p16 = p.replace(coeff_bf16=True)
        n_check = (lambda n: n == 0) if path == "B_bf16" else (lambda n: n >= 1)
        runs = [drive(f"phase 25 {path} {N_MAIN}^3 run {i + 1}", p16, n_check) for i in range(2 if repeat else 1)]
        for vel_, st_, l_ in runs:
            check_launches(path, f"phase 25 {path}", st_, l_)
        if repeat:
            check_repeat(f"phase 25 {path}", runs[0][0], runs[0][1], runs[1][0], runs[1][1])
        st16 = runs[0][1]
        bf16_runs[path] = st16
        if base is not None:
            ms = " ".join(f"{r[1]['ms_per_apply']:.4f}" for r in runs)
            print(f"phase 25 {path} against f32: iterations {st16['iterations']} ({base['iterations']}), error "
                  f"{st16['error']:.3e} ({base['error']:.3e}), ms per apply {ms} ({base['ms_per_apply']:.4f})", flush=True)
    del c16, cu16, red16, r25, q25, f25, v25, u25, og25, s25

    # -- phase 26: A-DEF2 deflation (k = 3584) on A_t, B and S16 at
    # deflation_tile 32: E built twice bit-equal, its setup seconds; two
    # deflated steps each, converged, graphed, bit-equal, with their launches;
    # iterations and ms per apply beside the undeflated step's; a deflated
    # 32^3 step on the card against the CPU
    for path, p, case, base in (("A_t_defl", p_t, (grid, scene), sa1), ("B_defl", p_b, (grid, scene), sb1),
                                ("S16_defl", solver.sample_density(scene_si, p_t).replace(deflation_tile=32),
                                 (grid_si, scene_si), s16_stats)):
        pd = p.replace(deflation=True)
        g, sc = case
        c_cls, c_asm = solver._setup(g, sc, pd)
        builds = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = solver._make_deflation(g, c_cls, c_asm, pd)
            torch.cuda.synchronize()
            builds.append((d, time.perf_counter() - t0))
        (d1, t1), (d2, t2) = builds
        e_equal = torch.equal(d1.e, d2.e) and torch.equal(d1.einv, d2.einv)
        print(f"phase 26 {path}: k {d1.e.shape[0]} (coarse lattice {d1.cs}, tile {d1.tile}), E built in {t1:.3f} and "
              f"{t2:.3f} s ({DEFL_PROBES} probe applies, the assembly and the inverse), bit-equal {e_equal}", flush=True)
        if not e_equal or d1.e.shape[0] != 3584:
            fail(f"phase 26 {path}: E differs between two builds or k != 3584")
        del builds, d1, d2, d, c_cls, c_asm
        runs = [drive(f"phase 26 {path} timed {i + 1}", pd, (lambda n: n == 0) if path == "B_defl" else (lambda n: n >= 1),
                      case) for i in range(2)]
        for vel_, st_, l_ in runs:
            check_launches(path, f"phase 26 {path}", st_, l_, record=False)
            if not st_["capture_seconds"] > 0.0:
                fail(f"phase 26 {path}: the deflated pass was not captured in a CUDA graph")
        check_repeat(f"phase 26 {path}", runs[0][0], runs[0][1], runs[1][0], runs[1][1])
        st_d = runs[0][1]
        print(f"phase 26 {path} against undeflated: iterations {st_d['iterations']} ({base['iterations']}), ms per "
              f"apply {runs[0][1]['ms_per_apply']:.4f} {runs[1][1]['ms_per_apply']:.4f} ({base['ms_per_apply']:.4f}), "
              f"step s {runs[0][1]['seconds']:.3f} {runs[1][1]['seconds']:.3f} ({base['seconds']:.3f}), capture "
              f"{st_d['capture_seconds']:.3f} s, peak device memory {st_d['peak_gib']:.3f} GiB", flush=True)
        del runs
    p32d = p32t.replace(deflation=True)
    print(f"phase 26 deflated {N_CPU}^3 tile {TILE_8}, card and CPU:", flush=True)
    agree(f"phase 26 deflated {N_CPU}^3 tile {TILE_8} velocities, card against CPU", step_32("cuda", p32d),
          step_32("cpu", p32d))

    t27 = time.perf_counter()
    # -- phase 27: the x-slab step.  The halo forms of kernels 1, 3 and 7 on
    # SLABS slabs cut from phase 2's inputs (windows of the zero-padded
    # arrays, HALO_X planes deeper on either side), the stack in f32 and in
    # bf16: each slab against the twin, the slabs joined against phase 2's
    # form without a halo, the middle slab timed beside the form without a
    # halo on the same planes.  The bound counts each input over nxl + 2
    # planes: the kernels read one halo plane a side of the HALO_X
    # (fused_apply.cu)
    halo_x = pa.HALO_X
    nxl = N_MAIN // SLABS

    def halo_slabs(t):
        if t is None:
            return [None] * SLABS
        padded = torch.nn.functional.pad(t, (0, 0, 0, 0, halo_x, halo_x))
        return [padded[:, i * nxl:(i + 1) * nxl + 2 * halo_x].contiguous() for i in range(SLABS)]

    def halo_kernel(name, basis, twin=False):
        """f(x, c, u, halo): the kernel's wrapper, or its twin."""
        if name == "moments":
            f = pa.moments_packed_plain if twin else pa.moments_packed
            return lambda x_, c_, u_, h: f(x_, c_, TILE, basis, halo=h)
        if name == "apply_reduced":
            f = pa.apply_reduced_packed_plain if twin else pa.apply_reduced_packed
            return lambda x_, c_, u_, h: f(x_, c_, u_, halo=h)
        f = pa.apply_uniform_packed_plain if twin else pa.apply_uniform_packed
        return lambda x_, c_, u_, h: f(x_, c_, halo=h)

    bf = torch.bfloat16
    c16, cu16 = pa.pack_coeffs(asm, cls, storage_dtype=bf), pa.pack_coeffs(asm_u, storage_dtype=bf)
    quad, aff = BasisOrder.QUADRATIC, BasisOrder.AFFINE
    # row: (kernel, basis, x, stack, u, bytes of a stored coefficient value)
    halo_rows = {"moments_halo": ("moments", quad, xp, coeffs, None, None),
                 "moments_halo_k4": ("moments", aff, xp, coeffs, None, None),
                 "apply_reduced_halo": ("apply_reduced", quad, xp, coeffs, u_twin, None),
                 "apply_uniform_halo": ("apply_uniform", quad, xu, coeffs_u, None, None),
                 "moments_halo_bf16": ("moments", quad, xp, c16, None, 2),
                 "apply_reduced_halo_bf16": ("apply_reduced", quad, xp, c16, u_twin, 2),
                 "apply_uniform_halo_bf16": ("apply_uniform", quad, xu, cu16, None, 2)}
    for row, (name, basis, x_, c_, u_, stored) in halo_rows.items():
        kern, twin = halo_kernel(name, basis), halo_kernel(name, basis, twin=True)
        xs, cs, us = halo_slabs(x_), halo_slabs(c_), halo_slabs(u_)
        counter = name + HALO + (BF16 if stored else "")
        pieces, worst = [], 0.0
        for i in range(SLABS):
            before = dict(pa.LAUNCHES)
            got = kern(xs[i], cs[i], us[i], halo_x)
            torch.cuda.synchronize()
            if {k: pa.LAUNCHES[k] - before[k] for k in before if pa.LAUNCHES[k] != before[k]} != {counter: 1}:
                fail(f"phase 27 {row}: slab {i} did not launch {counter} once")
            worst = max(worst, compare(name, got, twin(xs[i], cs[i], us[i], halo_x), f"{row} slab {i}"))
            pieces.append(got)
        joined = torch.cat(pieces, dim=0 if name == "moments" else 1)
        whole_equal = torch.equal(joined, kern(x_, c_, u_, 0))
        small = pieces[1].numel() * pieces[1].element_size() if name == "moments" else 0
        m = measure(name, lambda: kern(xs[1], cs[1], us[1], halo_x), lambda: twin(xs[1], cs[1], us[1], halo_x), small,
                    slots=plane // SLABS, where=f" {row} slab 1 of {SLABS}", stored_itemsize=stored,
                    slots_in=plane // SLABS * (nxl + 2) // nxl)
        m["max_abs_err"] = worst
        inner = [None if t is None else t[:, halo_x:halo_x + nxl].contiguous() for t in (xs[1], cs[1], us[1])]
        ms_plain_form = graph_ms(lambda: kern(*inner, 0))
        base = table[name + (K4 if basis == aff else "") + (BF16 if stored else "")]
        table[row] = {"name": row, "route": "cuda", "source": f"polystokes_tpu_torch/csrc/{KERNELS[name][0]}",
                      "replaces": KERNELS[name][1], "halo": halo_x, "slab": [nxl + 2 * halo_x, N_MAIN, N_MAIN],
                      "launches": None, **m, "library_ms": None, "launches_by_path": {},
                      "no_halo_same_slab_device_ms": ms_plain_form, "whole_array_device_ms": base["device_ms"]}
        print(f"phase 27 {row}: slabs within {worst:.3e} of the twins, joined bit-equal to phase 2's form without a "
              f"halo {whole_equal}; device {m['device_ms']:.4f} ms against {ms_plain_form:.4f} ms without a halo on "
              f"the same planes ({m['device_ms'] / ms_plain_form:.3f}x), {SLABS} slabs against the whole array's "
              f"{base['device_ms']:.4f} ms ({SLABS * m['device_ms'] / base['device_ms']:.3f}x); bound "
              f"{m['bound_ms']:.4f} ms ({m['bound_by']})", flush=True)
        if not whole_equal:
            fail(f"phase 27 {row}: the slabs joined differ from the form without a halo")
    del c16, cu16, xs, cs, us, pieces, joined, inner, kern, twin

    # the sharded apply at 2 and SLABS slabs of the card against the
    # unsharded (unfused) apply, on A's, A_t's and B's systems
    cls_t, asm_t = solver._setup(grid, scene, p_t)
    ref_t = None
    for label, p, c_cls, c_asm, x_ in (("A", p_a, cls, asm, xp), ("A_t", p_t, cls_t, asm_t, xp),
                                       ("B", p_b, cls_u, asm_u, xu)):
        r_ = effective_max_regions(grid, p)
        unsharded = solver.make_apply_packed(grid, c_cls, c_asm, p, r_)
        ref = unsharded(x_)
        ref_t = ref if label == "A_t" else ref_t
        ms_ref = graph_ms(lambda: unsharded(x_))
        for n in (2, SLABS):
            sharded = make_apply_packed_sharded(grid, c_cls, c_asm, p, r_, make_mesh([dev] * n, axes=("x",)))
            equal = torch.equal(sharded(x_), ref)
            ms_sh = graph_ms(lambda: sharded(x_))
            print(f"phase 27 sharded apply {label} on {n} slabs of the card: bit-equal to the unsharded apply {equal}; "
                  f"device {ms_sh:.4f} ms an apply against {ms_ref:.4f} ms unsharded ({ms_sh / ms_ref:.3f}x)", flush=True)
            if not equal:
                fail(f"phase 27: the sharded apply of {label} on {n} slabs differs from the unsharded apply")
        del unsharded, sharded

    # sharded_step on A_t's system at SLABS slabs, twice, against the
    # unsharded unfused step; then B, A_aff and the bf16 A_t and B once each
    mesh_s = make_mesh([dev] * SLABS, axes=("x",))
    vel_u, st_u, l_u = drive(f"phase 27 A_t_unfused {N_MAIN}^3 tile {TILE} (fuse_pap=False, unsharded)",
                             p_t.replace(fuse_pap=False), tiled)
    check_launches("A_t_unfused", "phase 27 A_t_unfused", st_u, l_u, record=False)
    runs = [drive(f"phase 27 A_t_s4 {N_MAIN}^3 tile {TILE} on {SLABS} slabs of the card, run {i + 1}", p_t, tiled,
                  mesh=mesh_s) for i in range(2)]
    for vel_, st_, l_ in runs:
        check_launches("A_t_s4", "phase 27 A_t_s4", st_, l_)
        if not st_["capture_seconds"] > 0.0:
            fail("phase 27 A_t_s4: the sharded pass was not captured in a CUDA graph")
    check_repeat("phase 27 A_t_s4", runs[0][0], runs[0][1], runs[1][0], runs[1][1])
    st_s = runs[0][1]
    same = st_s["iterations"] == st_u["iterations"] and all(torch.equal(a, b) for a, b in zip(runs[0][0], vel_u))
    print(f"phase 27 A_t_s4 against A_t_unfused: iterations {st_s['iterations']} ({st_u['iterations']}), velocities "
          f"bit-equal {same}; ms per apply {runs[0][1]['ms_per_apply']:.4f} {runs[1][1]['ms_per_apply']:.4f} "
          f"(unfused {st_u['ms_per_apply']:.4f}, A_t fused {sa1['ms_per_apply']:.4f}); step s "
          f"{runs[0][1]['seconds']:.3f} {runs[1][1]['seconds']:.3f} ({st_u['seconds']:.3f}); capture "
          f"{st_s['capture_seconds']:.3f} s; peak device memory {st_s['peak_gib']:.3f} GiB ({st_u['peak_gib']:.3f})",
          flush=True)
    if not same:
        fail("phase 27: the sharded step differs from the unsharded unfused step")
    del runs
    for path, p in (("B_s4", p_b), ("A_aff_s4", p_t.replace(basis=BasisOrder.AFFINE)),
                    ("A_t_s4_bf16", p_t.replace(coeff_bf16=True)), ("B_s4_bf16", p_b.replace(coeff_bf16=True))):
        _, st_, l_ = drive(f"phase 27 {path} {N_MAIN}^3 on {SLABS} slabs of the card", p,
                           (lambda n: n == 0) if path.startswith("B") else tiled, mesh=mesh_s)
        check_launches(path, f"phase 27 {path}", st_, l_)

    # a solve the slab path cannot take: a 2 x 2 mesh warns and runs the
    # unpacked step on the first device, launching no kernel
    g32, s32 = honey_coil(n=N_CPU, dtype=torch.float32, device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pa.reset_launches()
        _, _, st_g = sharded_step(g32, p32t, make_mesh([dev] * 4))(s32)
        torch.cuda.synchronize()
    warned = any("shard_map" in str(w.message) for w in caught)
    print(f"phase 27 gated {N_CPU}^3 on a 2 x 2 mesh: warned {warned}, sharded {st_g['sharded']}, iterations "
          f"{st_g['iterations']}, converged {st_g['converged']}, launches {sum(pa.LAUNCHES.values())}", flush=True)
    if not (warned and st_g["converged"] and st_g["sharded"] is False and not any(pa.LAUNCHES.values())):
        fail("phase 27: the gated solve did not warn, did not converge or launched kernels")
    t0 = time.perf_counter()
    dryrun_multichip(8)
    print(f"phase 27 dryrun_multichip(8) on the card: {time.perf_counter() - t0:.2f} s", flush=True)

    # two cards: the apply and the step on a slab of each (eager: no graph
    # across devices)
    if torch.cuda.device_count() >= 2:
        mesh2 = make_mesh(["cuda:0", "cuda:1"], axes=("x",))
        sharded = make_apply_packed_sharded(grid, cls_t, asm_t, p_t, effective_max_regions(grid, p_t), mesh2)
        equal = torch.equal(sharded(xp), ref_t)
        vel2, st2, l2 = drive(f"phase 27 A_t on cuda:0 and cuda:1", p_t, tiled, mesh=mesh2)
        applies = 1 + st2["loop_passes"]
        want = {"moments_halo": 2 * applies, "expand": 2 * applies, "apply_reduced_halo": 2 * applies}
        same = st2["iterations"] == st_u["iterations"] and all(torch.equal(a, b) for a, b in zip(vel2, vel_u))
        print(f"phase 27 two cards: apply bit-equal {equal}; step bit-equal to A_t_unfused {same}, ms per apply "
              f"{st2['ms_per_apply']:.4f}, capture {st2['capture_seconds']:.3f} s", flush=True)
        if not (equal and same and {k: v for k, v in l2.items() if v} == want and st2["capture_seconds"] == 0.0):
            fail("phase 27: the two-card mesh differs from one card or launched otherwise")
        del sharded, vel2
    else:
        print(f"phase 27: the machine has {torch.cuda.device_count()} card, so no two-card mesh ran", flush=True)
    del vel_u, cls_t, asm_t, ref_t
    print(f"phase 27 wall: {time.perf_counter() - t27:.1f} s", flush=True)

    phase_28_export(grid, scene, cls, asm, p_a, table)

    for name, entry in table.items():
        if MAIN_PATH[name] is None:
            entry["launches"] = 0
            print(f"{name}: no caller in either package, run on no path (checked in phases 2 and 3)", flush=True)
            continue
        entry["launches"] = entry["launches_by_path"].get(MAIN_PATH[name], 0)
        if entry["launches"] <= 0:
            fail(f"{name} was not launched on its path {MAIN_PATH[name]}")

    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s from phase 0", flush=True)
    print(json.dumps({"kernels": list(table.values())}), flush=True)
    print(card_line(), flush=True)  # nvidia-smi's own "name, power.limit" line
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
