"""The command line: run one or more Stokes solves on a built-in scene, the
counterpart of ``polystokes_tpu.run`` with its flags, defaults and printed
lines.

    python -m polystokes_tpu_torch.run --scene honey_coil --n 64 --steps 1 \
        --tile-size 16 --tile-padding 2 --tolerance 1e-3 \
        [--uniform] [--params params.json] [--checkpoint out/ck.npz] \
        [--resume out/ck.npz] [--pallas] [--precond multigrid] \
        [--chunked | --crop | --flip P | --sim | --profile | --solver eigen] \
        [--scheme all_dofs] [--export-prefix out/run. [--export-mtx] [--viz]] \
        [--device cpu]

The analog of driving the reference node from a Houdini scene: the same
knobs (exec/HDK_PolyStokes.C:86-220) exposed as flags, stats printed per
step (printStats parity), optional operator/grid export and
checkpointing.  It runs on the CUDA card unless ``--device cpu`` is
given.  As in the JAX package, the solve runs
the unpacked apply unless ``--pallas`` selects the packed kernels, which
``solver.check_pallas`` turns off, with a warning, for a scene with liquid
on the domain's index-0 planes; ``--profile`` prints the per-stage times
of ``profiling.step_instrumented``; ``--flip P`` runs FLIP frames with P
particle slots (``flip.flip_frame``, without reseeding, as the JAX CLI
does); ``--solver eigen`` solves the ``--scheme``'s explicit system on the
host (``host_solve.solve_host``: setup and write-back on the device,
scipy between).  After the steps, ``--export-prefix`` (or the export
switches of ``--params``) writes the grids, the component matrices (npz,
or MatrixMarket under ``--export-mtx``) and the last step's stats
(``export.py``), and ``--viz`` renders the grids to PNG (``viz.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="honey_coil", help="scene builder name")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--viscosity", type=float, default=None)
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--tile-size", type=int, default=16)
    p.add_argument("--tile-padding", type=int, default=2)
    p.add_argument("--liquid-band", type=int, default=2)
    p.add_argument("--solid-band", type=int, default=2)
    p.add_argument("--tolerance", type=float, default=1e-3)
    p.add_argument("--max-iterations", type=int, default=5000)
    p.add_argument("--uniform", action="store_true", help="disable reduced regions")
    p.add_argument("--no-tile", action="store_true")
    p.add_argument("--affine", action="store_true", help="11-DOF affine basis")
    p.add_argument("--fp64", action="store_true")
    p.add_argument("--precond", default="identity",
                   choices=["identity", "diagonal", "cell_arrow", "multigrid", "region_arrow"],
                   help="device preconditioner (PreconditionerType)")
    p.add_argument("--diag-precond", action="store_true", help="alias for --precond diagonal")
    p.add_argument("--deflation", action="store_true",
                   help="A-DEF2 two-level deflation on top of the preconditioner")
    p.add_argument("--deflation-tile", type=int, default=0,
                   help="coarse cube size for --deflation (0 = tile size)")
    p.add_argument("--solver", default="pcg", choices=["pcg", "eigen"],
                   help="pcg = device matrix-free; eigen = host explicit path")
    p.add_argument("--scheme", default="pressure_stress",
                   choices=["pressure_stress", "all_dofs", "pressure_velocity",
                            "all_dofs_explicit_interior_stress"],
                   help="matrix scheme for --solver eigen")
    p.add_argument("--pallas", action="store_true",
                   help="the packed kernel apply (pre-flight checked; falls back to the unpacked apply if the "
                   "scene touches the domain box)")
    p.add_argument("--fuse-update", action="store_true",
                   help="fused CG update kernels (packed path)")
    p.add_argument("--bf16-coeffs", action="store_true",
                   help="store the loop-constant coefficient stack in bfloat16")
    p.add_argument("--params", help="JSON file overriding SolverParams")
    p.add_argument("--export-prefix", help="export grids/components/stats with this prefix")
    p.add_argument("--export-mtx", action="store_true", help="MatrixMarket instead of npz")
    p.add_argument("--viz", action="store_true", help="render exported grids to PNG slice maps")
    p.add_argument("--checkpoint", help="write a checkpoint npz after the run")
    p.add_argument("--resume", help="resume from a checkpoint npz")
    p.add_argument("--profile", action="store_true", help="per-stage instrumented run")
    p.add_argument("--sim", action="store_true",
                   help="frame loop: gravity + solve + grid semi-Lagrangian advection (sim.py)")
    p.add_argument("--flip", type=int, default=0, metavar="P",
                   help="frame loop with a P-particle FLIP transfer")
    p.add_argument("--gravity", type=float, default=-9.8)
    p.add_argument("--crop", action="store_true",
                   help="solve on the liquid's bounding box (domain.solve_cropped); implies --chunked")
    p.add_argument("--chunked", action="store_true",
                   help="chunked solve loop: K-iteration device segments with host "
                   "checks between (cancellable with Ctrl-C, reference opInterrupt parity)")
    p.add_argument("--segment-iters", type=int, default=500, help="iterations per chunk")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="wall-clock budget for the chunked solve (partial result after)")
    p.add_argument("--solver-state", help="persist the Krylov state here after each segment")
    p.add_argument("--resume-solver", action="store_true",
                   help="resume the chunked solve from --solver-state")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scene and the solve live (the CUDA card unless cpu)")
    return p


def _params(args):
    """SolverParams from the flags, field for field as the JAX package's
    CLI builds them, then ``--params`` over them."""
    import torch

    from .config import BasisOrder, MatrixScheme, PreconditionerType, SolverParams, SolverType
    from .io.checkpoint import params_from_json

    params = SolverParams(
        dtype=torch.float64 if args.fp64 else torch.float32,
        do_reduced_regions=not args.uniform,
        do_tile=not args.no_tile,
        tile_size=args.tile_size,
        tile_padding=args.tile_padding,
        liquid_boundary_layer_size=args.liquid_band,
        solid_boundary_layer_size=args.solid_band,
        tolerance=args.tolerance,
        max_iterations=args.max_iterations,
        basis=BasisOrder.AFFINE if args.affine else BasisOrder.QUADRATIC,
        preconditioner=PreconditionerType.DIAGONAL if args.diag_precond else PreconditionerType(args.precond),
        solver_type=SolverType.EIGEN if args.solver == "eigen" else SolverType.PCG_MATRIX_VECTOR_PRODUCTS,
        matrix_scheme=MatrixScheme(args.scheme),
        use_pallas=args.pallas,
        fuse_update=args.fuse_update,
        coeff_bf16=args.bf16_coeffs,
        deflation=args.deflation,
        deflation_tile=args.deflation_tile,
    )
    if args.params:
        with open(args.params) as f:
            params = params_from_json(f.read(), base=params)
    return params


def _line(label, k, seconds, stats, extra=""):
    return (f"{label} {k}: {seconds:.3f}s  iters={int(stats['iterations'])}  err={float(stats['error']):.3e}"
            f"  converged={bool(stats['converged'])}{extra}  regions={int(stats['n_regions'])}")


def _export(args, grid, scene, params, stats):
    """The JAX CLI's export block: the grids, the component matrices and
    the last step's stats of the scene after the steps, under the prefix;
    with ``--viz`` the grids rendered to PNG."""
    from .classify import classify, effective_max_regions
    from .config import SolverType
    from .export import ExplicitOperators, export_component_matrices, export_grids, export_stats
    from .solver import assemble
    from .weights import compute_weights

    prefix = args.export_prefix or params.export_prefix
    R = effective_max_regions(grid, params)
    lw, fw = compute_weights(grid, scene.surface_sdf, scene.collision_sdf, params.dtype)
    cls = classify(grid, lw, fw, params)
    asm, _ = assemble(grid, scene, cls, lw, fw, params, R)
    ops = ExplicitOperators(grid, cls, asm, params, weights=(lw, fw), viscosity=scene.viscosity)
    if args.export_prefix or params.export_matrices:
        export_grids(prefix, cls, lw, fw)
    if args.export_prefix or params.export_component_matrices:
        export_component_matrices(prefix, ops, fmt="mtx" if args.export_mtx else "npz")
    if args.export_prefix or params.export_stats:
        export_stats(prefix, stats, from_device=params.solver_type != SolverType.EIGEN)
    print(f"exported to {prefix}*")
    if args.viz:
        from .viz import render_npz

        for f in render_npz(prefix + "grids.npz"):
            print(f"rendered {f}")


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import torch

    from .config import SolverType
    from .io.checkpoint import load_checkpoint, save_checkpoint
    from .scenes.builders import SCENES
    from .solver import check_pallas, sample_density

    if args.resume:
        if not os.path.exists(args.resume):
            sys.exit(f"error: checkpoint not found: {args.resume}")
        grid, scene, params, start, _ = load_checkpoint(args.resume, device=args.device)
    else:
        params = _params(args)
        kw = {}
        if args.viscosity is not None:
            kw["viscosity"] = args.viscosity
        if args.dt is not None:
            kw["dt"] = args.dt
        if args.scene not in SCENES:
            sys.exit(f"error: unknown scene '{args.scene}' (available: {', '.join(sorted(SCENES))})")
        grid, scene = SCENES[args.scene](n=args.n, dtype=params.dtype, device=args.device, **kw)
        start = 0

    params = sample_density(scene, params)  # HDK_PolyStokes.C:290-304 parity
    params = check_pallas(grid, scene, params)

    def sync():
        if scene.surface_sdf.is_cuda:
            torch.cuda.synchronize(scene.surface_sdf.device)

    if args.profile:
        from .profiling import print_stats, step_instrumented

        for k in range(start, start + args.steps):
            vel, valid, stats = step_instrumented(grid, scene, params)
            print(f"step {k}:  converged={stats['converged']}  regions={stats['n_regions']}")
            print_stats(stats)
            scene = dataclasses.replace(scene, velocity=vel)
    elif args.chunked or args.crop:
        from .solver import solve_chunked

        if args.crop:
            from .domain import solve_cropped as solve_chunked  # noqa: F811

        def progress(s):
            print(f"  segment done: iters={s['iterations']}  rre={s['rre']:.3e}", flush=True)
            return False

        for k in range(start, start + args.steps):
            t0 = time.perf_counter()
            vel, valid, stats = solve_chunked(
                grid, scene, params,
                segment_iters=args.segment_iters,
                max_seconds=args.max_seconds,
                callback=progress,
                state_path=args.solver_state,
                resume=args.resume_solver,
            )
            sync()
            print(_line("step", k, time.perf_counter() - t0, stats, f"  interrupted={stats['interrupted']}"), flush=True)
            scene = dataclasses.replace(scene, velocity=vel)
    elif params.solver_type == SolverType.EIGEN:
        from .host_solve import solve_host

        for k in range(start, start + args.steps):
            t0 = time.perf_counter()
            vel, valid, stats = solve_host(grid, scene, params)
            sync()
            print(f"step {k}: {time.perf_counter() - t0:.3f}s  scheme={stats['scheme']}"
                  f"  converged={bool(stats['converged'])}  regions={int(stats['n_regions'])}", flush=True)
            scene = dataclasses.replace(scene, velocity=vel)
    elif args.flip:
        from .flip import flip_frame, seed_particles

        state = seed_particles(grid, scene.surface_sdf, args.flip, dtype=params.dtype)
        print(f"seeded {int(state.alive.sum())} / {args.flip} particles")
        for k in range(start, start + args.steps):
            t0 = time.perf_counter()
            scene, state, stats = flip_frame(grid, scene, state, params, gravity=args.gravity)
            sync()
            print(_line("frame", k, time.perf_counter() - t0, stats), flush=True)
    elif args.sim:
        from .sim import cfl_substeps, simulate_frame

        for k in range(start, start + args.steps):
            t0 = time.perf_counter()
            substeps = cfl_substeps(scene.velocity, float(scene.dt) / grid.dx)
            scene, stats = simulate_frame(grid, scene, params, gravity=args.gravity, substeps=substeps)
            sync()
            print(_line("frame", k, time.perf_counter() - t0, stats), flush=True)
    else:
        from .solver import step

        for k in range(start, start + args.steps):
            t0 = time.perf_counter()
            vel, valid, stats = step(grid, scene, params)
            sync()
            print(_line("step", k, time.perf_counter() - t0, stats), flush=True)
            scene = dataclasses.replace(scene, velocity=vel)

    # exports: the CLI flag takes precedence, otherwise the SolverParams
    # export knobs drive what gets written (exportMatrices /
    # exportComponentMatrices / exportStats toggles, HDK_PolyStokes.C:189-206)
    if args.export_prefix or params.export_matrices or params.export_component_matrices or params.export_stats:
        _export(args, grid, scene, params, stats)

    if args.checkpoint:
        save_checkpoint(args.checkpoint, grid, scene, params, start + args.steps)
        print(f"checkpoint written to {args.checkpoint}")


if __name__ == "__main__":
    main()
