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
     3): A_t, Path A on honey_coil 128^3, warm and twice timed with phase
     4's checks (n_regions beside the TPU record's 152, printed); F_t (A_t
     with fuse_update and fuse_expand) and R_t (A_t with REGION_ARROW), one
     timed step each, converged with their paths' launches; S16 and S8,
     Path A on armadillo_melt_si 256^3 at tile 16 and tile 8 (the suite's
     configs 16 and 18, at the scene's density 1000 as the suite's
     sample_density sets it; n_regions beside 753 and 3542, printed),
     converged with their launches, with the setup seconds, ms per apply
     and peak device memory; and the tiled 32^3 step at tile 8 on the card
     against the CPU port (phase 10's bound).
Phase 2 also holds the tile-dependent kernels (moments, expand,
grid_mom_pap, exp_finish_update) against their twins at tile 8 on the
tiled armadillo_melt_si 256^3 setup of S8, with their device times and
shares of the bound.  Every earlier phase runs untiled (do_tile=False).
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
import statistics
import subprocess
import sys
import tempfile
import time

import torch

N_MAIN = 128
N_CPU = 32
TILE = 16
KERNEL_RTOL = 1e-5  # f32 sums of up to 4096 terms in another order than the twin
SYM_RTOL = 1e-5
PAP_RTOL = 1e-5  # the fused <x, A x> against the unfused one: f32, the symmetry bound
VEL_ATOL = 2e-4  # times max |v|: the packed-against-XLA bound of the JAX tests
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


# the tiled paths of phase 14 launch as their untiled counterparts
TILED_PATHS = {"A_t": "A", "F_t": "F", "R_t": "A_region", "S16": "A", "S8": "A"}
TILE_8 = 8
N_SI = 256
# the JAX suite's TPU records (BENCH_SUITE.json), printed beside ours, not held
JAX_REGIONS = {"A_t": 152, "S16": 753, "S8": 3542}


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
    """The untiled main path's parameters (every path of phases 2-13), with
    ``kw`` over them (phase 14 sets do_tile=True)."""
    from polystokes_tpu_torch import SolverParams

    base = dict(dtype=dtype, do_tile=False, tile_size=TILE, tile_padding=2, max_regions=64, tolerance=tol,
                max_iterations=max_iters)
    return SolverParams(**{**base, **kw})


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


def bound(name, plane, small_bytes, itemsize, kind="arrow"):
    """(ms, 'bytes' or 'operations'): the larger of the HBM time of the
    channels the kernel must read and write once (plus its small per-cube
    arrays) and the float32 time of its flops; an update kernel reads the
    factor channels of its preconditioner kind."""
    _, _, read, written, flops = KERNELS[name]
    if name in ("cg_update", "finish_update", "exp_finish_update"):
        read += UPDATE_FACTORS[kind] - UPDATE_FACTORS["arrow"]
    t_bytes = ((read + written) * plane * itemsize + small_bytes) / HBM_BYTES_PER_S
    t_ops = flops * plane / F32_FLOPS_PER_S
    return (1e3 * t_bytes, "bytes") if t_bytes >= t_ops else (1e3 * t_ops, "operations")


def expected_launches(path, applies):
    counts = dict.fromkeys(KERNELS, 0)
    path = TILED_PATHS.get(path, path)
    if path == "A":
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    from polystokes_tpu_torch import packed_apply as pa
    from polystokes_tpu_torch import PreconditionerType, solver
    from polystokes_tpu_torch.classify import effective_max_regions
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
            print(f"  {name} {dtype} at tile {TILE}: column {by} x {bz}, "
                  f"{window} bytes dynamic shared memory, {blocks} blocks per SM", flush=True)
        for name in ("apply_reduced", "apply_uniform", "apply_uniform_pap"):
            window, blocks = pa.window_occupancy(name, dtype, *uniform_plan[:2])
            print(f"  {name} {dtype} at {N_MAIN}^3: column {uniform_plan[0]} x {uniform_plan[1]}, run "
                  f"{uniform_plan[2]}, {window} bytes dynamic shared memory, {blocks} blocks per SM", flush=True)

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
    def measure(name, kernel, twin, small_bytes, kind=None, slots=plane, where=""):
        """Compare a kernel with its twin, time both and reckon its bound
        over ``slots`` slots of each channel."""
        label = (name if kind is None else f"{name} kind {kind}") + where
        got, ref = kernel(), twin()
        torch.cuda.synchronize()
        err = compare(name, got, ref, label)
        ms_twin = median_ms(twin)
        ms_kernel = median_ms(kernel)
        ms_device = graph_ms(kernel)
        bound_ms, bound_by = bound(name, slots, small_bytes, xp.element_size(), kind or "arrow")
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
    del rp, pp, factors

    # the tile-dependent kernels at tile 8, on the tiled armadillo_melt_si
    # 256^3 setup of phase 14's S8, kind arrow on its CELL_ARROW factors
    from polystokes_tpu_torch.scenes.builders import armadillo_melt_si

    grid_si, scene_si = armadillo_melt_si(n=N_SI, dtype=torch.float32, device=dev)
    # the constant density of the scene's field (1000), which the JAX suite
    # sets through solver.sample_density (benchmarks/suite.py:64); step
    # does not read the field
    si_density = float(scene_si.density.amin())
    p_s8 = params(torch.float32, 1e-3, 12000, fuse_pap=True, do_tile=True, tile_size=TILE_8,
                  constant_density=si_density)
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
    del cls8, asm8, coeffs8, algebra8, red8, f8, mask8, x8, r8, q8, v8, og8, cases8
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
    def drive(label, p, n_check=None, case=None):
        """step() on ``case`` (grid, scene), honey_coil 128^3 by default."""
        g, sc = case or (grid, scene)
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vel, _, stats = solver.step(g, sc, p)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(pa.LAUNCHES)
        applies = stats["operator_applies"]
        print(f"{label}: {seconds:.3f} s, iterations {stats['iterations']}, error {stats['error']:.3e}, "
              f"converged {stats['converged']}, boundary_active {stats['boundary_active']}, "
              f"n_regions {stats['n_regions']}, applies {applies}, loop passes {stats['loop_passes']}, "
              f"ms per apply (step wall / applies) {1e3 * seconds / max(applies, 1):.4f}, launches {launches}",
              flush=True)
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
                table[name]["launches_by_path"][path] = n
        if record:
            step_ms.setdefault(path, []).append(stats["ms_per_apply"])

    def check_repeat(label, vel1, st1, vel2, st2):
        bit_equal = all(torch.equal(a, b) for a, b in zip(vel1, vel2))
        print(f"{label} reproducible: iterations {st1['iterations']} and {st2['iterations']}, "
              f"velocities bit-equal {bit_equal}", flush=True)
        if not (st1["iterations"] == st2["iterations"] and bit_equal):
            fail(f"{label}: two steps on the same inputs differ")

    solver.check_pallas(grid, scene, p_a)
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

    for name, entry in table.items():
        if MAIN_PATH[name] is None:
            entry["launches"] = 0
            print(f"{name}: no caller in either package, run on no path (checked in phases 2 and 3)", flush=True)
            continue
        entry["launches"] = entry["launches_by_path"].get(MAIN_PATH[name], 0)
        if entry["launches"] <= 0:
            fail(f"{name} was not launched on its path {MAIN_PATH[name]}")

    def step_32(where, p):
        g32, s32 = honey_coil(n=N_CPU, dtype=torch.float32, device=where)
        t0 = time.perf_counter()
        v32, _, st32 = solver.step(g32, s32, p)
        print(f"  {where} {N_CPU}^3 {p.preconditioner.name} fuse_pap={p.fuse_pap} fuse_update={p.fuse_update}: "
              f"{time.perf_counter() - t0:.2f} s, iterations {st32['iterations']}, error {st32['error']:.3e}, "
              f"converged {st32['converged']}", flush=True)
        if not st32["converged"]:
            fail(f"{N_CPU}^3 step on {where} did not converge: {p}")
        return [c.double().cpu() for c in v32]

    def agree(label, v_a, v_b):
        vmax = max(float(c.abs().max()) for c in v_b)
        dv = max(float((a - b).abs().max()) for a, b in zip(v_a, v_b))
        print(f"{label}: max|dv| {dv:.3e} max|v| {vmax:.3e} rel {dv / vmax:.3e}", flush=True)
        if not dv <= VEL_ATOL * vmax:
            fail(f"{label}: velocities differ: {dv} > {VEL_ATOL} * {vmax}")

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
    solver.check_pallas(grid, scene, p_t)
    tiled = lambda n: n >= 1  # noqa: E731
    drive(f"phase 14 A_t {N_MAIN}^3 tile {TILE} warm", p_t, tiled)
    vel1, sa1, l1 = drive(f"phase 14 A_t {N_MAIN}^3 tile {TILE} timed 1", p_t, tiled)
    vel2, sa2, l2 = drive(f"phase 14 A_t {N_MAIN}^3 tile {TILE} timed 2", p_t, tiled)
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
        p_s = p_t.replace(tile_size=T, constant_density=si_density)
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
        _, st, launches = drive(f"phase 14 {label} armadillo_melt_si {N_SI}^3 tile {T}", p_s, tiled, (grid_si, scene_si))
        peak = torch.cuda.max_memory_allocated()
        check_launches(label, f"phase 14 {label}", st, launches, record=False)
        print(f"phase 14 {label}: n_regions {st['n_regions']} (the JAX suite's TPU record: {JAX_REGIONS[label]}); "
              f"setup (weights, classify, assemble) {t_set:.3f} s; ms per apply of the step without that setup "
              f"{1e3 * (st['seconds'] - t_set) / st['operator_applies']:.4f}; peak device memory in the step "
              f"{peak / 2**30:.3f} GiB, in its setup alone {peak_set / 2**30:.3f} GiB ({before / 2**30:.3f} GiB "
              f"held before them)", flush=True)
    p32t = params(torch.float32, 1e-5, 12000, fuse_pap=True, do_tile=True, tile_size=TILE_8)
    print(f"phase 14 tiled {N_CPU}^3 tile {TILE_8}, card and CPU:", flush=True)
    agree(f"phase 14 tiled {N_CPU}^3 tile {TILE_8} velocities, card against CPU", step_32("cuda", p32t),
          step_32("cpu", p32t))

    print(json.dumps({"kernels": list(table.values())}), flush=True)
    print(card_line(), flush=True)  # nvidia-smi's own "name, power.limit" line
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
