"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the final line):
  0. require CUDA; print the card (nvidia-smi name and power limit) and
     the torch / CUDA versions;
  1. build the kernels of polystokes_tpu_torch/csrc with nvcc (sm_90a, one
     nvcc per source, all started together); print each kernel's
     registers, static shared memory and spill bytes from the ptxas report,
     and for grid_mom_pap and the two uniform kernels the planned geometry
     (the column, and the uniform run at 128^3), the window's dynamic
     shared memory and the blocks per SM the occupancy calculator allows;
  2. each of the thirteen kernels against its plain PyTorch twin at the
     main-path shapes (honey_coil 128^3, tile 16, float32; the uniform
     kernels on the uniform setup's 14-channel stack): max |diff| <= 1e-5
     max |twin| on every output, on the summed <x, A x> partials and on the
     three dots of the update kernels, with median times over 20 launches
     (each timed alone, host call included, as in earlier records), the
     device time of one launch (20 launches replayed from a CUDA graph) and
     the HBM bound; then the device time of both uniform kernels at each
     geometry (column and run) of UNIFORM_GEOMETRIES, from which
     packed_apply.uniform_plan takes its pick.  The update kernels run on
     the real CELL_ARROW
     (kind arrow) and DIAGONAL (kind diag) factors: cg_update with every
     kind, finish_update and exp_finish_update with arrow and none; the
     kernel table reports kind arrow, the kind of every path below;
  3. the applies on the card: symmetry |<y, A x> - <A y, x>| <= 1e-5
     |<y, A x>| of the reduced and the uniform apply, and each fused
     apply_dot against (apply(x), <x, apply(x)>): A x within 1e-5 of max,
     <x, A x> within 1e-5 relative; combine(x, forward_s(x), u) against
     apply_reduced(x, u) within 1e-5 of max; the REGION_ARROW solve's
     symmetry |<y, M x> - <M y, x>| <= 1e-5 |<y, M x>|;
  4. Path A, the main path: step() with fuse_pap=True (the bench default)
     on honey_coil 128^3 (untiled cube regions, max_regions 64, CELL_ARROW,
     tol 1e-3), once to warm and twice timed: converged, error < 1e-3,
     boundary_active == 0, equal iteration counts and bit-equal velocities
     in the two timed runs, and each kernel's launches as the CG's applies
     dictate (k iterations, a = 1 + k applies):
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
     CPU: all converge, velocities within 2e-4 max |v|.
Every launch count is read from counters set to 0 just before that run.
forward_s and combine (kernels 12 and 13) have no caller in either
package: they are checked in phases 2 and 3 and run on no path.
The kernel table is printed as JSON two lines before the last, then the
nvidia-smi line of the card; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM at 700 W
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PA = "polystokes_tpu/pallas_apply.py"
KERNELS = {
    # name: (source, TPU kernel replaced, full-size channels read, written,
    #        flops per slot counted from the formulas in the source notes)
    "moments": ("packed_apply.cu", f"{PA}:1329", 17, 0, 123),
    "expand": ("packed_apply.cu", f"{PA}:362", 3, 3, 81),
    "apply_reduced": ("packed_apply.cu", f"{PA}:552", 24, 7, 87),
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
    from polystokes_tpu_torch import SolverParams

    return SolverParams(dtype=dtype, tile_size=TILE, tile_padding=2, max_regions=64,
                        tolerance=tol, max_iterations=max_iters, **kw)


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


def compare(name, got, ref):
    """Max |diff| over the outputs (tuples: each, and the summed partials
    when the last is a partials vector); fails above KERNEL_RTOL of max |twin|."""
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
            print(f"phase 2 {name} output {i}: max|diff| {err:.3e} max|twin| {scale:.3e} rel {err / max(scale, 1e-30):.3e}",
                  flush=True)
            if not (err <= KERNEL_RTOL * scale) or scale == 0.0:
                fail(f"{name} kernel disagrees with its twin: {err} > {KERNEL_RTOL} * {scale}")
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
        window, blocks = pa.grid_mom_pap_occupancy(dtype, by, bz)
        print(f"  grid_mom_pap {dtype} at tile {TILE}: column {by} x {bz}, "
              f"{window} bytes dynamic shared memory, {blocks} blocks per SM", flush=True)
        for name in ("apply_uniform", "apply_uniform_pap"):
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
    def measure(name, kernel, twin, small_bytes, kind=None):
        """Compare a kernel with its twin, time both and reckon its bound."""
        label = name if kind is None else f"{name} kind {kind}"
        got, ref = kernel(), twin()
        torch.cuda.synchronize()
        err = compare(label, got, ref)
        ms_twin = median_ms(twin)
        ms_kernel = median_ms(kernel)
        ms_device = graph_ms(kernel)
        bound_ms, bound_by = bound(name, plane, small_bytes, xp.element_size(), kind or "arrow")
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

    # the uniform kernels at each geometry of the sweep (device time)
    for geo in UNIFORM_GEOMETRIES:
        for name, pap in (("apply_uniform", False), ("apply_uniform_pap", True)):
            ms = graph_ms(lambda: pa._apply_uniform_cuda(xu, coeffs_u, *geo, pap=pap))
            print(f"phase 2 {name} geometry (by, bz, L) {geo}: device {ms:.4f} ms, "
                  f"{100 * table[name]['bound_ms'] / ms:.1f} % of the bound"
                  f"{' (the plan)' if geo == pa.uniform_plan(grid.res) else ''}", flush=True)

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
    def drive(label, p, n_check=None):
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vel, _, stats = solver.step(grid, scene, p)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(pa.LAUNCHES)
        applies = stats["operator_applies"]
        print(f"{label}: {seconds:.3f} s, iterations {stats['iterations']}, error {stats['error']:.3e}, "
              f"converged {stats['converged']}, boundary_active {stats['boundary_active']}, "
              f"n_regions {stats['n_regions']}, applies {applies}, ms per apply (step wall / applies) "
              f"{1e3 * seconds / max(applies, 1):.4f}, launches {launches}", flush=True)
        if not (stats["converged"] and stats["error"] < 1e-3 and stats["boundary_active"] == 0):
            fail(f"{label} did not converge cleanly: {stats}")
        if n_check is not None and not n_check(stats["n_regions"]):
            fail(f"{label}: unexpected region count {stats['n_regions']}")
        if not all(bool(torch.isfinite(c).all()) for c in vel):
            fail(f"{label}: non-finite velocities")
        stats["ms_per_apply"] = 1e3 * seconds / max(applies, 1)
        return vel, stats, launches

    def check_launches(path, label, stats, launches, record=True):
        want = expected_launches(path, stats["operator_applies"])
        if launches != want:
            fail(f"{label}: launches {launches}, expected {want}")
        for name, n in launches.items():
            if n and record:
                table[name]["launches_by_path"][path] = n

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

    print(json.dumps({"kernels": list(table.values())}), flush=True)
    print(card_line(), flush=True)  # nvidia-smi's own "name, power.limit" line
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
