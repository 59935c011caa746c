"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the final line):
  0. require CUDA; print the card (nvidia-smi name and power limit) and
     the torch / CUDA versions;
  1. build the kernels of polystokes_tpu_torch/csrc with nvcc (sm_90a, one
     nvcc per source, all started together);
  2. each of the seven kernels against its plain PyTorch twin at the
     main-path shapes (honey_coil 128^3, tile 16, float32; the uniform
     kernels on the uniform setup's 14-channel stack): max |diff| <= 1e-5
     max |twin| on every output and on the summed <x, A x> partials, with
     median times over 20 launches and the HBM bound;
  3. the applies on the card: symmetry |<y, A x> - <A y, x>| <= 1e-5
     |<y, A x>| of the reduced and the uniform apply, and each fused
     apply_dot against (apply(x), <x, apply(x)>): A x within 1e-5 of max,
     <x, A x> within 1e-5 relative;
  4. Path A, the main path: step() with fuse_pap=True (the bench default)
     on honey_coil 128^3 (untiled cube regions, max_regions 64, CELL_ARROW,
     tol 1e-3), once to warm and twice timed: converged, error < 1e-3,
     boundary_active == 0, equal iteration counts and bit-equal velocities
     in the two timed runs, and each kernel's launches as the CG's applies
     dictate (k iterations, 1 + k applies):
       moments 1, apply_reduced 1, expand applies, grid_mom_pap and finish
       applies - 1, the uniform kernels 0;
  5. the fuse_pap=False path at 128^3: moments, expand and apply_reduced
     once per apply, the others 0;
  6. Path B, the uniform baseline (do_reduced_regions=False) at 128^3 with
     fuse_pap=True (apply_uniform 1, apply_uniform_pap applies - 1) and
     fuse_pap=False (apply_uniform once per apply); no reduced kernel;
  7. Path A on the card against the port on the CPU at 32^3, float32,
     tol 1e-5: both converge, velocities within 2e-4 max |v|.
Every launch count is read from counters set to 0 just before that run.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
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
}
MAIN_PATH = {"moments": "A", "expand": "A", "apply_reduced": "A", "grid_mom_pap": "A", "finish": "A",
             "apply_uniform_pap": "B_fused", "apply_uniform": "B_fused"}


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


def bound(name, plane, small_bytes, itemsize):
    """(ms, 'bytes' or 'operations'): the larger of the HBM time of the
    channels the kernel must read and write once (plus its small per-cube
    arrays) and the float32 time of its flops."""
    _, _, read, written, flops = KERNELS[name]
    t_bytes = ((read + written) * plane * itemsize + small_bytes) / HBM_BYTES_PER_S
    t_ops = flops * plane / F32_FLOPS_PER_S
    return (1e3 * t_bytes, "bytes") if t_bytes >= t_ops else (1e3 * t_ops, "operations")


def expected_launches(path, applies):
    counts = dict.fromkeys(KERNELS, 0)
    if path == "A":
        counts.update(moments=1, apply_reduced=1, expand=applies, grid_mom_pap=applies - 1, finish=applies - 1)
    elif path == "unfused":
        counts.update(moments=applies, expand=applies, apply_reduced=applies)
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
    from polystokes_tpu_torch import solver
    from polystokes_tpu_torch.classify import effective_max_regions
    from polystokes_tpu_torch.scenes.builders import honey_coil

    # -- phase 1: build
    t0 = time.perf_counter()
    path, nvcc_s, ptxas = pa.build_kernels()
    print(f"phase 1 build: {path} nvcc {nvcc_s:.1f} s (build step {time.perf_counter() - t0:.1f} s)", flush=True)
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

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
    }
    table = {}
    for name, (kernel, twin, small_bytes) in cases.items():
        got, ref = kernel(), twin()
        torch.cuda.synchronize()
        err = compare(name, got, ref)
        ms_twin = median_ms(twin)
        ms_kernel = median_ms(kernel)
        bound_ms, bound_by = bound(name, plane, small_bytes, xp.element_size())
        print(f"phase 2 {name}: kernel {ms_kernel:.4f} ms twin {ms_twin:.4f} ms bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms_kernel:.1f} % of the bound", flush=True)
        src, replaces = KERNELS[name][:2]
        table[name] = {"name": name, "route": "cuda", "source": f"polystokes_tpu_torch/csrc/{src}", "replaces": replaces,
                       "launches": None, "max_abs_err": err, "ms": ms_kernel, "plain_ms": ms_twin,
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "launches_by_path": {}}

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

    # -- phases 4-6: the paths, each with its own launch counts
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
        return vel, stats, launches

    def check_launches(path, label, stats, launches):
        want = expected_launches(path, stats["operator_applies"])
        if launches != want:
            fail(f"{label}: launches {launches}, expected {want}")
        for name, n in launches.items():
            if n:
                table[name]["launches_by_path"][path] = n

    solver.check_pallas(grid, scene, p_a)
    drive(f"phase 4 Path A {N_MAIN}^3 warm", p_a, lambda n: n >= 1)
    vel1, st1, l1 = drive(f"phase 4 Path A {N_MAIN}^3 timed 1", p_a, lambda n: n >= 1)
    vel2, st2, l2 = drive(f"phase 4 Path A {N_MAIN}^3 timed 2", p_a, lambda n: n >= 1)
    check_launches("A", "phase 4 Path A", st1, l1)
    check_launches("A", "phase 4 Path A", st2, l2)
    same = st1["iterations"] == st2["iterations"] and all(torch.equal(a, b) for a, b in zip(vel1, vel2))
    print(f"phase 4 reproducible: iterations {st1['iterations']} and {st2['iterations']}, "
          f"velocities bit-equal {all(torch.equal(a, b) for a, b in zip(vel1, vel2))}", flush=True)
    if not same:
        fail("two Path A steps on the same inputs differ")

    _, st, launches = drive(f"phase 5 fuse_pap=False {N_MAIN}^3", p_a.replace(fuse_pap=False), lambda n: n >= 1)
    check_launches("unfused", "phase 5", st, launches)
    for fuse, path in ((True, "B_fused"), (False, "B_unfused")):
        _, st, launches = drive(f"phase 6 Path B fuse_pap={fuse} {N_MAIN}^3", p_b.replace(fuse_pap=fuse), lambda n: n == 0)
        check_launches(path, f"phase 6 {path}", st, launches)
    for name, entry in table.items():
        entry["launches"] = entry["launches_by_path"].get(MAIN_PATH[name], 0)
        if entry["launches"] <= 0:
            fail(f"{name} was not launched on its path {MAIN_PATH[name]}")

    # -- phase 7: Path A on the card against the CPU port at 32^3
    p32 = params(torch.float32, 1e-5, 12000, fuse_pap=True)
    results = {}
    for where in ("cuda", "cpu"):
        g32, s32 = honey_coil(n=N_CPU, dtype=torch.float32, device=where)
        t0 = time.perf_counter()
        v32, _, st32 = solver.step(g32, s32, p32)
        results[where] = ([c.double().cpu() for c in v32], st32)
        print(f"phase 7 {where} {N_CPU}^3: {time.perf_counter() - t0:.2f} s, iterations {st32['iterations']}, "
              f"error {st32['error']:.3e}, converged {st32['converged']}", flush=True)
        if not st32["converged"]:
            fail(f"{N_CPU}^3 step on {where} did not converge")
    v_gpu, v_cpu = results["cuda"][0], results["cpu"][0]
    vmax = max(float(c.abs().max()) for c in v_cpu)
    dv = max(float((a - b).abs().max()) for a, b in zip(v_gpu, v_cpu))
    print(f"phase 7 velocities: max|dv| {dv:.3e} max|v| {vmax:.3e} rel {dv / vmax:.3e}", flush=True)
    if not dv <= VEL_ATOL * vmax:
        fail(f"card and CPU velocities differ: {dv} > {VEL_ATOL} * {vmax}")

    print(json.dumps({"kernels": list(table.values())}), flush=True)
    print(card_line(), flush=True)  # nvidia-smi's own "name, power.limit" line
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
