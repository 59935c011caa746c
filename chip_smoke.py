"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the final line):
  0. require CUDA; print the card (nvidia-smi name and power limit) and
     the torch / CUDA versions;
  1. build the kernels of polystokes_tpu_torch/csrc with nvcc (sm_90a);
  2. each kernel against its plain PyTorch twin at the main-path shapes
     (honey_coil 128^3, tile 16, float32), max |diff| <= 1e-5 max |twin|,
     with median times over 20 launches;
  3. symmetry of the kernel apply: |<y, A x> - <A y, x>| <= 1e-5 |<y, A x>|;
  4. the main path: step() on honey_coil 128^3 (untiled cube regions,
     max_regions 64, CELL_ARROW, tol 1e-3), once to warm and once timed;
     converged, error < 1e-3, boundary_active == 0, and every kernel's
     launch count equal to the CG's operator applies;
  5. the step on the card against the port on the CPU at 32^3, float32,
     tol 1e-5: both converge, velocities within 2e-4 max |v|.
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
VEL_ATOL = 2e-4  # times max |v|: the packed-against-XLA bound of the JAX tests
SOURCE = "polystokes_tpu_torch/csrc/packed_apply.cu"
REPLACES = {
    "moments": "polystokes_tpu/pallas_apply.py:1329",
    "expand": "polystokes_tpu/pallas_apply.py:362",
    "apply_reduced": "polystokes_tpu/pallas_apply.py:552",
}


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


def params(dtype, tol, max_iters):
    from polystokes_tpu_torch import SolverParams

    return SolverParams(dtype=dtype, tile_size=TILE, tile_padding=2, max_regions=64,
                        tolerance=tol, max_iterations=max_iters)


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
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # -- phase 2: each kernel against its twin at the main-path shapes
    t0 = time.perf_counter()
    grid, scene = honey_coil(n=N_MAIN, dtype=torch.float32, device=dev)
    p = params(torch.float32, 1e-3, 12000)
    cls, asm = solver._setup(grid, scene, p)
    R = effective_max_regions(grid, p)
    coeffs = pa.pack_coeffs(asm, cls)
    algebra, red = solver._region_algebra_packed(grid, cls, asm, p, R)
    gen = torch.Generator(device=dev).manual_seed(0)
    mask = pa.packed_masks(cls, torch.float32)
    xp = (torch.randn((7,) + grid.res, generator=gen, device=dev) * mask).contiguous()
    torch.cuda.synchronize()
    print(f"phase 2 setup 128^3: {time.perf_counter() - t0:.2f} s, n_regions {int(cls.n_regions)}", flush=True)

    mom_twin = pa.moments_packed_plain(xp, coeffs, TILE)
    v = algebra(mom_twin)
    u_twin = pa.expand_packed_plain(v, red, TILE)
    cases = {
        "moments": (lambda: pa.moments_packed(xp, coeffs, TILE), lambda: pa.moments_packed_plain(xp, coeffs, TILE)),
        "expand": (lambda: pa.expand_packed(v, red, TILE), lambda: pa.expand_packed_plain(v, red, TILE)),
        "apply_reduced": (lambda: pa.apply_reduced_packed(xp, coeffs, u_twin),
                          lambda: pa.apply_reduced_packed_plain(xp, coeffs, u_twin)),
    }
    table = {}
    for name, (kernel, twin) in cases.items():
        got, ref = kernel(), twin()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        ms_twin = median_ms(twin)
        ms_kernel = median_ms(kernel)
        print(f"phase 2 {name}: max|diff| {err:.3e} max|twin| {scale:.3e} rel {err / max(scale, 1e-30):.3e} "
              f"kernel {ms_kernel:.4f} ms twin {ms_twin:.4f} ms", flush=True)
        if not (err <= KERNEL_RTOL * scale) or scale == 0.0:
            fail(f"{name} kernel disagrees with its twin: {err} > {KERNEL_RTOL} * {scale}")
        table[name] = {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                       "max_abs_err": err, "ms": ms_kernel, "plain_ms": ms_twin}

    # -- phase 3: symmetry of the kernel apply
    apply_k = solver.make_apply_packed(grid, cls, asm, p, R)
    yp = (torch.randn((7,) + grid.res, generator=gen, device=dev) * mask).contiguous()
    ax, ay = apply_k(xp), apply_k(yp)
    y_ax = float((yp.double() * ax.double()).sum())
    ay_x = float((ay.double() * xp.double()).sum())
    asym = abs(y_ax - ay_x) / abs(y_ax)
    print(f"phase 3 symmetry: <y,Ax> {y_ax:.9e} <Ay,x> {ay_x:.9e} rel {asym:.3e}", flush=True)
    if not asym <= SYM_RTOL:
        fail(f"kernel apply is not symmetric: {asym} > {SYM_RTOL}")

    # -- phase 4: the main path
    solver.check_pallas(grid, scene, p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.step(grid, scene, p)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    pa.reset_launches()
    t0 = time.perf_counter()
    vel, _, stats = solver.step(grid, scene, p)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(pa.LAUNCHES)
    iters = stats["iterations"]
    print(f"phase 4 step 128^3: first {warm_s:.3f} s, timed {step_s:.3f} s, iterations {iters}, "
          f"error {stats['error']:.3e}, converged {stats['converged']}, boundary_active {stats['boundary_active']}, "
          f"n_regions {stats['n_regions']}, applies {stats['operator_applies']}, launches {launches}, "
          f"ms/iter (step wall / applies) {1e3 * step_s / max(stats['operator_applies'], 1):.3f}", flush=True)
    if not (stats["converged"] and stats["error"] < 1e-3 and stats["boundary_active"] == 0 and stats["n_regions"] >= 1):
        fail(f"main path did not converge cleanly: {stats}")
    if not all(bool(torch.isfinite(c).all()) for c in vel):
        fail("non-finite velocities")
    for name, n in launches.items():
        if n <= 0 or n != stats["operator_applies"]:
            fail(f"{name}: {n} launches for {stats['operator_applies']} operator applies")
        table[name]["launches"] = n

    # -- phase 5: the card against the CPU port at 32^3
    p32 = params(torch.float32, 1e-5, 12000)
    results = {}
    for where in ("cuda", "cpu"):
        g32, s32 = honey_coil(n=N_CPU, dtype=torch.float32, device=where)
        t0 = time.perf_counter()
        v32, _, st32 = solver.step(g32, s32, p32)
        results[where] = ([c.double().cpu() for c in v32], st32)
        print(f"phase 5 {where} 32^3: {time.perf_counter() - t0:.2f} s, iterations {st32['iterations']}, "
              f"error {st32['error']:.3e}, converged {st32['converged']}", flush=True)
        if not st32["converged"]:
            fail(f"32^3 step on {where} did not converge")
    v_gpu, v_cpu = results["cuda"][0], results["cpu"][0]
    vmax = max(float(c.abs().max()) for c in v_cpu)
    dv = max(float((a - b).abs().max()) for a, b in zip(v_gpu, v_cpu))
    print(f"phase 5 velocities: max|dv| {dv:.3e} max|v| {vmax:.3e} rel {dv / vmax:.3e}", flush=True)
    if not dv <= VEL_ATOL * vmax:
        fail(f"card and CPU velocities differ: {dv} > {VEL_ATOL} * {vmax}")

    print(json.dumps({"kernels": [table[k] for k in ("moments", "expand", "apply_reduced")]}), flush=True)
    print(card_line(), flush=True)  # nvidia-smi's own "name, power.limit" line
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
