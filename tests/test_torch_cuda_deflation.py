"""A-DEF2 deflation on a card (marker ``cuda``; each test skips without
CUDA).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_deflation.py -m cuda --noconftest -q

honey_coil 32^3, tiled at tile 8, CELL_ARROW: E built twice bit-equal; the
deflated step (packed, and packed with coeff_bf16) converged, bit-equal
across two runs and, in fp64, on the card against the CPU; the deflated
pass captured in the CUDA graph with the kernels' launches of each pass.
"""
import pytest
import torch

from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.config import PreconditionerType, SolverParams
from polystokes_tpu_torch.scenes.builders import honey_coil

VEL_ATOL = 2e-4  # times max |v|: the card against the CPU


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _params(dtype, **kw):
    return SolverParams(dtype=dtype, tile_size=8, tolerance=1e-5, max_iterations=5000, bicgstab_fallback=False,
                        preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True, deflation=True, **kw)


@pytest.mark.cuda
def test_coarse_operator_builds_bit_equal():
    _require_cuda()
    grid, scene = honey_coil(n=32, dtype=torch.float32, device="cuda")
    p = _params(torch.float32)
    cls, asm = tsolver._setup(grid, scene, p)
    d1, d2 = (tsolver._make_deflation(grid, cls, asm, p) for _ in range(2))
    assert d1.e.shape == (7 * 64, 7 * 64) and d1.e.is_cuda
    assert torch.equal(d1.e, d2.e) and torch.equal(d1.einv, d2.einv)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32-stack", "bf16-stack"])
def test_deflated_step_repeats_with_launches(bf16):
    _require_cuda()
    grid, scene = honey_coil(n=32, dtype=torch.float32, device="cuda")
    p = _params(torch.float32, coeff_bf16=bf16)
    runs = []
    for _ in range(2):
        tpa.reset_launches()
        vel, _, st = tsolver.step(grid, scene, p)
        torch.cuda.synchronize()
        runs.append((vel, st, dict(tpa.LAUNCHES)))
    for vel, st, launches in runs:
        assert st["converged"] and st["boundary_active"] == 0
        n = st["loop_passes"]
        # one fused apply a pass (grid_mom_pap, expand, finish); one unfused
        # apply (moments, expand, apply_reduced) each for the 189 probes, the
        # projected guess, pcg_init's apply, pcg_init's deflated
        # preconditioner and the deflated preconditioner of every pass
        unfused = 189 + 3 + n
        tag = "_bf16" if bf16 else ""  # the forms of the stack's storage type
        assert launches["grid_mom_pap" + tag] == launches["finish" + tag] == n
        assert launches["apply_reduced" + tag] == launches["moments" + tag] == unfused
        assert launches["expand" + tag] == unfused + n
        assert sum(launches.values()) == 3 * unfused + 3 * n
    assert runs[0][1]["iterations"] == runs[1][1]["iterations"]
    assert all(torch.equal(x, y) for x, y in zip(runs[0][0], runs[1][0]))


@pytest.mark.cuda
def test_deflated_step_card_against_cpu_fp64():
    _require_cuda()
    p = _params(torch.float64)
    g, s = honey_coil(n=32, dtype=torch.float64, device="cuda")
    v_gpu, _, st_gpu = tsolver.step(g, s, p)
    g, s = honey_coil(n=32, dtype=torch.float64, device="cpu")
    v_cpu, _, st_cpu = tsolver.step(g, s, p)
    assert st_gpu["converged"] and st_cpu["converged"]
    vmax = max(float(a.abs().max()) for a in v_cpu)
    assert max(float((a.cpu() - b).abs().max()) for a, b in zip(v_gpu, v_cpu)) <= VEL_ATOL * vmax
