"""The MULTIGRID preconditioner on a card against the CPU port (marker
``cuda``; each test skips without CUDA).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_multigrid.py -m cuda --noconftest -q

* one V-cycle (honey_coil 16^3 untiled, with regions) on the card against
  the CPU in fp64, within 1e-10 of max;
* a MULTIGRID step at 16^3 (tiled, tile 8, f32, tol 1e-5) on the card
  against the CPU: both converge, velocities within VEL_ATOL of max |v|;
  the iteration counts are not held, since the f32 hash noise of the
  power iteration follows the last bits of sin, which the card and the
  CPU round otherwise (ROADMAP.md watch item 2); unconverged, the two
  trajectories part by more than the bound; no hand-written kernel
  launched.
"""
import numpy as np
import pytest
import torch

from polystokes_tpu_torch import PreconditionerType, SolverParams, multigrid, solver
from polystokes_tpu_torch import packed_apply as pa
from polystokes_tpu_torch.operators import PTau
from polystokes_tpu_torch.scenes.builders import honey_coil

VEL_ATOL = 2e-4


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_vcycle_card_against_cpu():
    _require_cuda()
    params = SolverParams(dtype=torch.float64, do_tile=False, tile_size=8, max_regions=64,
                          preconditioner=PreconditionerType.MULTIGRID)
    z = {}
    for where in ("cpu", "cuda"):
        grid, scene = honey_coil(n=16, dtype=torch.float64, device=where)
        cls, asm = solver._setup(grid, scene, params)
        shapes = [grid.center_shape] * 4 + [grid.edge_shape(e) for e in range(3)]
        f = [torch.from_numpy(np.random.default_rng(1).standard_normal(s)).to(where) for s in shapes]
        z[where] = multigrid.make_multigrid(grid, cls, asm, params)(PTau(p=f[0], tc=tuple(f[1:4]), te=tuple(f[4:])))
    for a, b in zip(z["cuda"].fields(), z["cpu"].fields()):
        assert float((a.cpu() - b).abs().max()) <= 1e-10 * float(b.abs().max())


@pytest.mark.cuda
def test_multigrid_step_card_against_cpu():
    _require_cuda()
    params = SolverParams(preconditioner=PreconditionerType.MULTIGRID, tile_size=8, tolerance=1e-5,
                          max_iterations=5000, bicgstab_fallback=False)
    vel = {}
    for where in ("cpu", "cuda"):
        grid, scene = honey_coil(n=16, dtype=torch.float32, device=where)
        pa.reset_launches()
        v, _, st = solver.step(grid, scene, params)
        assert st["converged"] and not any(pa.LAUNCHES.values())
        vel[where] = [t.double().cpu() for t in v]
    vmax = max(float(t.abs().max()) for t in vel["cpu"])
    assert max(float((a - b).abs().max()) for a, b in zip(vel["cuda"], vel["cpu"])) <= VEL_ATOL * vmax
