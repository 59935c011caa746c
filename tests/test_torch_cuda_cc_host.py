"""The host connected components with a scene on a card (marker ``cuda``;
each test skips without CUDA).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_cc_host.py -m cuda --noconftest -q

* the untiled classification of honey_coil 32^3 with
  ``cc_host_callback=True`` on the card equal to the CPU's, its regions
  back on the card, the partition the device propagation's;
* the untiled packed step with ``cc_host_callback=True`` on the card
  (f32, CELL_ARROW, tol 1e-5) against the CPU: velocities within
  VEL_ATOL of max |v|.
"""
import numpy as np
import pytest
import torch

from polystokes_tpu_torch import PreconditionerType, SolverParams, classify, solver
from polystokes_tpu_torch.scenes.builders import honey_coil

VEL_ATOL = 2e-4


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _params(**kw):
    return SolverParams(**{**dict(do_tile=False, tile_size=8, max_regions=64, cc_host_callback=True,
                                  preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True, tolerance=1e-5,
                                  max_iterations=20000, bicgstab_fallback=False), **kw})


@pytest.mark.cuda
def test_host_cc_classify_card_against_cpu():
    _require_cuda()
    out = {}
    for where in ("cpu", "cuda"):
        grid, scene = honey_coil(n=32, dtype=torch.float32, device=where)
        out[where] = classify.classify(grid, *solver._weights(grid, scene, _params()), _params())
    dev_cc = classify.classify(grid, *solver._weights(grid, scene, _params()), _params(cc_host_callback=False))
    assert out["cuda"].cell_region.is_cuda
    assert torch.equal(out["cuda"].cell_region.cpu(), out["cpu"].cell_region)
    assert int(out["cuda"].n_regions) == int(dev_cc.n_regions) >= 1
    a, b = out["cuda"].cell_region.cpu().numpy(), dev_cc.cell_region.cpu().numpy()
    assert ((a >= 0) == (b >= 0)).all()
    assert len(set(zip(a[a >= 0].tolist(), b[a >= 0].tolist()))) == int(dev_cc.n_regions)


@pytest.mark.cuda
def test_host_cc_step_card_against_cpu():
    _require_cuda()
    vel = {}
    for where in ("cpu", "cuda"):
        grid, scene = honey_coil(n=32, dtype=torch.float32, device=where)
        v, _, st = solver.step(grid, scene, _params())
        assert st["converged"]
        vel[where] = [t.double().cpu() for t in v]
    vmax = max(float(t.abs().max()) for t in vel["cpu"])
    assert max(float((a - b).abs().max()) for a, b in zip(vel["cuda"], vel["cpu"])) <= VEL_ATOL * vmax
