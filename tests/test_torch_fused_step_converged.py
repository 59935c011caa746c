"""The port's converged step on the bench default, ``fuse_pap=True``
(Path A), against ``polystokes_tpu.step`` under the same settings (those
of ``test_torch_fused_step.py``, whose fixed-budget tests hold the
algorithm to JAX's exactly): converged, both meet the tolerance and the
velocities agree within 1e-3 max |v|, the size of two tol-1e-3 solutions
apart.
"""
import pytest
import torch

from test_torch_fused_step import CONVERGED_VEL_RTOL, max_vel_rel, run_both

torch.set_num_threads(1)

_RUNS = {}


def _run():
    if not _RUNS:
        _RUNS["converged"] = run_both(2000, fuse_pap=True)
    return _RUNS["converged"]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_converged_meets_tolerance(side):
    vj, sj, vt, st = _run()
    stats = sj if side == "jax" else st
    assert bool(stats["converged"]) and int(stats["boundary_active"]) == 0
    assert float(stats["error"]) < 1e-3


def test_converged_velocities_agree():
    vj, sj, vt, st = _run()
    print(f"iterations: jax {int(sj['iterations'])}, port {st['iterations']}")
    assert st["n_regions"] == int(sj["n_regions"]) >= 1
    assert max_vel_rel(vj, vt) <= CONVERGED_VEL_RTOL
