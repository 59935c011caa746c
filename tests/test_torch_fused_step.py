"""The port's step on the bench default, ``fuse_pap=True`` (Path A),
against ``polystokes_tpu.step`` under the same settings.

honey_coil 16^3, tile 8, untiled cube regions, max_regions 64, CELL_ARROW,
fp64, tol 1e-3, no BiCGStab fallback; the JAX side through its Pallas
kernels in interpret mode.  Even in fp64 this CG is round-off-chaotic at
toy stiffness: the port sums <p, A p> per cube where JAX sums per block,
so the trajectories part slowly and the converged iteration counts may
differ.  Two levels therefore:

* a fixed budget of 30 iterations holds the algorithm to JAX's exactly
  (velocities within 1e-10 max |v|);
* converged, both meet the tolerance and the velocities agree within
  1e-3 max |v|, the size of two tol-1e-3 solutions apart.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import step as jstep
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import convert
from polystokes_tpu_torch import step as tstep

torch.set_num_threads(1)

BUDGET = 30
BUDGET_VEL_RTOL = 1e-10
CONVERGED_VEL_RTOL = 1e-3


def run_both(max_iterations, **kw):
    """(velocities and stats of JAX, of the port) on honey_coil 16^3."""
    grid, scene = jbuilders.honey_coil(n=16, dtype=jnp.float64)
    params = JParams(
        dtype=jnp.float64, do_tile=False, tile_size=8, tile_padding=2, max_regions=64,
        preconditioner=JPC.CELL_ARROW, tolerance=1e-3, max_iterations=max_iterations, bicgstab_fallback=False,
        use_pallas=True, keep_non_converged=True, **kw,
    )
    vj, _, sj = jstep(grid, scene, params)
    vt, _, st = tstep(convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"), convert.params_from_jax(params))
    return [np.asarray(v) for v in vj], sj, [v.numpy() for v in vt], st


def max_vel_rel(vj, vt):
    scale = max(float(np.max(np.abs(v))) for v in vj)
    return max(float(np.max(np.abs(a - b))) for a, b in zip(vt, vj)) / scale


_RUNS = {}


def _run(budget: bool):
    if budget not in _RUNS:
        _RUNS[budget] = run_both(BUDGET if budget else 2000, fuse_pap=True)
    return _RUNS[budget]


def test_fixed_budget_matches_jax():
    vj, sj, vt, st = _run(True)
    assert int(sj["iterations"]) == st["iterations"] == BUDGET
    assert not st["converged"] and not bool(sj["converged"])
    assert max_vel_rel(vj, vt) <= BUDGET_VEL_RTOL


def test_fixed_budget_counts_applies():
    """One apply in pcg_init plus one fused apply per loop pass."""
    st = _run(True)[3]
    assert st["operator_applies"] == BUDGET + 1


@pytest.mark.parametrize("side", ["jax", "port"])
def test_converged_meets_tolerance(side):
    vj, sj, vt, st = _run(False)
    stats = sj if side == "jax" else st
    assert bool(stats["converged"]) and int(stats["boundary_active"]) == 0
    assert float(stats["error"]) < 1e-3


def test_converged_velocities_agree():
    vj, sj, vt, st = _run(False)
    print(f"iterations: jax {int(sj['iterations'])}, port {st['iterations']}")
    assert st["n_regions"] == int(sj["n_regions"]) >= 1
    assert max_vel_rel(vj, vt) <= CONVERGED_VEL_RTOL
