"""The port's step on the bench default, ``fuse_pap=True`` (Path A),
against ``polystokes_tpu.step`` under the same settings.

honey_coil 16^3, tile 8, untiled cube regions, max_regions 64, CELL_ARROW,
fp64, tol 1e-3, no BiCGStab fallback; the JAX side through its Pallas
kernels in interpret mode.  Even in fp64 this CG is round-off-chaotic at
toy stiffness: the port sums <p, A p> per cube where JAX sums per block,
so the trajectories part slowly and the converged iteration counts may
differ.  Two levels therefore:

* a fixed budget of 30 iterations holds the algorithm to JAX's exactly
  (velocities within 1e-10 max |v|): this file;
* converged, both meet the tolerance and the velocities agree within
  1e-3 max |v|, the size of two tol-1e-3 solutions apart:
  ``test_torch_fused_step_converged.py``.

Each file holds at most four tests: ``--dist loadfile`` hands out the
files with the most tests first, and such a file runs after
``test_domain_crop.py``, beside its long tail.
"""
import numpy as np
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
CONVERGED_VEL_RTOL = 1e-3  # test_torch_fused_step_converged.py and test_torch_uniform.py


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


def _run():
    if not _RUNS:
        _RUNS["budget"] = run_both(BUDGET, fuse_pap=True)
    return _RUNS["budget"]


def test_fixed_budget_matches_jax():
    vj, sj, vt, st = _run()
    assert int(sj["iterations"]) == st["iterations"] == BUDGET
    assert not st["converged"] and not bool(sj["converged"])
    assert max_vel_rel(vj, vt) <= BUDGET_VEL_RTOL


def test_fixed_budget_counts_applies():
    """One apply in pcg_init plus one fused apply per loop pass."""
    st = _run()[3]
    assert st["operator_applies"] == BUDGET + 1
