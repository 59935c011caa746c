"""The port's tiled ``step`` (``do_tile=True``, the JAX default) against the
JAX package's packed step, in fp64 on the CPU.

honey_coil 32^3, tile 16, padding 2 (4 regions), CELL_ARROW,
``fuse_pap=True``, no BiCGStab fallback, the JAX side through its Pallas
kernels in interpret mode; both steps stopped after STEP_ITERS iterations
with ``keep_non_converged``: equal region and DOF counts and iterations,
velocities and error within STEP_RTOL.  The two packages' rre agree to
1e-13 for the first 70 iterations and then part by round-off growth (4e-9
at 100, 5e-2 at 130); at convergence JAX's own packed step and packed
``solve_chunked`` take 372 and 393 iterations on this case, so the
comparison stops before the growth.  The port alone: at tile 8 (16
regions) the step with ``fuse_update`` and ``fuse_expand`` (kernels 1-4
and 11) against Path A.  Four tests, no more: ``--dist loadfile`` hands
out the files with the most tests first, and a file of at most four runs
after ``test_domain_crop.py``, beside its long tail.
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

STEP_ITERS = 60  # before the round-off growth of the two CG trajectories
STEP_RTOL = 1e-10  # fp64 over 60 iterations (4.8e-15 measured on the velocities)
VEL_ATOL = 2e-4  # times max |v|: the packed-against-XLA bound of tests/test_pallas_apply.py

_CACHE = {}


def _jparams(T):
    return JParams(dtype=jnp.float64, do_tile=True, tile_size=T, tile_padding=2, preconditioner=JPC.CELL_ARROW,
                   tolerance=1e-3, max_iterations=STEP_ITERS, keep_non_converged=True, bicgstab_fallback=False,
                   use_pallas=True, fuse_pap=True)


def _inputs():
    if "inputs" not in _CACHE:
        _CACHE["inputs"] = jbuilders.honey_coil(n=32, dtype=jnp.float64)
    return _CACHE["inputs"]


def _port_step(T, **kw):
    grid, scene = _inputs()
    params = convert.params_from_jax(_jparams(T)).replace(**kw)
    return tstep(convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"), params)


def _steps():
    """JAX's packed step and the port's at tile 16."""
    if "step" not in _CACHE:
        vj, _, sj = jstep(*_inputs(), _jparams(16))
        vt, _, st = _port_step(16)
        _CACHE["step"] = dict(vj=[np.asarray(v) for v in vj], sj=sj, vt=[v.numpy() for v in vt], st=st)
    return _CACHE["step"]


def test_step_counts_and_iterations_equal():
    r = _steps()
    for key in ("n_regions", "n_pressures", "n_active_velocities", "n_stresses", "n_reduced_dofs", "boundary_active",
                "iterations"):
        assert r["st"][key] == int(r["sj"][key]), key
    assert r["st"]["n_regions"] == 4 and r["st"]["iterations"] == STEP_ITERS


def test_step_velocities_agree():
    r = _steps()
    scale = max(float(np.max(np.abs(v))) for v in r["vj"])
    for a in range(3):
        np.testing.assert_allclose(r["vt"][a], r["vj"][a], rtol=0, atol=STEP_RTOL * scale)


def test_step_error_agrees():
    r = _steps()
    ej = float(r["sj"]["error"])
    assert abs(r["st"]["error"] - ej) <= STEP_RTOL * ej


def test_fused_update_agrees_with_path_a_at_tile_8():
    va, _, sa = _port_step(8)
    vf, _, sf = _port_step(8, fuse_update=True, fuse_expand=True)
    assert sa["iterations"] == sf["iterations"] == STEP_ITERS and sa["n_regions"] == sf["n_regions"] == 16
    scale = max(float(v.abs().max()) for v in va)
    for a in range(3):
        assert float((vf[a] - va[a]).abs().max()) <= VEL_ATOL * scale
