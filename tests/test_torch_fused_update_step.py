"""The port's step with ``fuse_update`` against ``polystokes_tpu.step``,
and against its own step without it.

honey_coil 16^3, tile 8, untiled cube regions, max_regions 64, fp64, tol
1e-3, no BiCGStab fallback; the JAX side through its Pallas kernels in
interpret mode.  Three paths, each with another kernel and kind:

* Path F: the reduced step with ``fuse_pap`` and ``fuse_expand``,
  CELL_ARROW (``exp_finish_update_packed``, kind "arrow");
* Path F': the same without ``fuse_expand``, IDENTITY
  (``finish_update_packed``, kind "none");
* the uniform step with ``fuse_pap``, DIAGONAL (``cg_update_packed``,
  kind "diag").

A fixed budget of 20 iterations holds each to JAX's step (velocities within
1e-10 max |v|), as ``test_torch_fused_step`` does for the unfused update.
Converged, the fused update is held to the port's unfused loop, as JAX's
``test_fused_update_step_matches_unfused`` holds its own.  REGION_ARROW has
no fused update in either package: there ``fuse_update`` changes nothing.
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
from polystokes_tpu_torch.config import PreconditionerType, SolverParams
from polystokes_tpu_torch.scenes.builders import honey_coil

torch.set_num_threads(1)

BUDGET = 20
BUDGET_VEL_RTOL = 1e-10
CONVERGED_VEL_RTOL = 2e-4  # two tol-1e-3 solves of one system, the bound of JAX's fused-update test
MAX_ITER_DIFF = 3

PATHS = {
    "F-arrow": dict(preconditioner=JPC.CELL_ARROW, fuse_expand=True),
    "Fprime-none": dict(preconditioner=JPC.IDENTITY, fuse_expand=False),
    "uniform-diag": dict(preconditioner=JPC.DIAGONAL, do_reduced_regions=False),
}


def _jparams(max_iterations, **kw):
    return JParams(dtype=jnp.float64, do_tile=False, tile_size=8, tile_padding=2, max_regions=64, tolerance=1e-3,
                   max_iterations=max_iterations, bicgstab_fallback=False, use_pallas=True, keep_non_converged=True,
                   fuse_pap=True, fuse_update=True, **kw)


_BUDGET = {}


def _budget_run(path):
    """JAX's and the port's step at a budget of 20 iterations."""
    if path not in _BUDGET:
        grid, scene = jbuilders.honey_coil(n=16, dtype=jnp.float64)
        params = _jparams(BUDGET, **PATHS[path])
        vj, _, sj = jstep(grid, scene, params)
        vt, _, st = tstep(convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"),
                          convert.params_from_jax(params))
        _BUDGET[path] = dict(vj=[np.asarray(v) for v in vj], sj=sj, vt=[v.numpy() for v in vt], st=st)
    return _BUDGET[path]


@pytest.mark.parametrize("path", list(PATHS))
def test_fixed_budget_matches_jax(path):
    r = _budget_run(path)
    assert int(r["sj"]["iterations"]) == r["st"]["iterations"] == BUDGET
    assert not bool(r["sj"]["converged"]) and not r["st"]["converged"]
    assert r["st"]["operator_applies"] == BUDGET + 1
    assert (r["st"]["n_regions"] >= 1) == PATHS[path].get("do_reduced_regions", True)
    scale = max(float(np.max(np.abs(v))) for v in r["vj"])
    assert max(float(np.max(np.abs(a - b))) for a, b in zip(r["vt"], r["vj"])) <= BUDGET_VEL_RTOL * scale


def test_params_from_jax_carries_the_fused_update():
    p = convert.params_from_jax(_jparams(BUDGET, **PATHS["Fprime-none"]))
    assert p.fuse_update and not p.fuse_expand and p.preconditioner == PreconditionerType.IDENTITY
    p = convert.params_from_jax(_jparams(BUDGET, **PATHS["uniform-diag"]))
    assert p.fuse_update and p.preconditioner == PreconditionerType.DIAGONAL


_PORT = {}


def _port_step(preconditioner, fuse_update, fuse_expand=True):
    key = (preconditioner, fuse_update, fuse_expand)
    if key not in _PORT:
        grid, scene = honey_coil(n=16, dtype=torch.float64, device="cpu")
        params = SolverParams(do_tile=False, dtype=torch.float64, tile_size=8, max_regions=64, tolerance=1e-3, max_iterations=2000,
                              preconditioner=PreconditionerType[preconditioner], fuse_update=fuse_update,
                              fuse_expand=fuse_expand, bicgstab_fallback=False, use_pallas=True)
        _PORT[key] = tstep(grid, scene, params)
    return _PORT[key]


@pytest.mark.parametrize("pc", ["CELL_ARROW", "IDENTITY"])
def test_converged_fused_update_matches_unfused(pc):
    v_f, _, st_f = _port_step(pc, True)
    v_u, _, st_u = _port_step(pc, False)
    assert st_f["converged"] and st_u["converged"] and st_f["error"] < 1e-3
    assert abs(st_f["iterations"] - st_u["iterations"]) <= MAX_ITER_DIFF
    scale = max(float(v.abs().max()) for v in v_u)
    assert max(float((a - b).abs().max()) for a, b in zip(v_f, v_u)) <= CONVERGED_VEL_RTOL * scale


def test_fuse_expand_changes_only_the_kernel():
    """Path F and F' run one algorithm: the expand in place or stored."""
    v_e, _, st_e = _port_step("CELL_ARROW", True, True)
    v_s, _, st_s = _port_step("CELL_ARROW", True, False)
    assert abs(st_e["iterations"] - st_s["iterations"]) <= MAX_ITER_DIFF
    scale = max(float(v.abs().max()) for v in v_s)
    assert max(float((a - b).abs().max()) for a, b in zip(v_e, v_s)) <= CONVERGED_VEL_RTOL * scale


def test_region_arrow_ignores_fuse_update():
    """make_fused_update gives None for REGION_ARROW, as in JAX: the step
    runs the unfused loop and equals the one without fuse_update bit for bit."""
    v_f, _, st_f = _port_step("REGION_ARROW", True)
    v_u, _, st_u = _port_step("REGION_ARROW", False)
    assert st_f["iterations"] == st_u["iterations"] and st_f["converged"]
    assert all(torch.equal(a, b) for a, b in zip(v_f, v_u))
