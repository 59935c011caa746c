"""The port's density sampling and device warm start against the JAX
package's, in fp64 on the CPU.

* ``solver.sample_density``: the counterparts of the three density tests
  of ``tests/test_round3_fixes.py`` (a constant field gives its value, no
  field gives ``params`` itself, a low field clamps to ``min_density``, a
  variable field raises, and the step with the field is bit-equal to the
  step with the parameter).
* The warm x0 of ``_build_krylov_system`` (``device_warm_start`` with
  ``use_warm_start``) against JAX's within X0_RTOL of max, non-zero, on
  honey_coil 32^3 tiled at tile 16 (4 regions) and on the uniform step;
  ``initial_guess`` wins over it, and ``use_warm_start=False`` gives zero.
* The warm step against JAX's warm step, both stopped after STEP_ITERS
  iterations with ``keep_non_converged``, within STEP_RTOL; JAX's packed
  step runs through its Pallas kernels in interpret mode.
* ``convert.params_from_jax`` carries both warm-start switches and
  ``convert.scene_from_numpy`` the density field.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from polystokes_tpu import solver as jsolver
from polystokes_tpu import step as jstep
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import PreconditionerType, SolverParams, convert
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.packed_apply import unpack_ptau
from polystokes_tpu_torch.scenes.builders import honey_coil

torch.set_num_threads(1)

STEP_ITERS = 40  # before the two packages' CG trajectories part by round-off growth
STEP_RTOL = 1e-10
X0_RTOL = 1e-12  # fp64: the same transpose stencil on the same face values

_CACHE = {}


def _jparams(**kw):
    base = dict(dtype=jnp.float64, do_tile=True, tile_size=16, tile_padding=2, preconditioner=JPC.CELL_ARROW,
                tolerance=1e-3, max_iterations=STEP_ITERS, keep_non_converged=True, bicgstab_fallback=False,
                use_pallas=True, fuse_pap=True, use_warm_start=True, device_warm_start=True)
    return JParams(**{**base, **kw})


def _inputs():
    if "inputs" not in _CACHE:
        _CACHE["inputs"] = jbuilders.honey_coil(n=32, dtype=jnp.float64)
    return _CACHE["inputs"]


def _port_inputs(jp):
    grid, scene = _inputs()
    return convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"), convert.params_from_jax(jp)


@partial(jax.jit, static_argnames=("grid", "params"))
def _jax_x0(grid, scene, params):
    cls, asm = jsolver._setup(grid, scene, params)
    return jsolver._build_krylov_system(grid, cls, asm, scene, params)[5]


def _port_x0(grid, scene, params, initial_guess=None):
    cls, asm = tsolver._setup(grid, scene, params)
    return tsolver._build_krylov_system(grid, cls, asm, scene, params, initial_guess)[-1]


# -- sample_density

def _density_case(value, n=16):
    grid, scene = honey_coil(n=n, dtype=torch.float64, device="cpu")
    field = torch.full(grid.res, value, dtype=torch.float64) if np.isscalar(value) else torch.from_numpy(value)
    return grid, scene, dataclasses.replace(scene, density=field)


def test_density_constant_field_matches_param():
    params = SolverParams(constant_density=1.0)
    _, scene, dense = _density_case(2.5)
    assert tsolver.sample_density(dense, params).constant_density == 2.5
    assert tsolver.sample_density(scene, params) is params  # no field: params itself
    low = tsolver.sample_density(_density_case(0.25)[2], params)
    assert low.effective_density == params.min_density  # clamped into [min_density, max_density]


def test_density_variable_field_rejected():
    var = np.full((16, 16, 16), 1.0)
    var[0, 0, 0] = 2.0
    with pytest.raises(ValueError, match="variable density"):
        tsolver.sample_density(_density_case(var)[2], SolverParams())


def test_density_constant_field_solve_matches_paramless():
    """A constant field gives the step of the same constant_density, bit for bit."""
    base = SolverParams(dtype=torch.float64, max_iterations=40, do_tile=True, tile_size=8, tile_padding=2,
                        bicgstab_fallback=False, preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True)
    grid, scene, dense = _density_case(2.0)
    with_field = tsolver.sample_density(dense, base)
    assert with_field.constant_density == 2.0
    vel_a, _, _ = tsolver.step(grid, scene, base.replace(constant_density=2.0))
    vel_b, _, _ = tsolver.step(grid, scene, with_field)
    for a in range(3):
        assert torch.equal(vel_a[a], vel_b[a])


def test_convert_carries_warm_start_and_density():
    jp = _jparams(use_warm_start=False)
    tp = convert.params_from_jax(jp)
    assert (tp.device_warm_start, tp.use_warm_start) == (True, False)
    grid, scene = _inputs()
    field = np.full(tuple(grid.res), 3.0)
    ts = convert.scene_from_numpy(dataclasses.replace(scene, density=jnp.asarray(field)), "cpu")
    assert ts.density.dtype == torch.float64 and np.array_equal(ts.density.numpy(), field)
    assert tsolver.sample_density(ts, tp).constant_density == 3.0


# -- the warm x0

@pytest.mark.parametrize("reduced", [True, False], ids=["tiled_T16", "uniform"])
def test_warm_x0_matches_jax(reduced):
    jp = _jparams(do_reduced_regions=reduced)
    grid, scene = _inputs()
    ref = np.asarray(_jax_x0(grid, scene, jp))
    got = _port_x0(*_port_inputs(jp)).numpy()
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=X0_RTOL * scale)


def test_initial_guess_wins_and_cold_start_is_zero():
    grid, scene, params = _port_inputs(_jparams())
    guess = _port_x0(grid, scene, params.replace(do_reduced_regions=False))
    given = _port_x0(grid, scene, params, initial_guess=unpack_ptau(guess))
    assert torch.equal(given, guess) and not torch.equal(given, _port_x0(grid, scene, params))
    for p in (params.replace(use_warm_start=False), params.replace(device_warm_start=False)):
        assert not bool(_port_x0(grid, scene, p).any())


# -- the warm step

def test_warm_step_matches_jax():
    jp = _jparams()
    vj, _, sj = jstep(*_inputs(), jp)
    vt, _, st = tsolver.step(*_port_inputs(jp))
    assert st["iterations"] == int(sj["iterations"]) == STEP_ITERS and st["n_regions"] == int(sj["n_regions"]) == 4
    scale = max(float(np.max(np.abs(np.asarray(v)))) for v in vj)
    for a in range(3):
        np.testing.assert_allclose(vt[a].numpy(), np.asarray(vj[a]), rtol=0, atol=STEP_RTOL * scale)
    assert abs(st["error"] - float(sj["error"])) <= STEP_RTOL * float(sj["error"])
