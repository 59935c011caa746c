"""The port's ``step`` in the affine basis (``BasisOrder.AFFINE``, 11 DOFs
and K = 4 monomials a region; the CLI's ``--affine``) against the JAX
package's packed affine step, in fp64 on the CPU.

CELL_ARROW, ``fuse_pap=True``, no BiCGStab fallback, the JAX side through
its Pallas kernels in interpret mode at ``basis=AFFINE``; both steps stopped
after STEP_ITERS iterations with ``keep_non_converged``, before the two CG
trajectories part by round-off growth (as ``test_torch_tiled_step.py``
does): equal region and DOF counts and iterations, velocities and error
within STEP_RTOL.  Tiled on honey_coil 32^3 at tile 8 (16 regions; the
tiled 16^3 grid has none) and untiled on honey_coil 16^3 at tile 8.  The
port alone: the fused update with ``fuse_expand`` (the K = 4 forms of
kernels 1, 2, 4 and 11) against Path A at convergence, and the analog of
``tests/test_affine.py::test_affine_translation_preserved``.  Four tests,
no more: ``--dist loadfile`` hands out the files with the most tests
first, and a file of at most four runs after ``test_domain_crop.py``,
beside its long tail.
"""
import numpy as np
import torch

import jax.numpy as jnp

from polystokes_tpu import step as jstep
from polystokes_tpu.config import BasisOrder as JB
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import convert
from polystokes_tpu_torch import step as tstep

from test_step import small_params, sphere_scene

torch.set_num_threads(1)

STEP_ITERS = 40  # before the round-off growth of the two CG trajectories
STEP_RTOL = 1e-10  # fp64 over 40 iterations (1e-14 tiled at 32^3 and 2e-12 untiled at 16^3 measured)
FUSED_RTOL = 1e-10  # Path F against Path A, both converged: the same arithmetic in another grouping
TRANSLATION_ATOL = 1e-6  # tests/test_affine.py's bound


def _jparams(do_tile, **kw):
    base = dict(dtype=jnp.float64, do_tile=do_tile, tile_size=8, tile_padding=2, max_regions=64, basis=JB.AFFINE,
                preconditioner=JPC.CELL_ARROW, tolerance=1e-3, max_iterations=STEP_ITERS, keep_non_converged=True,
                bicgstab_fallback=False, use_pallas=True, fuse_pap=True)
    return JParams(**{**base, **kw})


def _port_step(grid, scene, params):
    return tstep(convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"), params)


def _against_jax(n, do_tile, regions):
    """JAX's packed affine step and the port's on honey_coil n^3, stopped at
    STEP_ITERS iterations."""
    grid, scene = jbuilders.honey_coil(n=n, dtype=jnp.float64)
    jp = _jparams(do_tile)
    vj, _, sj = jstep(grid, scene, jp)
    vt, _, st = _port_step(grid, scene, convert.params_from_jax(jp))
    for key in ("n_regions", "n_pressures", "n_active_velocities", "n_stresses", "n_reduced_dofs", "boundary_active",
                "iterations"):
        assert st[key] == int(sj[key]), key
    assert st["n_regions"] == regions and st["n_reduced_dofs"] == 11 * regions and st["iterations"] == STEP_ITERS
    vj = [np.asarray(v) for v in vj]
    scale = max(float(np.max(np.abs(v))) for v in vj)
    for a in range(3):
        np.testing.assert_allclose(vt[a].numpy(), vj[a], rtol=0, atol=STEP_RTOL * scale)
    ej = float(sj["error"])
    assert abs(st["error"] - ej) <= STEP_RTOL * ej


def test_tiled_affine_step_matches_jax():
    _against_jax(32, do_tile=True, regions=16)


def test_untiled_affine_step_matches_jax():
    _against_jax(16, do_tile=False, regions=1)


def test_fused_update_agrees_with_path_a_at_convergence():
    """F_aff (fuse_update with fuse_expand: exp_finish_update at K = 4)
    against A_aff, tiled at 32^3, tile 8, both converged at tol 1e-3."""
    grid, scene = jbuilders.honey_coil(n=32, dtype=jnp.float64)
    p = convert.params_from_jax(_jparams(True, max_iterations=5000, keep_non_converged=False))
    va, _, sa = _port_step(grid, scene, p)
    vf, _, sf = _port_step(grid, scene, p.replace(fuse_update=True, fuse_expand=True))
    assert sa["converged"] and sf["converged"] and sa["error"] < 1e-3
    assert sa["iterations"] == sf["iterations"] and sa["n_regions"] == sf["n_regions"] == 16
    scale = max(float(v.abs().max()) for v in va)
    for a in range(3):
        assert float((vf[a] - va[a]).abs().max()) <= FUSED_RTOL * scale


def test_affine_translation_preserved():
    """A constant velocity is an affine field: the affine step keeps it on
    every valid face (sphere of liquid at 24^3, tile 6, 8 regions)."""
    grid, _ = sphere_scene(n=24)
    const = (0.4, 0.1, -0.6)
    vel = tuple(jnp.full(grid.face_shape(a), const[a], jnp.float64) for a in range(3))
    grid, scene = sphere_scene(n=24, velocity=vel)
    p = convert.params_from_jax(small_params(basis=JB.AFFINE, tolerance=1e-9, tile_size=6, use_pallas=True))
    out, valid, stats = _port_step(grid, scene, p)
    assert stats["converged"] and stats["n_regions"] >= 1
    for a in range(3):
        got = out[a][valid[a]].numpy()
        assert got.size > 0
        np.testing.assert_allclose(got, const[a], atol=TRANSLATION_ATOL)
