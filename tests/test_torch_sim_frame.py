"""The port's frame loop (``polystokes_tpu_torch.sim``) end to end on the CPU.

* One ``simulate_frame`` against the JAX package's, fp64: honey_coil 32^3,
  tiled at tile 16 (4 regions), CELL_ARROW, ``fuse_pap``, the device warm
  start on, both solves stopped after STEP_ITERS iterations with
  ``keep_non_converged``; velocities and surface SDF within FRAME_RTOL of
  their max.  JAX's packed step runs through its Pallas kernels in
  interpret mode.
* The port alone: three frames of a viscous beam sag under gravity,
  converged and finite (the counterpart of
  ``tests/test_sim.py::test_beam_sags_over_frames``, at n = 24, the
  nearest multiple of the packed path's tile 8 to that test's n = 20); and
  ``simulate`` is ``simulate_frame`` chained with ``cfl_substeps``.
Four tests at most: ``--dist loadfile`` hands out the files with the most
tests first, and a file of at most four runs beside the long tail of
``test_domain_crop.py``.
"""
import numpy as np
import torch

import jax.numpy as jnp

from polystokes_tpu import sim as jsim
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import PreconditionerType, SolverParams, convert, sim
from polystokes_tpu_torch.scenes.builders import honey_coil, viscous_beam
from polystokes_tpu_torch.solver import check_pallas

torch.set_num_threads(1)

# the packed CELL_ARROW path, stated since the defaults became JAX's (IDENTITY, unpacked)
PACKED_ARROW = dict(preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True)

STEP_ITERS = 40  # before the two packages' CG trajectories part by round-off growth
FRAME_RTOL = 1e-10


def test_simulate_frame_matches_jax():
    jp = JParams(dtype=jnp.float64, do_tile=True, tile_size=16, tile_padding=2, preconditioner=JPC.CELL_ARROW,
                 tolerance=1e-3, max_iterations=STEP_ITERS, keep_non_converged=True, bicgstab_fallback=False,
                 use_pallas=True, fuse_pap=True, use_warm_start=True, device_warm_start=True)
    grid, scene = jbuilders.honey_coil(n=32, dtype=jnp.float64)
    substeps = jsim.cfl_substeps(scene.velocity, float(scene.dt) / grid.dx)
    ref, sj = jsim.simulate_frame(grid, scene, jp, substeps=substeps)
    tgrid, tscene = convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu")
    assert sim.cfl_substeps(tscene.velocity, float(tscene.dt) / tgrid.dx) == substeps
    got, st = sim.simulate_frame(tgrid, tscene, convert.params_from_jax(jp), substeps=substeps)
    assert st["iterations"] == int(sj["iterations"]) == STEP_ITERS and st["n_regions"] == int(sj["n_regions"]) == 4
    for g, r in list(zip(got.velocity, ref.velocity)) + [(got.surface_sdf, ref.surface_sdf)]:
        r = np.asarray(r)
        assert g.dtype == torch.float64 and tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=FRAME_RTOL * np.abs(r).max())


def test_beam_sags_over_frames():
    """A clamped viscous beam under gravity moves down (its centre of
    liquid mass falls in z), staying finite and converged."""
    grid, scene = viscous_beam(n=24, dtype=torch.float64, device="cpu", viscosity=5.0, dt=1 / 24)
    params = check_pallas(grid, scene, SolverParams(dtype=torch.float64, do_tile=True, tile_size=8, tile_padding=2,
                                                    tolerance=1e-5, max_iterations=1500,
                                                    bicgstab_fallback=False, **PACKED_ARROW))

    def com_z(s):
        m = (s.surface_sdf < 0).double()
        zs = torch.arange(grid.res[2], dtype=torch.float64)[None, None, :]
        return float((m * zs).sum() / max(float(m.sum()), 1.0))

    z0 = com_z(scene)
    out, stats = sim.simulate(grid, scene, params, frames=3)
    assert len(stats) == 3
    for st in stats:
        assert st["converged"] and np.isfinite(st["error"])
    for v in out.velocity:
        assert bool(torch.isfinite(v).all())
    assert com_z(out) < z0  # the free end sags under gravity


def test_simulate_chains_frames_with_cfl_substeps():
    """``simulate`` runs ``simulate_frame`` at each frame's CFL substep count
    and calls back after every frame; equal results, bit for bit."""
    grid, scene = honey_coil(n=16, dtype=torch.float64, device="cpu")
    params = SolverParams(dtype=torch.float64, do_tile=True, tile_size=8, tile_padding=2, max_iterations=30,
                          device_warm_start=True, bicgstab_fallback=False, **PACKED_ARROW)
    seen = []
    out, stats = sim.simulate(grid, scene, params, frames=2, callback=lambda k, s, st: seen.append((k, st)))
    assert [k for k, _ in seen] == [0, 1] and [st["iterations"] for _, st in seen] == [s["iterations"] for s in stats]
    ref = scene
    for _ in range(2):
        n_sub = sim.cfl_substeps(ref.velocity, float(ref.dt) / grid.dx)
        ref, _ = sim.simulate_frame(grid, ref, params, substeps=n_sub)
    for g, r in list(zip(out.velocity, ref.velocity)) + [(out.surface_sdf, ref.surface_sdf)]:
        assert torch.equal(g, r)
