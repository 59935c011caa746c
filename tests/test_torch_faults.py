"""The two repairs of the port, where it departs from the JAX package on
purpose (ROADMAP.md Queue 3, divergences 4 and 5):

* **The fallback's write-back** (``solver._fallback``).  After PCG does
  not converge, the step keeps BiCGStab's result only where its x is
  finite and its true residual |b - A x| is no larger than PCG's, else
  PCG's x, iterations and error; ``stats["fallback_kept"]`` names the
  result kept.  Unit cases on a dense SPD system; one real input,
  viscous_beam 12^3 f32 uniform, tol 1e-8 that f32 cannot reach, 1000
  iterations each: JAX's fallback writes back a BiCGStab x that has blown
  up (its velocities many times max |v| off the converged fp64 solution),
  the port keeps PCG's x, bit-equal to the step without the fallback and
  near that solution.  Where BiCGStab's result is the better one the port
  keeps it and agrees with JAX in fp64: honey_coil 16^3 uniform,
  ``tests/test_torch_krylov_solvers.py::test_step_matches_jax[fallback]``,
  which also runs the JAX step this would repeat.
* **The checkpoint's dropped fields** (``io.checkpoint``): a port
  checkpoint of an SI scene keeps ``density``, ``surface_weights`` and
  ``collision_weights``; JAX's loader still reads it; the port still reads
  a JAX file, which has none of the three.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import step as jstep
from polystokes_tpu.io import checkpoint as jcheckpoint
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import SolverParams, convert, krylov, solver, step
from polystokes_tpu_torch.io import checkpoint
from polystokes_tpu_torch.scenes.builders import jelly_jam_si

torch.set_num_threads(1)


def _spd(n=12, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n))
    a = torch.from_numpy(q @ q.T + n * np.eye(n))
    b = torch.from_numpy(rng.standard_normal(n))
    return (lambda x: a @ x), a, b


def _result(x, iterations, error, applies=5, passes=4):
    return krylov.KrylovResult(x=x, iterations=iterations, error=error, converged=False, applies=applies,
                               passes=passes)


@pytest.mark.parametrize("case", ["nan", "inf", "larger_residual", "better"])
def test_fallback_keeps_the_better_result(case):
    apply_a, a, b = _spd()
    x_exact = torch.linalg.solve(a, b)
    pcg = _result(x_exact + 1e-3, 7, 0.5, applies=8, passes=9)
    fb_x = {"nan": torch.full_like(b, float("nan")), "inf": x_exact.clone().index_fill_(0, torch.tensor([3]), float("inf")),
            "larger_residual": x_exact + 1e-1, "better": x_exact + 1e-6}[case]
    fb = _result(fb_x, 11, 0.0, applies=34, passes=12)
    res, kept = solver._fallback(apply_a, b, pcg, fb)
    want = fb if case == "better" else pcg
    assert kept == ("bicgstab" if case == "better" else "pcg")
    assert res.x is want.x and res.iterations == want.iterations and res.error == want.error
    assert res.applies == 8 + 34 and res.passes == 9 + 12 and not res.converged


@pytest.fixture(scope="module")
def beam_f32():
    """The real input: JAX's step with its fallback, and the converged fp64
    solution of the same system (the port's, tol 1e-10)."""
    grid, scene = jbuilders.viscous_beam(n=12, dtype=jnp.float32)
    jp = JParams(dtype=jnp.float32, tolerance=1e-8, max_iterations=1000, do_tile=False, tile_size=4,
                 do_reduced_regions=False)
    vj, _, sj = jstep(grid, scene, jp)
    tgrid = convert.grid_from_jax(grid)
    ref, _, sr = step(tgrid, convert.scene_from_numpy(scene, "cpu", torch.float64),
                      convert.params_from_jax(jp).replace(dtype=torch.float64, tolerance=1e-10, max_iterations=5000))
    assert sr["converged"]
    return grid, scene, jp, [np.asarray(v) for v in vj], sj, [v.numpy() for v in ref]


def _off(v, ref):
    """max |v - ref| over max |ref|."""
    return max(float(np.abs(np.asarray(a, np.float64) - b).max()) for a, b in zip(v, ref)) / max(
        float(np.abs(b).max()) for b in ref)


def test_fallback_fault_in_jax_and_its_repair(beam_f32):
    grid, scene, jp, vj, sj, ref = beam_f32
    # the JAX package: PCG ran out, BiCGStab's blown-up x was written back
    assert not bool(sj["converged"]) and _off(vj, ref) > 1.0
    tgrid, tscene = convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu")
    params = convert.params_from_jax(jp)
    vt, _, st = step(tgrid, tscene, params)
    vp, _, sp = step(tgrid, tscene, params.replace(bicgstab_fallback=False))
    assert st["fallback_kept"] == "pcg" and sp["fallback_kept"] is None
    assert all(torch.equal(a, b) for a, b in zip(vt, vp))
    assert st["iterations"] == sp["iterations"] == 1000 and st["error"] == sp["error"]
    assert st["operator_applies"] == sp["operator_applies"] + 1 + 3 * 1000  # both solves counted
    assert _off([v.numpy() for v in vt], ref) < 1e-3


def _si_scene():
    grid, scene = jelly_jam_si(n=8, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(4)
    sw = tuple(torch.from_numpy(rng.uniform(0.0, 1.0, grid.face_shape(a))) for a in range(3))
    cw = tuple(torch.from_numpy(rng.uniform(0.0, 1.0, grid.face_shape(a))) for a in range(3))
    return grid, dataclasses.replace(scene, surface_weights=sw, collision_weights=cw)


def test_checkpoint_keeps_density_and_weights(tmp_path):
    grid, scene = _si_scene()
    assert scene.density is not None and float(scene.density.max()) == 1000.0
    params = solver.sample_density(scene, SolverParams(dtype=torch.float64))
    path = str(tmp_path / "si.npz")
    checkpoint.save_checkpoint(path, grid, scene, params, 3, extra={"note": np.arange(2)})
    g, sc, p, k, extra = checkpoint.load_checkpoint(path, device="cpu")
    assert g == grid and k == 3 and p == params and list(extra) == ["note"]
    assert torch.equal(sc.density, scene.density)
    for name in ("surface_weights", "collision_weights"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(sc, name), getattr(scene, name)))
    # a resumed SI scene keeps its density even where the params did not
    assert solver.sample_density(sc, SolverParams(dtype=torch.float64)).constant_density == 1000.0
    # JAX's loader reads the file; the three fields are among its extras
    jg, jsc, jp, jk, jextra = jcheckpoint.load_checkpoint(path)
    assert tuple(jg.res) == grid.res and jk == 3 and jp.constant_density == 1000.0
    np.testing.assert_array_equal(np.asarray(jsc.velocity[0]), scene.velocity[0].numpy())
    np.testing.assert_array_equal(jextra["scene_density"], scene.density.numpy())
    np.testing.assert_array_equal(jextra["scene_collision_weights2"], scene.collision_weights[2].numpy())


def test_port_reads_a_jax_checkpoint_without_extras(tmp_path):
    grid, scene = jbuilders.jelly_jam_si(n=8, dtype=jnp.float64)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_checkpoint(path, grid, scene, JParams(dtype=jnp.float64), 1)
    g, sc, p, k, extra = checkpoint.load_checkpoint(path, device="cpu")
    assert g.res == tuple(grid.res) and k == 1 and extra == {}
    assert sc.density is None and sc.surface_weights is None and sc.collision_weights is None
    np.testing.assert_array_equal(sc.surface_sdf.numpy(), np.asarray(scene.surface_sdf))
