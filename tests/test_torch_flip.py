"""The port's FLIP particle loop (``polystokes_tpu_torch.flip``) against the
JAX package's on the CPU, fp64 at 16^3, with the JAX side run once in a
module-scoped fixture:

* ``seed_particles`` bit-equal in f32 and fp64 (the same numpy stream);
* ``p2g``, ``g2p_flip``, ``advect_particles`` and
  ``surface_from_particles`` on jelly_jam's particles with random
  velocities, and ``reseed`` on a stretched sheet and on escapees (the
  cases of ``tests/test_flip.py``), within TRANSFER_RTOL of max;
* one ``flip_frame`` with reseeding on jelly_jam 16^3 (the uniform step,
  CELL_ARROW, tol 1e-8; the reduced step is held to JAX's in its own
  files, and JAX's reduced frame takes 30 s to compile on a CPU):
  velocities within FRAME_VEL_RTOL of max |v|, particle positions within
  POS_ATOL cells, the same particles alive;
* the port alone: the fixed-order P2G sum against a float64 reference and
  bit-equal on a repeat; the CLI's ``--flip``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from polystokes_tpu import flip as jflip
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.grid import Grid as JGrid
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import convert, flip, run

torch.set_num_threads(1)

N = 16
P = 40000
TRANSFER_RTOL = 1e-12  # fp64: the P2G sums in another order than JAX's scatter
FRAME_VEL_RTOL = 1e-6  # two tol-1e-8 solves of one system (6.5e-9 measured)
POS_ATOL = 1e-8  # cells
FRAME_TOL = 1e-8


def _sheet(n):
    """The stretched-sheet input of tests/test_flip.py at n: a block in x,
    a slab in z, its particles pulled apart along x by 12 %."""
    x = np.arange(n) / n
    X, _, Z = np.meshgrid(x, x, x, indexing="ij")
    sdf = np.maximum(np.maximum(0.35 - Z, Z - 0.65), np.abs(X - 0.5) - 0.15)
    st = jflip.seed_particles(JGrid(res=(n, n, n), dx=1.0 / n), sdf, 1 << 14, seed=2, dtype=jnp.float64)
    c = n / 2.0
    pos = np.asarray(st.pos).copy()
    pos[:, 0] = np.clip(c + (pos[:, 0] - c) * 1.12, 0.01, n - 0.01)
    return jflip.FlipState(pos=jnp.asarray(pos), vel=st.vel, alive=st.alive)


def _escapees(n):
    """Two particles against a z slab: one deep inside, one far outside."""
    x = np.arange(n) / n
    _, _, Z = np.meshgrid(x, x, x, indexing="ij")
    sdf = np.maximum(0.3 - Z, Z - 0.7)
    st = jflip.FlipState(pos=jnp.asarray([[8.0, 8.0, 8.0], [8.0, 8.0, 15.5]]), vel=jnp.zeros((2, 3)),
                         alive=jnp.ones(2))
    return st, sdf


@pytest.fixture(scope="module")
def ref():
    """Every JAX result of this file, computed once."""
    grid, scene = jbuilders.jelly_jam(n=N, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    st = jflip.seed_particles(grid, scene.surface_sdf, P, dtype=jnp.float64)
    st = jflip.FlipState(pos=st.pos, vel=jnp.asarray(rng.standard_normal((P, 3))), alive=st.alive)
    vel_old = tuple(jnp.asarray(rng.standard_normal(grid.face_shape(a))) for a in range(3))
    vel_new = tuple(jnp.asarray(rng.standard_normal(grid.face_shape(a))) for a in range(3))
    out = {"grid": grid, "scene": scene, "state": st, "vel_old": vel_old, "vel_new": vel_new}
    sheet = _sheet(N)
    esc, esdf = _escapees(N)
    zeros = tuple(jnp.zeros(grid.face_shape(a)) for a in range(3))

    def transfers(st, vel_old, vel_new, sheet, esc, esdf):
        # one jitted call: JAX compiles it once instead of op by op
        surf = jflip.surface_from_particles(sheet, grid, dtype=jnp.float64)
        return (jflip.p2g(st, grid, jnp.float64), jflip.g2p_flip(st, vel_old, vel_new, 0.95),
                jflip.advect_particles(st, vel_new, 0.7, grid.res), jflip.surface_from_particles(st, grid, dtype=jnp.float64),
                surf, jflip.reseed(sheet, grid, surf, vel_new, 3, min_ppc=3.0, target_ppc=6),
                jflip.reseed(esc, grid, esdf, zeros, 0, min_ppc=0.5, target_ppc=1))

    res = jax.jit(transfers)(st, vel_old, vel_new, sheet, esc, jnp.asarray(esdf))
    out["p2g"], out["g2p"], out["advect"], out["surface"], surf = res[:5]
    out["sheet"] = (sheet, surf, vel_new, res[5])
    out["escapees"] = (esc, esdf, zeros, res[6])

    jp = JParams(dtype=jnp.float64, preconditioner=JPC.CELL_ARROW, tolerance=FRAME_TOL, max_iterations=3000,
                 bicgstab_fallback=False, do_reduced_regions=False)
    frame_state = jflip.seed_particles(grid, scene.surface_sdf, P, dtype=jnp.float64)
    frame = jflip.flip_frame(grid, scene, frame_state, jp, do_reseed=True, frame_idx=1)
    frame[0].velocity[0].block_until_ready()  # JAX dispatches asynchronously: finish inside the fixture
    out["frame"] = (jp, frame_state, frame)
    return out


def _close(got, want, rtol=TRANSFER_RTOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _port(ref):
    return convert.grid_from_jax(ref["grid"]), convert.flip_state_from_numpy(ref["state"], "cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_seed_particles_bit_equal(ref, dtype):
    grid, scene = ref["grid"], ref["scene"]
    want = jflip.seed_particles(grid, scene.surface_sdf, 3000, seed=5, dtype=getattr(jnp, dtype))
    got = flip.seed_particles(convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu").surface_sdf, 3000,
                              seed=5, dtype=getattr(torch, dtype))
    assert got.pos.device.type == "cpu" and got.pos.dtype == getattr(torch, dtype)
    for f in ("pos", "vel", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert 0 < int(got.alive.sum()) < 3000 or int(got.alive.sum()) == 3000


def test_p2g_matches_jax(ref):
    grid, st = _port(ref)
    back = convert.flip_state_to_numpy(st)  # the inverse of flip_state_from_numpy
    assert all(np.array_equal(back[f], np.asarray(getattr(ref["state"], f))) for f in ("pos", "vel", "alive"))
    vel, cov = flip.p2g(st, grid, torch.float64)
    for a in range(3):
        _close(vel[a], ref["p2g"][0][a])
        _close(cov[a], ref["p2g"][1][a])
        assert bool((cov[a] > 0).any())


def test_g2p_and_advection_match_jax(ref):
    grid, st = _port(ref)
    v_old = tuple(torch.from_numpy(np.asarray(v)) for v in ref["vel_old"])
    v_new = tuple(torch.from_numpy(np.asarray(v)) for v in ref["vel_new"])
    _close(flip.g2p_flip(st, v_old, v_new, 0.95).vel, ref["g2p"].vel)
    adv = flip.advect_particles(st, v_new, 0.7, grid.res)
    _close(adv.pos, ref["advect"].pos)
    np.testing.assert_array_equal(adv.alive.numpy(), np.asarray(ref["advect"].alive))


def test_surface_from_particles_matches_jax(ref):
    grid, st = _port(ref)
    _close(flip.surface_from_particles(st, grid, dtype=torch.float64), ref["surface"])


@pytest.mark.parametrize("case", ["sheet", "escapees"])
def test_reseed_matches_jax(ref, case):
    st, sdf, vel, want = ref[case]
    frame = 3 if case == "sheet" else 0
    kw = dict(min_ppc=3.0, target_ppc=6) if case == "sheet" else dict(min_ppc=0.5, target_ppc=1)
    grid = convert.grid_from_jax(ref["grid"])
    got = flip.reseed(convert.flip_state_from_numpy(st, "cpu"), grid, torch.from_numpy(np.asarray(sdf)),
                      tuple(torch.from_numpy(np.asarray(v)) for v in vel), frame, **kw)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    _close(got.pos, want.pos)
    _close(got.vel, want.vel)
    if case == "sheet":
        refilled = (np.asarray(want.alive) > 0) & (np.asarray(st.alive) == 0)
        assert refilled.sum() > 100  # the stretch left deficits the dead pool refilled


def test_flip_frame_matches_jax(ref):
    jp, st0, (out_j, st_j, stats_j) = ref["frame"]
    grid, scene = convert.grid_from_jax(ref["grid"]), convert.scene_from_numpy(ref["scene"], "cpu")
    out, st, stats = flip.flip_frame(grid, scene, convert.flip_state_from_numpy(st0, "cpu"),
                                     convert.params_from_jax(jp), do_reseed=True, frame_idx=1)
    assert stats["converged"] and bool(stats_j["converged"])
    vmax = max(float(jnp.abs(v).max()) for v in out_j.velocity)
    for a in range(3):
        _close(out.velocity[a], out_j.velocity[a], FRAME_VEL_RTOL * vmax / float(np.abs(out_j.velocity[a]).max()))
    _close(out.surface_sdf, out_j.surface_sdf)
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(st_j.alive))
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(st_j.pos), rtol=0, atol=POS_ATOL)


def test_p2g_sum_is_fixed_and_exact():
    """The fixed-order scatter against a float64 index_add_ (the sums of
    the same samples), and bit-equal on a repeat."""
    rng = np.random.default_rng(11)
    idx = torch.from_numpy(rng.integers(0, 50, 5000))
    vals = torch.from_numpy(rng.standard_normal((5000, 2))).float()
    got = flip._fixed_order_scatter(idx, vals, 64)
    want = torch.zeros((64, 2), dtype=torch.float64).index_add_(0, idx, vals.double())
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0, atol=2e-5 * float(want.abs().max()))
    assert torch.equal(got, flip._fixed_order_scatter(idx, vals, 64))
    assert bool((got[50:] == 0).all())


def test_cli_flip_runs_frames(capsys):
    run.main(["--scene", "jelly_jam", "--n", "8", "--flip", "2000", "--steps", "2", "--fp64", "--tolerance", "1e-5",
              "--precond", "cell_arrow", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "seeded " in out and " / 2000 particles" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("frame ")]
    assert [ln.split(":")[0] for ln in lines] == ["frame 0", "frame 1"]
    assert all("converged=True" in ln for ln in lines)


def test_simulate_flip_frames_and_state():
    from polystokes_tpu_torch.scenes.builders import jelly_jam

    grid, scene = jelly_jam(n=8, dtype=torch.float64, device="cpu")
    from polystokes_tpu_torch import PreconditionerType, SolverParams

    params = SolverParams(dtype=torch.float64, preconditioner=PreconditionerType.CELL_ARROW, tolerance=1e-5)
    seen = []
    out, st, stats = flip.simulate_flip(grid, scene, params, 2, max_particles=3000,
                                        callback=lambda k, sc, s, stt: seen.append(k))
    assert seen == [0, 1] and len(stats) == 2 and all(s["converged"] for s in stats)
    assert dataclasses.is_dataclass(st) and st.pos.shape == (3000, 3)
    assert bool(((st.pos >= 0.01) & (st.pos <= 8 - 0.01)).all())
    assert all(bool(torch.isfinite(v).all()) for v in out.velocity)
