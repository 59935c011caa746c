"""The port's ``solve_chunked`` against ``polystokes_tpu.solver.solve_chunked``
and against the port's own ``step``.

honey_coil 16^3, fp64, untiled cube regions, tile 8, padding 2,
max_regions 64, CELL_ARROW, tol 1e-3, ``use_pallas=True`` (the JAX side
through its Pallas kernels in interpret mode), ``fuse_pap=True``, no
BiCGStab fallback, segments of 13 iterations.  One JAX run gives both its
full result and, through a callback that copies the state file after
segment 2, a k = 26 state.

* Against JAX: the port's k = 26 state equal to JAX's (k and done
  exactly, the vectors and scalars within STATE_RTOL); iterations within
  MAX_ITER_DIFF, velocities within VEL_ATOL max |v| and error within
  ERROR_RTOL for the port's whole chunked solve and for the port resumed
  from JAX's k = 26 state file.  The two packages' rre agree to 1e-13 over
  the first 20 iterations and part by round-off growth after that (2e-2
  relative at iteration 100, 0.15 at 201, the last), so the converged
  solves agree only as far as two tol-1e-3 solves of one system do.
* The port against itself, bit for bit: ``solve_chunked`` and ``step``;
  a run stopped by a callback after 2 segments (26 iterations), resumed
  from its state file, and the uninterrupted one; a zero ``initial_guess``
  and none.
* ``max_seconds=0.0``: one segment, interrupted, not converged, the
  velocities unchanged under ``keep_non_converged=False``.
* ``step`` seeded with the converged solution converges at once.
* The state file's keys and dtypes are JAX's.
"""
import shutil

import numpy as np
import torch

import jax.numpy as jnp

from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.scenes import builders as jbuilders
from polystokes_tpu.solver import solve_chunked as jsolve_chunked

from polystokes_tpu_torch import convert, solve_chunked, step
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.packed_apply import unpack_ptau

torch.set_num_threads(1)

SEGMENT = 13
VEL_ATOL = 2e-4  # times max |v_jax|: the packed-against-XLA bound of tests/test_pallas_apply.py
# sqrt of the last rre: the round-off growth above leaves 0.15 between the
# two packages' last rre, 8 % in its square root (8.97e-4 against 9.78e-4)
ERROR_RTOL = 0.1
MAX_ITER_DIFF = 3
STATE_RTOL = 1e-10  # fp64 after 26 iterations, before round-off has grown (1e-13 measured on rre)

_CACHE = {}


def _jparams(**kw):
    return JParams(dtype=jnp.float64, do_tile=False, tile_size=8, tile_padding=2, max_regions=64,
                   preconditioner=JPC.CELL_ARROW, tolerance=1e-3, max_iterations=2000, bicgstab_fallback=False,
                   use_pallas=True, fuse_pap=True, **kw)


def _jax(tmp_path_factory):
    """JAX's chunked solve, once: its result and its state file at k = 26."""
    if "jax" not in _CACHE:
        d = tmp_path_factory.mktemp("jax_chunked")
        sp, sp26 = str(d / "state.npz"), str(d / "state_k26.npz")
        segs = [0]

        def keep_second(_):
            segs[0] += 1
            if segs[0] == 2:
                shutil.copy(sp, sp26)
            return False

        grid, scene = jbuilders.honey_coil(n=16, dtype=jnp.float64)
        vel, _, st = jsolve_chunked(grid, scene, _jparams(), segment_iters=SEGMENT, callback=keep_second, state_path=sp)
        _CACHE["jax"] = dict(grid=grid, scene=scene, vel=[np.asarray(v) for v in vel], stats=st, state26=sp26,
                             state=sp)
    return _CACHE["jax"]


def _port_inputs(tmp_path_factory):
    j = _jax(tmp_path_factory)
    return convert.grid_from_jax(j["grid"]), convert.scene_from_numpy(j["scene"], "cpu"), convert.params_from_jax(_jparams())


def _port_full(tmp_path_factory):
    if "port" not in _CACHE:
        grid, scene, params = _port_inputs(tmp_path_factory)
        _CACHE["port"] = solve_chunked(grid, scene, params, segment_iters=SEGMENT)
    return _CACHE["port"]


def _agree_with_jax(j, vel, stats):
    sj = j["stats"]
    assert stats["converged"] and bool(sj["converged"])
    assert abs(stats["iterations"] - int(sj["iterations"])) <= MAX_ITER_DIFF
    scale = max(float(np.abs(v).max()) for v in j["vel"])
    for a in range(3):
        np.testing.assert_allclose(vel[a].numpy(), j["vel"][a], rtol=0, atol=VEL_ATOL * scale)
    assert abs(stats["error"] - float(sj["error"])) <= ERROR_RTOL * float(sj["error"])


def _bit_equal(v1, v2):
    return all(torch.equal(a, b) for a, b in zip(v1, v2))


def test_chunked_agrees_with_jax(tmp_path_factory):
    vel, _, stats = _port_full(tmp_path_factory)
    assert not stats["interrupted"]
    _agree_with_jax(_jax(tmp_path_factory), vel, stats)


def test_state_at_k26_matches_jax(tmp_path_factory, tmp_path):
    j = _jax(tmp_path_factory)
    grid, scene, params = _port_inputs(tmp_path_factory)
    sp = str(tmp_path / "state.npz")
    solve_chunked(grid, scene, params, segment_iters=SEGMENT, state_path=sp, callback=lambda s: s["iterations"] >= 26)
    with np.load(sp) as mine, np.load(j["state26"]) as theirs:
        for key in ("leaf4", "leaf6"):  # k, done
            assert mine[key] == theirs[key], key
        for key in ("leaf0", "leaf1", "leaf2", "leaf3", "leaf5"):  # x, r, p, rsold, rre
            np.testing.assert_allclose(mine[key], theirs[key], rtol=0, atol=STATE_RTOL * np.abs(theirs[key]).max(),
                                       err_msg=key)


def test_resume_from_jax_state_agrees_with_jax(tmp_path_factory):
    j = _jax(tmp_path_factory)
    assert int(np.load(j["state26"])["leaf4"]) == 2 * SEGMENT
    grid, scene, params = _port_inputs(tmp_path_factory)
    vel, _, stats = solve_chunked(grid, scene, params, segment_iters=SEGMENT, state_path=j["state26"], resume=True)
    assert not stats["interrupted"]
    _agree_with_jax(j, vel, stats)


def test_chunked_bit_equal_to_step(tmp_path_factory):
    grid, scene, params = _port_inputs(tmp_path_factory)
    vel, _, stats = _port_full(tmp_path_factory)
    vel_s, _, stats_s = step(grid, scene, params)
    assert stats["iterations"] == stats_s["iterations"]
    assert stats["operator_applies"] == stats_s["operator_applies"]
    assert _bit_equal(vel, vel_s)


def test_interrupt_then_resume_bit_equal(tmp_path_factory, tmp_path):
    grid, scene, params = _port_inputs(tmp_path_factory)
    sp = str(tmp_path / "pcg_state.npz")
    segs = [0]

    def stop_after_two(s):
        segs[0] += 1
        return segs[0] >= 2

    _, _, st = solve_chunked(grid, scene, params, segment_iters=SEGMENT, callback=stop_after_two, state_path=sp)
    assert st["interrupted"] and st["iterations"] == 2 * SEGMENT and not st["converged"]
    vel_r, _, st_r = solve_chunked(grid, scene, params, segment_iters=SEGMENT, state_path=sp, resume=True)
    vel, _, stats = _port_full(tmp_path_factory)
    assert not st_r["interrupted"] and st_r["iterations"] == stats["iterations"]
    assert _bit_equal(vel_r, vel)


def test_max_seconds_zero_stops_after_one_segment(tmp_path_factory):
    grid, scene, params = _port_inputs(tmp_path_factory)
    vel, _, st = solve_chunked(grid, scene, params.replace(keep_non_converged=False), segment_iters=5, max_seconds=0.0)
    assert st["interrupted"] and st["iterations"] == 5 and not st["converged"]
    assert _bit_equal(vel, scene.velocity)


def test_zero_initial_guess_bit_equal_to_default(tmp_path_factory):
    grid, scene, params = _port_inputs(tmp_path_factory)
    guess = unpack_ptau(torch.zeros((7,) + grid.res, dtype=params.dtype))
    vel, _, stats = solve_chunked(grid, scene, params, segment_iters=SEGMENT, initial_guess=guess)
    vel_d, _, stats_d = _port_full(tmp_path_factory)
    assert stats["iterations"] == stats_d["iterations"]
    assert _bit_equal(vel, vel_d)


def test_state_file_keys_and_dtypes_match_jax(tmp_path_factory, tmp_path):
    j = _jax(tmp_path_factory)
    grid, scene, params = _port_inputs(tmp_path_factory)
    sp = str(tmp_path / "state.npz")
    solve_chunked(grid, scene, params, segment_iters=SEGMENT, state_path=sp, callback=lambda s: True)
    with np.load(sp) as mine, np.load(j["state"]) as theirs:
        assert list(mine.keys()) == list(theirs.keys()) == [f"leaf{i}" for i in range(7)]
        for key in theirs.keys():
            assert (mine[key].dtype, mine[key].shape) == (theirs[key].dtype, theirs[key].shape), key


def test_step_takes_initial_guess(tmp_path_factory):
    """Seeded with the converged solution, step converges at once, to the
    same velocities."""
    grid, scene, params = _port_inputs(tmp_path_factory)
    cls, asm = tsolver._setup(grid, scene, params)
    carry, loop = tsolver._chunk_init(grid, scene, params, cls, asm)
    x = loop.segment(carry).x
    vel, _, stats = step(grid, scene, params, initial_guess=unpack_ptau(x))
    vel_d, _, _ = _port_full(tmp_path_factory)
    assert stats["converged"] and stats["iterations"] <= 1
    scale = max(float(v.abs().max()) for v in vel_d)
    for a in range(3):
        torch.testing.assert_close(vel[a], vel_d[a], rtol=0, atol=VEL_ATOL * scale)
