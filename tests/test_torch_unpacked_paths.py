"""The unpacked path's surroundings in the port against the JAX package, in
fp64 on the CPU: the defaults, ``check_pallas``'s fallback, the unpacked
apply against the packed one, and the unpacked ``solve_chunked`` state
file, which each package resumes from the other's.  Four tests.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import solver as jsolver
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams

from polystokes_tpu_torch import convert
from polystokes_tpu_torch import packed_apply as pa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.config import PreconditionerType, SolverParams
from polystokes_tpu_torch.operators import PTau

from test_operators import make_case
from test_torch_unpacked import make_scene

torch.set_num_threads(1)

APPLY_RTOL = 1e-12  # the unpacked apply against the packed twins: the same terms, summed otherwise
CHUNK_RTOL = 1e-10  # times max |v|: 20 iterations of fp64 CG in two packages


def test_solver_params_defaults_equal_jax():
    """SolverParams() is JAX's SolverParams() field by field (the dtype
    mapped): IDENTITY and the unpacked apply by default."""
    assert convert.params_from_jax(JParams()) == SolverParams()
    assert SolverParams().preconditioner == PreconditionerType.IDENTITY and not SolverParams().use_pallas


def test_check_pallas_falls_back_as_jax():
    """Liquid on the index-0 planes (make_case's all-liquid box): both
    packages warn and return use_pallas=False; the port's step then runs
    unpacked, converges (no packed fail-safe) and launches no kernel.
    Where the packed path is not taken check_pallas returns params as is."""
    jgrid, jparams, jscene = make_case(res=(16, 16, 16), tile=8, reduced=True, solid=False)
    jparams = jparams.replace(use_pallas=True, preconditioner=JPC.CELL_ARROW, tolerance=1e-6, max_iterations=400,
                              bicgstab_fallback=False)
    grid, scene, params = (convert.grid_from_jax(jgrid), convert.scene_from_numpy(jscene, "cpu"),
                           convert.params_from_jax(jparams))
    with pytest.warns(UserWarning, match="index-0 planes") as jw:
        jout = jsolver.check_pallas(jgrid, jscene, jparams)
    with pytest.warns(UserWarning, match="index-0 planes") as tw:
        tout = tsolver.check_pallas(grid, scene, params)
    assert str(tw[0].message) .split(";")[0] == str(jw[0].message).split(";")[0]
    assert not jout.use_pallas and tout == convert.params_from_jax(jout) == params.replace(use_pallas=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tsolver.check_pallas(grid, scene, tout) is tout
    pa.reset_launches()
    _, _, stats = tsolver.step(grid, scene, tout)
    assert stats["converged"] and stats["boundary_active"] > 0 and not any(pa.LAUNCHES.values())
    _, _, packed = tsolver.step(grid, scene, params.replace(do_solve=False))
    assert not packed["converged"]  # the packed fail-safe, had the fallback not run


def test_unpacked_apply_agrees_with_packed():
    """On scenes without boundary activity the unpacked apply and the
    packed one (the kernels' plain twins here) agree through pack_ptau:
    tiled T8, untiled cube regions and uniform, each on a solid-cut floor."""
    rng = np.random.default_rng(7)
    cases = (((16, 16, 16), 0.03, dict(do_tile=True, tile_size=8, tile_padding=2)),
             ((24, 16, 16), 0.04, dict(do_tile=False, tile_size=8, max_regions=64)),
             ((16, 16, 16), 0.03, dict(do_reduced_regions=False)))
    for res, wall, kw in cases:
        jgrid, jscene = make_scene(res, wall)
        grid, scene = convert.grid_from_jax(jgrid), convert.scene_from_numpy(jscene, "cpu")
        params = SolverParams(dtype=torch.float64, use_pallas=True, **kw)
        cls, asm = tsolver._setup(grid, scene, params)
        assert tsolver._boundary_active(cls) == 0 and tsolver._use_packed(grid, params)
        R = tsolver.effective_max_regions(grid, params)
        x = PTau(p=torch.from_numpy(rng.standard_normal(grid.center_shape)),
                 tc=tuple(torch.from_numpy(rng.standard_normal(grid.center_shape)) for _ in range(3)),
                 te=tuple(torch.from_numpy(rng.standard_normal(grid.edge_shape(e))) for e in range(3)))
        got = pa.pack_ptau(tsolver.make_apply(grid, cls, asm, params.replace(use_pallas=False), R)(x))
        ref = tsolver.make_apply_packed(grid, cls, asm, params, R)(pa.pack_ptau(x))
        assert float((got - ref).abs().max()) <= APPLY_RTOL * float(ref.abs().max()), kw


def test_unpacked_state_file_interchanges(tmp_path):
    """solve_chunked on the unpacked layout, stopped after one segment of
    10 iterations with a state file (25 leaves: x, r and p as seven fields
    each, then rsold, k, rre, done): each package resumes from the other's
    file to 20 iterations, and the two results agree within CHUNK_RTOL
    (general regions, CELL_ARROW)."""
    jgrid, jscene = make_scene((24, 16, 16), 0.04)
    jparams = JParams(dtype=jnp.float64, do_tile=False, tile_size=8, max_regions=64, cube_regions=False,
                      preconditioner=JPC.CELL_ARROW, tolerance=1e-12, max_iterations=20, bicgstab_fallback=False)
    grid, scene, params = (convert.grid_from_jax(jgrid), convert.scene_from_numpy(jscene, "cpu"),
                           convert.params_from_jax(jparams))
    stop = lambda s: True  # noqa: E731
    path_j, path_t = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsolver.solve_chunked(jgrid, jscene, jparams, segment_iters=10, callback=stop, state_path=path_j)
    _, _, st = tsolver.solve_chunked(grid, scene, params, segment_iters=10, callback=stop, state_path=path_t)
    assert st["interrupted"] and st["iterations"] == 10
    with np.load(path_t) as dt_, np.load(path_j) as dj:
        assert sorted(dt_.files) == sorted(dj.files) and len(dt_.files) == 25
        for k in dj.files:
            assert dt_[k].shape == dj[k].shape and dt_[k].dtype == dj[k].dtype, k
    vj, _, sj = jsolver.solve_chunked(jgrid, jscene, jparams, segment_iters=10, state_path=path_t, resume=True)
    vt, _, st = tsolver.solve_chunked(grid, scene, params, segment_iters=10, state_path=path_j, resume=True)
    assert st["iterations"] == int(sj["iterations"]) == 20
    scale = max(float(np.abs(np.asarray(v)).max()) for v in vj)
    assert max(float(np.abs(t.numpy() - np.asarray(j)).max()) for t, j in zip(vt, vj)) <= CHUNK_RTOL * scale
