"""The sharded step of ``polystokes_tpu_torch.parallel.sharding`` on CPU
slabs, against the port's unsharded step and the JAX package's
``sharded_step`` (fp64, 8 virtual JAX devices, conftest.py).

``sharded_step`` on a 1-D mesh of 2 CPU slabs is the unsharded step with
``fuse_pap=False`` bit for bit (honey_coil 32^3 tiled, 16 regions), and
matches JAX's ``sharded_step`` on 2 virtual devices on jelly_jam 16^3;
``solve_chunked(mesh=...)`` is the unsharded step's solve; a 2 x 2 mesh
and REGION_ARROW warn and run unsharded (unpacked, on the first device);
``make_mesh`` shapes meshes as JAX's does; ``dryrun_multichip`` runs on 8
CPU slabs.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.parallel import sharding as jsharding
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import convert, solve_chunked, step
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.config import PreconditionerType as TPC
from polystokes_tpu_torch.config import SolverParams as TParams
from polystokes_tpu_torch.parallel import sharding as tsharding
from polystokes_tpu_torch.parallel.dryrun import dryrun_multichip
from polystokes_tpu_torch.scenes.builders import honey_coil

torch.set_num_threads(1)

VEL_ATOL = 1e-6  # JAX's criterion for its sharded step against its unsharded one
# the two packages' fp64 CG trajectories part by round-off growth (ROADMAP.md
# Queue 3 watch item 3: JAX's own packed step and solve_chunked take 372 and
# 393 iterations on one system), so their converged counts at tol 1e-7 are
# held within 5 %, not JAX's +-2 between its own sharded and unsharded steps.
# On this test's solve the unsharded steps already part by 13: JAX's takes
# 493 iterations (fuse_pap=False) and its sharded step 492, the port's
# unsharded and sharded steps 480 each (2.6 %), velocities within 2.3e-9
ITER_RTOL = 0.05


def _jelly(**kw):
    """jelly_jam 16^3, tiled at tile 8, fp64, the packed path with
    CELL_ARROW (tol 1e-7, at most 800 iterations), ``kw`` over it: JAX's
    params, scene and grid, and the port's."""
    base = dict(dtype=jnp.float64, do_tile=True, tile_size=8, tile_padding=2, use_pallas=True,
                preconditioner=JPC.CELL_ARROW, bicgstab_fallback=False, tolerance=1e-7, max_iterations=800)
    jp = JParams(**{**base, **kw})
    grid, scene = jbuilders.jelly_jam(n=16, dtype=jnp.float64)
    return (jp, scene, grid), (convert.params_from_jax(jp), convert.scene_from_numpy(scene, "cpu"),
                               convert.grid_from_jax(grid))


def _mesh(n, axes=("x",)):
    return tsharding.make_mesh(["cpu"] * n, axes=axes)


def test_sharded_step_bit_equal_to_unfused():
    """The slab apply is the unfused apply, so the solve is the same: the
    step on 2 CPU slabs of honey_coil 32^3 (tiled, tile 8: 16 regions),
    stopped after 60 iterations, against the unsharded unfused step."""
    p = TParams(dtype=torch.float64, do_tile=True, tile_size=8, tile_padding=2, use_pallas=True,
                preconditioner=TPC.CELL_ARROW, bicgstab_fallback=False, tolerance=1e-9, max_iterations=60,
                keep_non_converged=True)
    grid, scene = honey_coil(n=32, dtype=torch.float64, device="cpu")
    v1, valid1, s1 = step(grid, scene, p.replace(fuse_pap=False))
    v2, valid2, s2 = tsharding.sharded_step(grid, p, _mesh(2))(scene)
    assert s2["sharded"] and not s1["sharded"] and s1["n_regions"] == 16
    assert s1["iterations"] == s2["iterations"] == 60
    assert all(torch.equal(a, b) for a, b in zip(v1, v2))
    assert all(torch.equal(a, b) for a, b in zip(valid1, valid2))


@pytest.mark.parametrize("kw", [dict(), dict(preconditioner=JPC.REGION_ARROW), dict(deflation=True),
                                dict(use_pallas=False), dict(tile_size=16)],
                         ids=["cell_arrow", "region_arrow", "deflation", "unpacked", "T16"])
def test_check_mesh_pallas_agrees_with_jax(kw):
    """The gate keeps or drops use_pallas, and warns, as JAX's does, on a
    1-D mesh of 2 and a 2 x 2 mesh."""
    (jp, _, grid), (tp, _, tgrid) = _jelly(**kw)
    for n, axes in ((2, ("x",)), (4, ("x", "y"))):
        jm, tm = jsharding.make_mesh(jax.devices()[:n], axes=axes), _mesh(n, axes)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            want = jsharding.check_mesh_pallas(jp, jm, grid=grid).use_pallas
            got = tsharding.check_mesh_pallas(tp, tm, grid=tgrid).use_pallas
        assert got == want, (n, axes)
        assert [str(wi.message) for wi in w[1:]] == [str(wi.message) for wi in w[:1]] * (len(w) - 1)


def test_sharded_step_matches_jax():
    """Against JAX's sharded_step on 2 virtual devices at tol 1e-7, on
    jelly_jam 16^3's uniform solve (tiled at tile 8 the grid holds no
    region, so the reduced step is this operator, and JAX compiles the
    uniform step in half the time): both converged, velocities within 1e-6
    (JAX's criterion) and iterations within ITER_RTOL."""
    (jp, scene, grid), (tp, tscene, tgrid) = _jelly(do_reduced_regions=False)
    mesh = jsharding.make_mesh(jax.devices()[:2], axes=("x",))
    assert jsharding.pallas_shardable(grid, jp, mesh)
    vj, _, sj = jsharding.sharded_step(grid, jp, mesh)(jsharding.shard_scene(scene, mesh))
    vt, _, st = tsharding.sharded_step(tgrid, tp, _mesh(2))(tscene)
    assert st["sharded"]
    assert bool(sj["converged"]) and st["converged"]
    assert abs(int(sj["iterations"]) - st["iterations"]) <= ITER_RTOL * int(sj["iterations"])
    for a in range(3):
        np.testing.assert_allclose(vt[a].numpy(), np.asarray(vj[a]), atol=VEL_ATOL)


# the gated solves, each a short solve (keep_non_converged, 40 iterations):
# a 2 x 2 mesh, and REGION_ARROW on a 1-D mesh
GATES = {"mesh-2x2": (dict(), ("x", "y")), "region_arrow": (dict(preconditioner=JPC.REGION_ARROW), ("x",))}


@pytest.mark.parametrize("gate", list(GATES))
def test_gate_warns_and_runs_unsharded(gate):
    """check_mesh_pallas's warning, use_pallas dropped: the unpacked step
    on the first device, bit-equal to step with use_pallas=False."""
    kw, axes = GATES[gate]
    _, (tp, tscene, tgrid) = _jelly(tolerance=1e-5, max_iterations=40, **kw)
    mesh = _mesh(4 if len(axes) == 2 else 2, axes)
    assert not tsharding.pallas_shardable(tgrid, tp, mesh)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        gated = tsharding.check_mesh_pallas(tp, mesh, grid=tgrid)
        v1, _, s1 = tsharding.sharded_step(tgrid, tp, mesh)(tscene)
    assert not gated.use_pallas
    assert sum("shard_map" in str(wi.message) for wi in w) == 2
    v2, _, s2 = step(tgrid, tscene, gated)
    assert s1["sharded"] is False and s1["iterations"] == s2["iterations"]
    assert all(torch.equal(a, b) for a, b in zip(v1, v2))


def test_solve_chunked_on_mesh():
    """solve_chunked on 2 CPU slabs, in segments of 16 iterations, is the
    unsharded unfused step (a 48-iteration solve, kept unconverged)."""
    _, (tp, tscene, tgrid) = _jelly(tolerance=1e-9, max_iterations=48, fuse_pap=False)
    v1, _, s1 = solve_chunked(tgrid, tscene, tp, segment_iters=16, mesh=_mesh(2))
    v2, _, s2 = step(tgrid, tscene, tp)
    assert s1["sharded"] and not s2["sharded"]
    assert s1["iterations"] == s2["iterations"] == 48
    assert all(torch.equal(a, b) for a, b in zip(v1, v2))


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_like_jax(n):
    """The near-square 2-D factoring and the 1-D mesh, as JAX's make_mesh."""
    devices = jax.devices()[:n]
    for axes in (("x", "y"), ("x",)):
        jm, tm = jsharding.make_mesh(devices, axes=axes), _mesh(n, axes)
        assert tm.shape == dict(jm.shape) and tm.size == jm.size == n
        assert tsharding._data_axes(tm) == jsharding._data_axes(jm)


def test_slab_graph_only_on_one_device():
    """PCGLoop's graph: left to the loop (None) without a mesh and where
    every slab shares the vectors' device; eager (False) across devices."""
    assert tsolver._slab_graph(None, "x") is None
    assert tsolver._slab_graph(_mesh(4), "x") is None
    assert tsolver._slab_graph(tsharding.make_mesh(["cuda:0"] * 2, axes=("x",)), "x") is None
    assert tsolver._slab_graph(tsharding.make_mesh(["cuda:0", "cuda:1"], axes=("x",)), "x") is False


def test_shard_scene_moves_to_first_device():
    """Every tensor of the scene lands on the mesh's first device."""
    _, (_, tscene, _) = _jelly()
    mesh = tsharding.Mesh((torch.device("cpu"),) * 2, ("x",), (2,))
    moved = tsharding.shard_scene(tscene, mesh)
    assert moved.velocity[0].device == mesh.devices[0] and torch.equal(moved.surface_sdf, tscene.surface_sdf)


def test_dryrun_multichip_cpu():
    """JAX's dry run on 8 CPU copies: a 2 x 4 mesh, so the step is gated
    (warned) and runs unsharded, and makes progress."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stats = dryrun_multichip(8, "cpu")
    assert stats["iterations"] > 0 and stats["sharded"] is False
