"""The port's unpacked apply (``use_pallas=False``, JAX's default) against
the JAX package's XLA apply, in fp64 on the CPU.

Two scenes made with numpy from a seed, each on a tilted solid floor that
cuts faces of every family, liquid inside the domain box: CUBE, 16^3
(tiled at tile 8: 8 regions), and SPLIT, 24x16x16 with a solid wall
across x that leaves two liquid bodies (2 regions untiled, with or
without cube regions, and tiled without padding slabs).  The JAX side of
each configuration is built once per file.  Checked:

* ``make_apply`` on one x, tiled T8, untiled cube regions, general
  regions, tiled ``tile_padding=0`` and uniform, within APPLY_RTOL;
* the segmented setup (``cube_regions=False``): classification equal, the
  region data and the J couplings within SETUP_RTOL;
* ``precond.make_preconditioner`` for IDENTITY, DIAGONAL, CELL_ARROW and
  REGION_ARROW on general and tiled regions, within APPLY_RTOL;
* ``step`` on general regions, both stopped after STEP_ITERS iterations.

Four tests, no more: ``--dist loadfile`` hands out the files with the
most tests first, and a file of at most four runs beside the long tail of
``test_domain_crop.py``.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from polystokes_tpu import solver as jsolver
from polystokes_tpu.classify import effective_max_regions as jR
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.grid import Grid as JGrid
from polystokes_tpu.operators import PTau as JPTau
from polystokes_tpu.precond import make_preconditioner as jmake_preconditioner
from polystokes_tpu.reduced import expand_J as jexpand_J
from polystokes_tpu.reduced import reduce_J as jreduce_J
from polystokes_tpu.reduced import segment_rank1 as jsegment_rank1
from polystokes_tpu.reduced import segment_sum_vec as jsegment_sum_vec

from polystokes_tpu_torch import convert
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.classify import effective_max_regions as tR
from polystokes_tpu_torch.config import PreconditionerType
from polystokes_tpu_torch.operators import PTau
from polystokes_tpu_torch.precond import make_preconditioner as tmake_preconditioner
from polystokes_tpu_torch.reduced import expand_J as texpand_J
from polystokes_tpu_torch.reduced import reduce_J as treduce_J
from polystokes_tpu_torch.reduced import segment_rank1 as tsegment_rank1
from polystokes_tpu_torch.reduced import segment_sum_vec as tsegment_sum_vec

torch.set_num_threads(1)

APPLY_RTOL = 1e-12  # the same sums, some grouped otherwise (segmented region sums)
SETUP_RTOL = 1e-10  # batched Cholesky (port) against LU (JAX) in the region solves
STEP_ITERS = 20  # the two fp64 CG trajectories agree to round-off this far
STEP_RTOL = 1e-10  # times max |v|

# (scene, SolverParams fields) of each configuration
CONFIGS = {
    "tiled_t8": ("cube", dict(do_tile=True, tile_size=8, tile_padding=2)),
    "untiled_cube": ("split", dict(do_tile=False, tile_size=8, max_regions=64)),
    "general": ("split", dict(do_tile=False, tile_size=8, max_regions=64, cube_regions=False)),
    "tiled_pad0": ("split", dict(do_tile=True, tile_size=8, tile_padding=0)),
    "uniform": ("cube", dict(do_reduced_regions=False)),
}


def make_scene(res, wall, seed=0):
    """(JAX grid, JAX scene): liquid in a box 0.07 (0.1 with the wall) in
    from the domain's faces, a tilted solid floor and, with ``wall``, a
    solid slab of half-width ``wall`` across the middle of x; random face
    velocities and a random viscosity in [5, 6)."""
    from polystokes_tpu.solver import Scene as JScene

    rng = np.random.default_rng(seed)
    dx = 1.0 / max(res)
    ext = [n * dx for n in res]
    X, Y, Z = np.meshgrid(*[(np.arange(n) + 0.5) * dx for n in res], indexing="ij")
    inset = 0.1 if wall else 0.07
    surface = np.maximum.reduce([np.abs(c - e / 2) - (e / 2 - inset) for c, e in zip((X, Y, Z), ext)])
    normal = np.array([0.15, 0.1, 1.0]) / np.linalg.norm([0.15, 0.1, 1.0])
    solid = normal[0] * X + normal[1] * Y + normal[2] * Z - 0.2
    if wall:
        solid = np.minimum(solid, np.abs(X - ext[0] / 2) - wall)
    faces = [tuple(res[i] + (i == a) for i in range(3)) for a in range(3)]
    scene = JScene(
        surface_sdf=jnp.asarray(surface), collision_sdf=jnp.asarray(solid),
        velocity=tuple(jnp.asarray(rng.standard_normal(s)) for s in faces),
        collision_velocity=tuple(jnp.asarray(0.1 * rng.standard_normal(s)) for s in faces),
        viscosity=jnp.asarray(5.0 + rng.random(res)), dt=jnp.asarray(0.04),
    )
    return JGrid(res=tuple(res), dx=dx), scene


_SCENES = {}
_JAX = {}


def _scene(name):
    if name not in _SCENES:
        _SCENES[name] = make_scene((16, 16, 16), 0.03) if name == "cube" else make_scene((24, 16, 16), 0.04)
    return _SCENES[name]


def _jparams(config, **kw):
    return JParams(dtype=jnp.float64, **{**CONFIGS[config][1], **kw})


def _jax_setup(config):
    """The JAX side's (grid, scene, params, R, cls, asm), built once (jitted:
    op by op it takes 2-4x longer here)."""
    if config not in _JAX:
        grid, scene = _scene(CONFIGS[config][0])
        params = _jparams(config)
        cls, asm = jsolver._setup_jit(grid, scene, params)
        _JAX[config] = (grid, scene, params, jR(grid, params), cls, asm)
    return _JAX[config]


def _jax_apply(config, x):
    grid, _, params, R, cls, asm = _jax_setup(config)
    return jax.jit(lambda c, a, v: jsolver.make_apply(grid, c, a, params, R)(v))(cls, asm, x)


def _port_setup(config, **kw):
    grid, scene, params = _jax_setup(config)[:3]
    tp = convert.params_from_jax(params.replace(**kw))
    tg, ts = convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu")
    cls, asm = tsolver._setup(tg, ts, tp)
    return tg, ts, tp, tR(tg, tp), cls, asm


def _rand_ptau(grid, seed=1):
    rng = np.random.default_rng(seed)
    fields = [rng.standard_normal(grid.center_shape) for _ in range(4)]
    fields += [rng.standard_normal(grid.edge_shape(e)) for e in range(3)]
    return fields


def _jptau(f):
    return JPTau(p=jnp.asarray(f[0]), tc=tuple(jnp.asarray(t) for t in f[1:4]), te=tuple(jnp.asarray(t) for t in f[4:]))


def _tptau(f):
    return PTau(p=torch.from_numpy(f[0]), tc=tuple(torch.from_numpy(t) for t in f[1:4]),
                te=tuple(torch.from_numpy(t) for t in f[4:]))


def _fields(x):
    if isinstance(x, PTau):
        return [t.numpy() for t in x.fields()]
    return [np.asarray(t) for t in (x.p,) + tuple(x.tc) + tuple(x.te)]


def _rel(port, ref):
    """max |port - ref| over max |ref|, over lists of arrays."""
    port, ref = [np.asarray(a, np.float64) for a in port], [np.asarray(a, np.float64) for a in ref]
    assert [a.shape for a in port] == [a.shape for a in ref]
    scale = max(float(np.abs(a).max()) for a in ref)
    return max(float(np.abs(a - b).max()) for a, b in zip(port, ref)) / scale


def test_unpacked_apply_matches_jax():
    """make_apply on one x in each configuration: the port's unpacked
    apply (no packed kernel: ``_use_packed`` is false) within APPLY_RTOL
    of JAX's XLA apply, with equal region counts and solid-cut faces."""
    for config, (scene_name, _) in CONFIGS.items():
        grid, _, params, R, cls, asm = _jax_setup(config)
        tg, _, tp, tR_, tcls, tasm = _port_setup(config)
        assert not tp.use_pallas and not tsolver._use_packed(tg, tp) and tR_ == R
        assert int(tcls.n_regions) == int(cls.n_regions), config
        if tp.do_reduced_regions:
            assert int(tcls.n_regions) >= 2, config
        assert sum(int(((a > 0) & (a < 1)).sum()) for a in tasm.ffw) > 0, config  # solid-cut faces
        x = _rand_ptau(grid)
        ref = _fields(_jax_apply(config, _jptau(x)))
        got = _fields(tsolver.make_apply(tg, tcls, tasm, tp, R)(_tptau(x)))
        err = _rel(got, ref)
        assert err <= APPLY_RTOL, (config, err)


def test_general_setup_matches_jax():
    """The segmented setup of general regions (cube_regions=False) and of
    tiles without padding: the classification equal (labels, region ids,
    region_of_cube = [-1] untiled), the region data and reduce_J / expand_J
    within SETUP_RTOL; segment_sum_vec and segment_rank1 against JAX's on
    200 000 random samples in two segments (three levels of blocks)."""
    rng = np.random.default_rng(2)
    ids = rng.integers(-1, 2, size=200_000)
    vals, c2, w = rng.standard_normal((3, 200_000)), rng.standard_normal((3, 200_000)), rng.random(200_000)
    got = tsegment_sum_vec(torch.from_numpy(vals), torch.from_numpy(ids), 2)
    assert _rel([got], [jsegment_sum_vec(jnp.asarray(vals), jnp.asarray(ids), 2)]) <= APPLY_RTOL
    got = tsegment_rank1(*(torch.from_numpy(a) for a in (vals, c2, w, ids)), 2)
    assert _rel([got], [jsegment_rank1(*(jnp.asarray(a) for a in (vals, c2, w, ids)), 2)]) <= APPLY_RTOL
    for config in ("general", "tiled_pad0"):
        grid, _, params, R, cls, asm = _jax_setup(config)
        tg, _, tp, _, tcls, tasm = _port_setup(config)
        for name in ("cell_labels", "cell_region", "region_valid", "region_of_cube", "n_regions"):
            assert np.array_equal(np.asarray(getattr(cls, name)), getattr(tcls, name).numpy()), (config, name)
        for name in ("face_labels", "face_region", "edge_labels", "edge_region"):
            for j, t in zip(getattr(cls, name), getattr(tcls, name)):
                assert np.array_equal(np.asarray(j), t.numpy()), (config, name)
        if config == "general":
            assert tcls.region_of_cube.tolist() == [-1]
        for name in ("com", "mr", "vr", "best_fit", "binv", "b_w"):
            err = _rel([getattr(tasm, name)], [getattr(asm, name)])
            assert err <= SETUP_RTOL, (config, name, err)
        rng = np.random.default_rng(3)
        s = [rng.standard_normal(grid.face_shape(a)) for a in range(3)]
        y_ref = jax.jit(lambda c, com, v: jreduce_J(grid, c, com, v, params, R))(cls, asm.com,
                                                                                 [jnp.asarray(t) for t in s])
        y_got = treduce_J(tg, tcls, tasm.com, [torch.from_numpy(t) for t in s], tp, R)
        assert _rel([y_got], [y_ref]) <= SETUP_RTOL, config
        w = rng.standard_normal((R, tp.reduced_dof))
        u_ref = jax.jit(lambda c, com, v: jexpand_J(grid, c, com, v, params))(cls, asm.com, jnp.asarray(w))
        u_got = texpand_J(tg, tcls, tasm.com, torch.from_numpy(w), tp)
        assert _rel(u_got, u_ref) <= SETUP_RTOL, config


def test_preconditioners_match_jax():
    """make_preconditioner on PTau for each kind, on general regions (the
    segmented quadratic form) and tiled ones (the cube-major one):
    IDENTITY is None in both, the others within APPLY_RTOL."""
    for config in ("general", "tiled_t8"):
        grid, _, params, R, cls, asm = _jax_setup(config)
        tg, _, tp, _, tcls, tasm = _port_setup(config)
        r = _rand_ptau(grid, seed=4)
        for kind in ("IDENTITY", "DIAGONAL", "CELL_ARROW", "REGION_ARROW"):
            jp, pp = params.replace(preconditioner=JPC[kind]), tp.replace(preconditioner=PreconditionerType[kind])
            mt = tmake_preconditioner(tg, tcls, tasm, pp)
            if kind == "IDENTITY":
                assert jmake_preconditioner(grid, cls, asm, jp) is None and mt is None
                continue
            ref = jax.jit(lambda c, a, v, jp=jp: jmake_preconditioner(grid, c, a, jp)(v))(cls, asm, _jptau(r))
            err = _rel(_fields(mt(_tptau(r))), _fields(ref))
            assert err <= APPLY_RTOL, (config, kind, err)


def test_unpacked_step_matches_jax():
    """step on general regions with CELL_ARROW, both packages stopped
    after STEP_ITERS iterations without the fallback: equal counts and
    iterations, velocities within STEP_RTOL of max |v| (converged fp64
    solves part by round-off growth; ROADMAP Queue 3 watch item 3)."""
    from polystokes_tpu import step as jstep

    grid, scene, params = _jax_setup("general")[:3]
    jp = params.replace(preconditioner=JPC.CELL_ARROW, max_iterations=STEP_ITERS, tolerance=1e-12,
                        bicgstab_fallback=False)
    vj, _, sj = jstep(grid, scene, jp)
    vt, _, st = tsolver.step(convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"),
                             convert.params_from_jax(jp))
    assert st["iterations"] == int(sj["iterations"]) == STEP_ITERS and not st["converged"]
    for key in ("n_regions", "n_pressures", "n_active_velocities", "n_stresses", "boundary_active"):
        assert st[key] == int(sj[key]), key
    assert st["operator_applies"] == STEP_ITERS + 1 and st["n_regions"] >= 2
    assert _rel([v.numpy() for v in vt], vj) <= STEP_RTOL
    assert abs(st["error"] - float(sj["error"])) <= 1e-8 * float(sj["error"])
