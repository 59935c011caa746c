"""The port's solve-domain cropping (``polystokes_tpu_torch.domain``)
against ``polystokes_tpu.domain``, and its cropped solve against its own
full one.

* The crop helpers against JAX's on the same inputs, made with numpy from
  a seed: a liquid sphere near one corner of a 32^3 box (with a density
  field and input face weights, so that ``crop_scene`` slices them too), a
  dry scene and a flooded one (no crop).  ``_align_for``, ``active_bbox``
  (the default margin and the tight box of a pinned crop),
  ``crop_scene``, ``embed_face`` and ``bbox_contains`` agree exactly.  No
  JAX solve.
* The port's ``solve_cropped`` against the port's ``solve_chunked`` on the
  full grid, fp64, tiled, tile 8, CELL_ARROW, tol 1e-8, under JAX's own
  criteria (tests/test_domain_crop.py): equal DOF and region counts,
  velocities within INSIDE_ATOL of max inside the crop, the input
  velocity exactly and ``valid`` False outside it.  (At 32^3 a box that
  saves volume is at most 16 cells wide on a cropped axis, too narrow for
  a padded tile-8 region, so both solves have none.)
* The crop choice of ``solve_cropped``: a pinned box that no longer holds
  the liquid is replaced by the scene's own, one that holds it is kept,
  and a flooded scene falls back to the full-grid solve.
"""
import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from polystokes_tpu import domain as jdomain
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.grid import Grid as JGrid
from polystokes_tpu.solver import Scene as JScene

from polystokes_tpu_torch import convert, domain, solve_chunked
from polystokes_tpu_torch.config import PreconditionerType, SolverParams
from polystokes_tpu_torch.grid import Grid

torch.set_num_threads(1)

N = 32
# the sphere's cells span 20-26, 4-10 and 20-26: the crop is [16, 32) x
# [0, 16) x [16, 32), an eighth of the box
CENTER, RADIUS = (0.72, 0.22, 0.72), 0.1
INSIDE_ATOL = 5e-6  # times max |v|: tests/test_domain_crop.py's bound (CG dot reassociation only)


def _arrays(seed=3, liquid="sphere"):
    """numpy fields of the scene: SDFs, viscosity, velocities, collision
    velocities, density and input face weights."""
    rng = np.random.default_rng(seed)
    idx = np.indices((N, N, N)) / N
    if liquid == "sphere":
        surf = np.sqrt(sum((idx[a] - CENTER[a]) ** 2 for a in range(3))) - RADIUS
    else:
        surf = np.full((N, N, N), 1.0 if liquid == "dry" else -1.0)
    faces = [tuple(N + (a == b) for b in range(3)) for a in range(3)]
    return dict(
        surface_sdf=surf, collision_sdf=np.full((N, N, N), 1.0), viscosity=np.full((N, N, N), 8.0), dt=np.asarray(1 / 24),
        velocity=tuple(rng.standard_normal(s) for s in faces), collision_velocity=tuple(np.zeros(s) for s in faces),
        density=np.full((N, N, N), 1000.0), surface_weights=tuple(rng.uniform(0.0, 1.0, s) for s in faces),
        collision_weights=tuple(rng.uniform(0.0, 1.0, s) for s in faces),
    )


def _scenes(liquid="sphere", extras=True):
    """(JAX scene, port scene on the CPU) of the same arrays."""
    d = _arrays(liquid=liquid)
    if not extras:
        d.update(density=None, surface_weights=None, collision_weights=None)
    js = JScene(**{k: None if v is None else (tuple(jnp.asarray(t) for t in v) if isinstance(v, tuple) else jnp.asarray(v))
                   for k, v in d.items()})
    return js, convert.scene_from_numpy(js, "cpu")


def _params(**kw):
    return SolverParams(**{**dict(dtype=torch.float64, do_tile=True, tile_size=8, tile_padding=2, tolerance=1e-8,
                                  max_iterations=4000, bicgstab_fallback=False,
                                  preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True), **kw})


def _jparams(**kw):
    return JParams(**{**dict(dtype=jnp.float64, do_tile=True, tile_size=8, tile_padding=2, bicgstab_fallback=False),
                      **kw})


def _same(t, a):
    return t.dtype == torch.float64 and np.array_equal(t.numpy(), np.asarray(a))


def test_crop_helpers_match_jax():
    for kw in ({}, dict(tile_size=32), dict(do_reduced_regions=False), dict(do_tile=False)):
        assert domain._align_for(_params(**kw)) == jdomain._align_for(_jparams(**kw)), kw
    boxes = {}
    for liquid in ("sphere", "dry", "flooded"):
        js, ts = _scenes(liquid)
        for margin, saving in ((4, 0.10), (2, 0.0)):
            got = domain.active_bbox(ts, _params(), margin=margin, min_saving=saving)
            assert got == jdomain.active_bbox(js, _jparams(), margin=margin, min_saving=saving), (liquid, margin)
            boxes[liquid, margin] = got
    assert boxes["sphere", 4] == ((16, 0, 16), (32, 16, 32))
    assert boxes["dry", 4] is boxes["flooded", 4] is None and boxes["flooded", 2] == ((0, 0, 0), (N, N, N))

    js, ts = _scenes("sphere")
    lo, hi = boxes["sphere", 4]
    jgrid_c, jscene_c = jdomain.crop_scene(JGrid(res=(N, N, N), dx=1.0 / N), js, lo, hi)
    grid_c, scene_c = domain.crop_scene(Grid(res=(N, N, N), dx=1.0 / N), ts, lo, hi)
    assert grid_c == convert.grid_from_jax(jgrid_c) and grid_c.res == (16, 16, 16)
    for f in dataclasses.fields(scene_c):
        got, want = getattr(scene_c, f.name), getattr(jscene_c, f.name)
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        assert all(_same(g, w) for g, w in pairs), f.name

    for a in range(3):
        sub = scene_c.velocity[a] * 2.0 + 1.0
        want = jdomain.embed_face(js.velocity[a], jnp.asarray(sub.numpy()), a, lo)
        got = domain.embed_face(ts.velocity[a], sub, a, lo)
        assert _same(got, want) and not torch.equal(got, ts.velocity[a]), a

    pairs = [(boxes["sphere", 4], boxes["sphere", 2]), (((0, 0, 0), (16, 16, 16)), boxes["sphere", 2]),
             (boxes["flooded", 2], boxes["sphere", 4]), (((16, 0, 16), (32, 16, 24)), boxes["sphere", 2])]
    assert [domain.bbox_contains(o, i) for o, i in pairs] == [jdomain.bbox_contains(o, i) for o, i in pairs]
    assert [domain.bbox_contains(o, i) for o, i in pairs] == [True, False, True, False]


def test_cropped_solve_matches_full():
    _, scene = _scenes("sphere", extras=False)
    grid, p = Grid(res=(N, N, N), dx=1.0 / N), _params()
    vel_f, valid_f, st_f = solve_chunked(grid, scene, p, segment_iters=500)
    vel_c, valid_c, st_c = domain.solve_cropped(grid, scene, p, segment_iters=500)
    assert st_f["converged"] and st_c["converged"]
    assert st_c["crop"] == {"lo": (16, 0, 16), "hi": (32, 16, 32), "res": (16, 16, 16)}
    for key in ("n_pressures", "n_active_velocities", "n_stresses", "n_regions"):
        assert st_c[key] == st_f[key], key
    lo, hi = st_c["crop"]["lo"], st_c["crop"]["hi"]
    for a in range(3):
        vf, vc = vel_f[a].numpy(), vel_c[a].numpy()
        sl = tuple(slice(lo[i], hi[i] + (1 if i == a else 0)) for i in range(3))
        np.testing.assert_allclose(vc[sl], vf[sl], rtol=0, atol=INSIDE_ATOL * np.abs(vf).max())
        outside = np.ones(vf.shape, bool)
        outside[sl] = False
        np.testing.assert_array_equal(vc[outside], scene.velocity[a].numpy()[outside])
        assert not valid_c[a].numpy()[outside].any()
        np.testing.assert_array_equal(valid_c[a].numpy()[~outside], valid_f[a].numpy()[~outside])


def test_solve_cropped_picks_its_box(monkeypatch):
    """The solve replaced by a stub that records its grid: which box each
    call solves on."""
    calls = []

    def fake_solve_chunked(grid, scene, params, **kw):
        calls.append(grid.res)
        zeros = tuple(torch.zeros(grid.face_shape(a), dtype=torch.float64) for a in range(3))
        return zeros, tuple(z > 0 for z in zeros), {"iterations": 0}

    monkeypatch.setattr(domain, "solve_chunked", fake_solve_chunked)
    grid = Grid(res=(N, N, N), dx=1.0 / N)
    _, scene = _scenes("sphere", extras=False)
    own = ((16, 0, 16), (32, 16, 32))
    stale = ((0, 0, 0), (16, 16, 16))
    wide = ((0, 0, 16), (32, 32, 32))  # holds the liquid: kept, though larger than its own box
    got = [domain.solve_cropped(grid, scene, _params(), bbox=box)[2]["crop"] for box in (None, stale, wide)]
    assert [(c["lo"], c["hi"]) for c in got] == [own, own, wide]
    assert calls == [(16, 16, 16), (16, 16, 16), (32, 32, 16)]
    _, flooded = _scenes("flooded", extras=False)
    assert "crop" not in domain.solve_cropped(grid, flooded, _params())[2] and calls[-1] == (N, N, N)

