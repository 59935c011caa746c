"""The port's frame-loop advection (``polystokes_tpu_torch.sim``) against the
JAX package's ``polystokes_tpu.sim``, in fp64 on the CPU.

n = 12, fields and velocities from a numpy seed, non-zero on every face of
the box so the edge clamps show: ``advect_field`` (the windowed form of
the JAX frame loop, substeps 1 and 3) and ``advect_field_gather`` (the
exact RK2 backtrace) at the cell centres and each face family, on a
constant, a smooth and a random velocity, within ADVECT_RTOL of max
|field|; ``_trilinear`` at positions inside and outside the box;
``velocity_at_lattice`` for every family; ``cfl_substeps`` equal, at an
exact multiple of ``max_disp`` too; and the port's windowed form against
its own gather form (the counterpart of
``tests/test_sim.py::test_window_advect_matches_gather``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from polystokes_tpu import sim as jsim
from polystokes_tpu.grid import face_offsets as jface_offsets

from polystokes_tpu_torch import sim as tsim
from polystokes_tpu_torch.grid import face_offsets

torch.set_num_threads(1)

N = 12
DT_OVER_DX = 1.3
ADVECT_RTOL = 1e-12  # fp64: the same interpolation, sums nested in the same order
LATTICE_RTOL = 1e-14  # halves and sums of two values
# one compilation per family and shape: the substep count is a traced trip count
_jadvect = jax.jit(jsim.advect_field, static_argnames=("offsets", "max_disp"))
_jgather = jax.jit(jsim.advect_field_gather, static_argnames=("offsets",))
OFFSETS = {"centre": (0.0, 0.0, 0.0), "face0": face_offsets(0), "face1": face_offsets(1), "face2": face_offsets(2)}


def _face_shape(a, n=N):
    return tuple(n + (b == a) for b in range(3))


def _velocity(kind):
    """Face arrays (numpy, fp64): constant, smooth in x, or random."""
    rng = np.random.default_rng(7)
    if kind == "constant":
        return tuple(np.full(_face_shape(a), 0.7 - 0.3 * a) for a in range(3))
    if kind == "smooth":
        out = []
        for a in range(3):
            xs = np.linspace(0.0, 1.0, N + (a == 0))
            out.append(np.broadcast_to((0.5 - 0.1 * a) * np.sin(2 * np.pi * xs)[:, None, None],
                                       _face_shape(a)).copy())
        return tuple(out)
    return tuple(0.9 * rng.standard_normal(_face_shape(a)) for a in range(3))


def _field(offset_name):
    rng = np.random.default_rng(11)
    shape = (N, N, N) if offset_name == "centre" else _face_shape(int(offset_name[-1]))
    return rng.standard_normal(shape) + 2.0  # non-zero everywhere, the box's faces included


def _port(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _assert_close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rtol * np.abs(ref).max())


VELOCITIES = pytest.mark.parametrize("kind", ["constant", "smooth", "random"])
FAMILIES = pytest.mark.parametrize("family", list(OFFSETS))


@VELOCITIES
@FAMILIES
@pytest.mark.parametrize("substeps", [1, 3])
def test_advect_field_matches_jax(kind, family, substeps):
    vel, fld = _velocity(kind), _field(family)
    joff = (0.0, 0.0, 0.0) if family == "centre" else jface_offsets(int(family[-1]))
    ref = _jadvect(jnp.asarray(fld), _jax(vel), jnp.asarray(DT_OVER_DX), joff, substeps=substeps)
    got = tsim.advect_field(torch.from_numpy(fld), _port(vel), torch.tensor(DT_OVER_DX, dtype=torch.float64),
                            OFFSETS[family], substeps=substeps)
    _assert_close(got, ref, ADVECT_RTOL)


@VELOCITIES
@FAMILIES
def test_advect_field_gather_matches_jax(kind, family):
    vel, fld = _velocity(kind), _field(family)
    joff = (0.0, 0.0, 0.0) if family == "centre" else jface_offsets(int(family[-1]))
    ref = _jgather(jnp.asarray(fld), _jax(vel), jnp.asarray(DT_OVER_DX), joff)
    got = tsim.advect_field_gather(torch.from_numpy(fld), _port(vel), DT_OVER_DX, OFFSETS[family])
    _assert_close(got, ref, ADVECT_RTOL)


def test_trilinear_matches_jax_inside_and_outside_the_box():
    rng = np.random.default_rng(5)
    fld = _field("centre")
    pos = [rng.uniform(-2.5, N + 1.5, size=(6, 7, 8)) for _ in range(3)]
    pos[0][0, 0, 0], pos[1][0, 0, 0], pos[2][0, 0, 0] = N - 1.0, 0.0, N - 1.0  # on the box's corner
    ref = jsim._trilinear(jnp.asarray(fld), *(jnp.asarray(p) for p in pos))
    got = tsim._trilinear(torch.from_numpy(fld), *(torch.from_numpy(p) for p in pos))
    _assert_close(got, ref, ADVECT_RTOL)


@pytest.mark.parametrize("a", [None, 0, 1, 2])
def test_velocity_at_lattice_matches_jax(a):
    vel = _velocity("random")
    ref = jsim.velocity_at_lattice(_jax(vel), a)
    got = tsim.velocity_at_lattice(_port(vel), a)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        _assert_close(g, r, LATTICE_RTOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("scale, dt_over_dx", [(0.9, 1.3), (0.3, 0.9), (2.0, 1.0), (5.0, 2.0), (0.0, 1.0)])
def test_cfl_substeps_equal(dtype, scale, dt_over_dx):
    """(2.0, 1.0): max |u| dt/dx is exactly max_disp, 1 substep in both."""
    vel = tuple((scale * np.sign(v) * np.minimum(np.abs(v), 1.0)).astype(dtype) for v in _velocity("random"))
    vel[2][0, 0, 0] = dtype(-scale)  # max |u| is exactly scale in this dtype
    want = jsim.cfl_substeps(_jax(vel), dt_over_dx)
    assert tsim.cfl_substeps(_port(vel), dt_over_dx) == want
    assert tsim.cfl_substeps(_port(vel), torch.tensor(dt_over_dx)) == want


def test_window_advect_matches_gather():
    """The port's windowed advection equals its gather path when the
    backtrace stays within the window: to round-off under a constant
    velocity (the same positions, the same hat weights), closely under a
    smooth one (the midpoint velocity's lattice resampling differs)."""
    surf = torch.from_numpy(_field("centre"))
    vel_c = _port(_velocity("constant"))
    for offsets in [(0.0, 0.0, 0.0), face_offsets(0)]:
        fld = surf if offsets == (0.0, 0.0, 0.0) else vel_c[0]
        a = tsim.advect_field_gather(fld, vel_c, DT_OVER_DX, offsets)
        b = tsim.advect_field(fld, vel_c, DT_OVER_DX, offsets)
        assert float((a - b).abs().max()) <= 1e-12

    vel_s = _port(_velocity("smooth"))
    assert tsim.cfl_substeps(vel_s, 1.0) == 1  # max |u| 0.5 < max_disp
    a = tsim.advect_field_gather(surf, vel_s, 1.0, (0.0, 0.0, 0.0))
    b = tsim.advect_field(surf, vel_s, 1.0, (0.0, 0.0, 0.0))
    assert float((a - b).abs().max()) < 0.08 * float(surf.abs().max())
    c = tsim.advect_field(surf, vel_s, 1.0, (0.0, 0.0, 0.0), substeps=3)
    assert bool(torch.isfinite(c).all())
