"""The x-slab apply of ``polystokes_tpu_torch.parallel.shard_apply`` against
the JAX package, in fp64 on the CPU (8 virtual JAX devices, conftest.py).

The halo twins of kernels 1, 3 and 7 (``halo=HALO_X``) against the Pallas
kernels in interpret mode on the same exchanged slab (JAX's
``moments_packed`` on it, ``apply_reduced_packed(up_prepadded=True)``,
``apply_uniform_packed(prepadded=True)``); the port's sharded apply on 2
and 4 CPU slabs bit-equal to its unsharded apply on every packed mode;
the sharded apply against JAX's ``make_apply_packed_sharded`` on 2
virtual devices; ``shardable`` and ``pallas_shardable`` against JAX's on a
table of resolutions, slab counts, meshes and params.
"""
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from polystokes_tpu import pallas_apply as jpa
from polystokes_tpu import solver as jsolver
from polystokes_tpu.config import BasisOrder as JB
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.grid import Grid as JGrid
from polystokes_tpu.parallel import shard_apply as jshard
from polystokes_tpu.parallel import sharding as jsharding
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import convert
from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.classify import effective_max_regions
from polystokes_tpu_torch.config import BasisOrder as TB
from polystokes_tpu_torch.config import PreconditionerType as TPC
from polystokes_tpu_torch.config import SolverParams as TParams
from polystokes_tpu_torch.grid import Grid as TGrid
from polystokes_tpu_torch.parallel import shard_apply as tshard
from polystokes_tpu_torch.parallel import sharding as tsharding
from polystokes_tpu_torch.scenes.builders import honey_coil

from test_torch_packed_apply import _rel

torch.set_num_threads(1)

KERNEL_RTOL = 1e-11  # fp64; only the order of the sums differs
H = tpa.HALO_X


def _jax_slab(a, i, n):
    """Slab i of n of a [C, nx, ny, nz] array as JAX's exchange leaves it:
    HALO_X neighbour planes (zeros at the ends) on x, HALO_Y zeros on y."""
    nxl = a.shape[1] // n
    padded = np.pad(a, [(0, 0), (H, H), (0, 0), (0, 0)])[:, i * nxl:(i + 1) * nxl + 2 * H]
    return jnp.asarray(np.pad(padded, [(0, 0), (0, 0), (jpa.HALO_Y, jpa.HALO_Y), (0, 0)]))


def _port_slab(a, i, n):
    """The same slab for the port's halo forms: no y padding."""
    nxl = a.shape[1] // n
    padded = np.pad(a, [(0, 0), (H, H), (0, 0), (0, 0)])[:, i * nxl:(i + 1) * nxl + 2 * H]
    return torch.from_numpy(np.ascontiguousarray(padded))


# (kernel, basis): the halo forms of kernels 1 (K = 10 and 4), 3 and 7
HALO_CASES = [("moments", "QUADRATIC"), ("moments", "AFFINE"), ("apply_reduced", None), ("apply_uniform", None)]


@pytest.fixture(scope="module")
def kernel_case():
    """The port's untiled honey_coil 24^3 setup at tile 8 (fp64): its
    17-channel stack, and x and u made with numpy from a seed, masked as
    the solver's are; both packages' kernels read the same arrays."""
    p = TParams(dtype=torch.float64, do_tile=False, tile_size=8, tile_padding=2, max_regions=64, use_pallas=True,
                preconditioner=TPC.CELL_ARROW)
    grid, scene = honey_coil(n=24, dtype=torch.float64, device="cpu")
    cls, asm = tsolver._setup(grid, scene, p)
    red = tsolver._region_algebra_packed(grid, cls, asm, p, effective_max_regions(grid, p))[1].numpy()
    rng = np.random.default_rng(7)
    return dict(T=8, res=grid.res, coeffs=tpa.pack_coeffs(asm, cls).numpy(),
                x=rng.standard_normal((7,) + grid.res) * tpa.packed_masks(cls, torch.float64).numpy(),
                u=rng.standard_normal((3,) + grid.res) * red)


@pytest.mark.parametrize("kernel, basis", HALO_CASES, ids=["moments", "moments-K4", "apply_reduced", "apply_uniform"])
def test_halo_twin_matches_pallas(kernel_case, kernel, basis):
    """The middle slab of 3 of honey_coil 24^3 (tile 8), whose halos both
    come from neighbours: the port's halo twin and JAX's Pallas kernel
    (interpret mode) on the same exchanged slab."""
    case, n, slab = kernel_case, 3, 1
    T = case["T"]
    res_l = (case["res"][0] // n,) + case["res"][1:]
    x, c, u = case["x"], case["coeffs"], case["u"]
    if kernel == "moments":
        ref = jpa.moments_packed(_jax_slab(x, slab, n), _jax_slab(c, slab, n), res_l, T, JB[basis])
        got = tpa.moments_packed(_port_slab(x, slab, n), _port_slab(c, slab, n), T, TB[basis], halo=H)
    elif kernel == "apply_reduced":
        ref = jpa.apply_reduced_packed(_jax_slab(x, slab, n), _jax_slab(c, slab, n), _jax_slab(u, slab, n), res_l,
                                       up_prepadded=True)
        got = tpa.apply_reduced_packed(_port_slab(x, slab, n), _port_slab(c, slab, n), _port_slab(u, slab, n), halo=H)
    else:
        c14 = c[:tpa.N_COEFF_UNIFORM]
        ref = jpa.apply_uniform_packed(_jax_slab(x, slab, n), _jax_slab(c14, slab, n), res_l, prepadded=True)
        got = tpa.apply_uniform_packed(_port_slab(x, slab, n), _port_slab(c14, slab, n), halo=H)
    assert tuple(got.shape) == tuple(ref.shape)
    assert _rel(got, ref) <= KERNEL_RTOL


def test_halo_twin_slabs_equal_whole(kernel_case):
    """Every halo twin's slabs, joined, are the twin on the whole array bit
    for bit (their sums do not depend on the x-extent), and a single slab
    with a zero halo is the form without one."""
    case = kernel_case
    T = case["T"]
    x, c, u = (torch.from_numpy(case[k]) for k in ("x", "coeffs", "u"))
    whole = {"moments": tpa.moments_packed(x, c, T), "apply_reduced": tpa.apply_reduced_packed(x, c, u),
             "apply_uniform": tpa.apply_uniform_packed(x, c)}
    for n in (1, 3):
        slabs = [[_port_slab(case[k], i, n) for k in ("x", "coeffs", "u")] for i in range(n)]
        parts = {"moments": [tpa.moments_packed(xs, cs, T, halo=H) for xs, cs, _ in slabs],
                 "apply_reduced": [tpa.apply_reduced_packed(xs, cs, us, halo=H) for xs, cs, us in slabs],
                 "apply_uniform": [tpa.apply_uniform_packed(xs, cs, halo=H) for xs, cs, _ in slabs]}
        for name, pieces in parts.items():
            assert torch.equal(torch.cat(pieces, dim=0 if name == "moments" else 1), whole[name]), (name, n)


def test_halo_form_checks():
    """The halo forms take only HALO_X, padded shapes, and no pap form."""
    x, c = torch.zeros((7, 12, 8, 8), dtype=torch.float64), torch.zeros((17, 12, 8, 8), dtype=torch.float64)
    assert tuple(tpa.apply_uniform_packed(x, c, halo=H).shape) == (7, 8, 8, 8)
    with pytest.raises(ValueError):
        tpa.apply_uniform_packed(x, c, halo=1)
    with pytest.raises(ValueError):
        tpa.apply_uniform_packed(x, c[:, 1:], halo=H)
    with pytest.raises(ValueError):
        tpa.apply_reduced_packed(x, c, torch.zeros((3, 8, 8, 8), dtype=torch.float64), halo=H)
    with pytest.raises(ValueError):
        tpa._apply_uniform_cuda(x, c, 4, 8, 8, pap=True, halo=H)
    with pytest.raises(ValueError):
        tpa.moments_packed(x[:, :4], c[:, :4], 4, halo=H)


def test_exchange_halos():
    """Each slab gets its neighbours' edge planes, zeros at the ends: the
    slabs of the zero-padded whole array."""
    a = torch.arange(2 * 16 * 3 * 2, dtype=torch.float64).reshape(2, 16, 3, 2)
    padded = torch.nn.functional.pad(a, (0, 0, 0, 0, H, H))
    for n in (2, 4, 8):
        got = tshard.exchange_halos(tshard.split(a, [torch.device("cpu")] * n))
        nxl = 16 // n
        assert all(torch.equal(g, padded[:, i * nxl:(i + 1) * nxl + 2 * H]) for i, g in enumerate(got))


# the packed modes of the sharded apply: uniform, untiled cube regions and
# tiled, the reduced ones in both bases
MODES = {"uniform": dict(do_reduced_regions=False), "untiled": dict(do_tile=False, max_regions=64),
         "tiled": dict(do_tile=True)}
_SETUPS = {}


def _setup(mode, basis):
    key = (mode, basis)
    if key not in _SETUPS:
        p = TParams(dtype=torch.float64, tile_size=8, tile_padding=2, use_pallas=True, basis=TB[basis],
                    preconditioner=TPC.CELL_ARROW, **MODES[mode])
        grid, scene = honey_coil(n=32, dtype=torch.float64, device="cpu")
        cls, asm = tsolver._setup(grid, scene, p)
        x = torch.from_numpy(np.random.default_rng(11).standard_normal((7,) + grid.res))
        _SETUPS[key] = (grid, p, cls, asm, x)
    return _SETUPS[key]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("storage", ["f64", "bf16"])
@pytest.mark.parametrize("mode, basis", [("uniform", "QUADRATIC"), ("untiled", "QUADRATIC"), ("untiled", "AFFINE"),
                                         ("tiled", "QUADRATIC"), ("tiled", "AFFINE")],
                         ids=["uniform", "untiled", "untiled-K4", "tiled", "tiled-K4"])
def test_sharded_apply_bit_equal(mode, basis, storage, n):
    """make_apply_packed_sharded on n CPU slabs (honey_coil 32^3, tile 8) is
    make_apply_packed bit for bit, with the halo forms launched once a slab."""
    grid, p, cls, asm, x = _setup(mode, basis)
    p = p.replace(coeff_bf16=storage == "bf16")
    R = effective_max_regions(grid, p)
    mesh = tsharding.make_mesh(["cpu"] * n, axes=("x",))
    assert tshard.shardable(grid, p, n) and tsharding.pallas_shardable(grid, p, mesh)
    ref = tsolver.make_apply_packed(grid, cls, asm, p, R)(x)
    assert torch.equal(tshard.make_apply_packed_sharded(grid, cls, asm, p, R, mesh)(x), ref)


def _both(builder, n_res, **kw):
    """A scene of ``builder`` at n_res^3 (tile 8, CELL_ARROW, fp64, ``kw``
    over it) set up by both packages, a random x, and 2-device meshes of
    each."""
    jp = JParams(dtype=jnp.float64, tile_size=8, tile_padding=2, use_pallas=True, preconditioner=JPC.CELL_ARROW,
                 bicgstab_fallback=False, **kw)
    grid, scene = builder(n=n_res, dtype=jnp.float64)
    cls, asm = jax.jit(jsolver._setup, static_argnames=("grid", "params"))(grid, scene, jp)
    tgrid, tp = convert.grid_from_jax(grid), convert.params_from_jax(jp)
    tcls, tasm = tsolver._setup(tgrid, convert.scene_from_numpy(scene, "cpu"), tp)
    x = np.random.default_rng(3).standard_normal((7,) + grid.res)
    return dict(grid=grid, jp=jp, cls=cls, asm=asm, tgrid=tgrid, tp=tp, tcls=tcls, tasm=tasm, x=x,
                jmesh=JMesh(np.asarray(jax.devices()[:2]), ("x",)), tmesh=tsharding.make_mesh(["cpu"] * 2, axes=("x",)))


@pytest.fixture(scope="module")
def jelly_2():
    """jelly_jam 16^3, untiled cube regions at tile 8: one region (tiled,
    the grid holds none)."""
    return _both(jbuilders.jelly_jam, 16, do_tile=False, max_regions=64)


def _check_against_jax(c):
    """The port's sharded apply against JAX's make_apply_packed_sharded on 2
    virtual devices, each from its own setup, and against its own
    unsharded apply."""
    R = effective_max_regions(c["tgrid"], c["tp"])
    assert jsharding.pallas_shardable(c["grid"], c["jp"], c["jmesh"])
    ref = jax.jit(jshard.make_apply_packed_sharded(c["grid"], c["cls"], c["asm"], c["jp"], R, c["jmesh"]))(
        jnp.asarray(c["x"]))
    got = tshard.make_apply_packed_sharded(c["tgrid"], c["tcls"], c["tasm"], c["tp"], R, c["tmesh"])(
        torch.from_numpy(c["x"]))
    assert _rel(got, ref) <= KERNEL_RTOL
    unsharded = tsolver.make_apply_packed(c["tgrid"], c["tcls"], c["tasm"], c["tp"], R)(torch.from_numpy(c["x"]))
    assert torch.equal(got, unsharded)


def test_sharded_apply_matches_jax(jelly_2):
    """jelly_jam 16^3 untiled: one region, whose cubes lie on both slabs."""
    assert int(jelly_2["tcls"].n_regions) == 1
    _check_against_jax(jelly_2)


def test_sharded_apply_matches_jax_tiled():
    """honey_coil 32^3 tiled at tile 8: 16 regions, each cube's moments
    taken on its own slab and summed into the regions on the first
    device, the algebra's v split back by cube-x."""
    c = _both(jbuilders.honey_coil, 32)
    assert int(c["tcls"].n_regions) == int(c["cls"].n_regions) == 16
    _check_against_jax(c)


def _shard_params(kind):
    """(JAX params, port params) of one row of the legality table."""
    base = dict(dtype=jnp.float64, tile_size=8, tile_padding=2, use_pallas=True, preconditioner=JPC.CELL_ARROW)
    base.update({
        "tiled": {}, "tiled-T16": dict(tile_size=16), "untiled": dict(do_tile=False, max_regions=64),
        "uniform": dict(do_reduced_regions=False), "general": dict(do_tile=False, cube_regions=False),
        "padding0": dict(tile_padding=0), "unpacked": dict(use_pallas=False),
        "region_arrow": dict(preconditioner=JPC.REGION_ARROW), "diagonal": dict(preconditioner=JPC.DIAGONAL),
        "identity": dict(preconditioner=JPC.IDENTITY), "multigrid": dict(preconditioner=JPC.MULTIGRID),
        "deflation": dict(deflation=True)}[kind])
    jp = JParams(**base)
    return jp, convert.params_from_jax(jp)


KINDS = ["tiled", "tiled-T16", "untiled", "uniform", "general", "padding0", "unpacked", "region_arrow", "diagonal",
         "identity", "multigrid", "deflation"]
# resolutions whose y JAX's TPU block rule takes (a multiple of 8); a slab
# of x planes that are no multiple of 8 is divergence 1 (below)
RESOLUTIONS = [(32, 32, 32), (48, 32, 16), (64, 16, 32)]


@pytest.mark.parametrize("kind", KINDS)
def test_shardable_agrees_with_jax(kind):
    """shardable at 1-8 slabs and pallas_shardable on 1-D meshes of 1-8
    devices and on 2 x 2 and 2 x 4 meshes, against JAX's, at each
    resolution.  A slab whose planes are no multiple of 8 (32^3 in 8, 48
    in 4) is ROADMAP.md Queue 3 divergence 1: the uniform step takes it
    here, JAX's block rule does not."""
    jp, tp = _shard_params(kind)
    devices = jax.devices()
    for res in RESOLUTIONS:
        jg, tg = JGrid(res=res, dx=1.0 / res[0]), TGrid(res=res, dx=1.0 / res[0])
        for n in range(1, 9):
            jm = jsharding.make_mesh(devices[:n], axes=("x",))
            tm = tsharding.make_mesh(["cpu"] * n, axes=("x",))
            got = (tshard.shardable(tg, tp, n), tsharding.pallas_shardable(tg, tp, tm))
            want = (jshard.shardable(jg, jp, n), jsharding.pallas_shardable(jg, jp, jm))
            if res[0] % n == 0 and (res[0] // n) % 8:
                assert not any(want) and got == (kind == "uniform",) * 2, (res, n)
                continue
            assert got == want, (res, n)
        for n in (4, 8):
            jm, tm = jsharding.make_mesh(devices[:n]), tsharding.make_mesh(["cpu"] * n)
            assert tm.shape == dict(jm.shape)
            assert tsharding.pallas_shardable(tg, tp, tm) == jsharding.pallas_shardable(jg, jp, jm), (res, n)
