"""Tiled mode (``do_tile=True``, the JAX default) of the port against the JAX
package, in fp64 on the CPU: classification, assembly and the port's
fixed-order region sum (the step is in ``test_torch_tiled_step.py``).

Cases: honey_coil 32^3, padding 2, at tile 8 (16 regions) and tile 16 (4
regions); both packages start from the same arrays.

* ``construct_tiles`` on the same banded labels, and every
  ``Classification`` field, equal to JAX's; ``effective_max_regions``
  equal to JAX's up to 256^3 at tile 8 (65 536 slots).
* The assembled ``com``, ``binv`` and ``ffw`` at tile 16 within ASM_RTOL.
* ``RegionSum`` bit-equal to JAX's ``segment_sum`` on a tiled and an
  untiled cube map; against a dense 0/1 product on both maps, bit-equal
  across calls, and its table [R, 1] for a tiled map of 32 768 cubes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import classify as jclassify
from polystokes_tpu import solver as jsolver
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.grid import Grid as JGrid
from polystokes_tpu.scenes import builders as jbuilders
from polystokes_tpu.weights import compute_weights as jweights

from polystokes_tpu_torch import classify as tclassify
from polystokes_tpu_torch import convert
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.grid import Grid
from polystokes_tpu_torch.reduced import RegionSum
from polystokes_tpu_torch.weights import compute_weights as tweights

torch.set_num_threads(1)

N = 32
ASM_RTOL = 1e-10  # batched Cholesky (port) against LU (JAX) in the region solves
SUM_RTOL = 1e-14  # one sum per region in another order than the dense product

_CACHE = {}


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(port, ref):
    port, ref = _np(port).astype(np.float64), _np(ref).astype(np.float64)
    assert port.shape == ref.shape
    return float(np.max(np.abs(port - ref))) / float(np.max(np.abs(ref)))


def _jparams(T, **kw):
    return JParams(dtype=jnp.float64, do_tile=True, tile_size=T, tile_padding=2, preconditioner=JPC.CELL_ARROW,
                   tolerance=1e-3, max_iterations=2000, bicgstab_fallback=False, use_pallas=True, fuse_pap=True, **kw)


def _case(T):
    """Both packages' inputs, weights and classification at tile T."""
    if T not in _CACHE:
        grid, scene = jbuilders.honey_coil(n=N, dtype=jnp.float64)
        params = _jparams(T)
        lw, fw = jweights(grid, scene.surface_sdf, scene.collision_sdf, params.dtype)
        tgrid, tparams = convert.grid_from_jax(grid), convert.params_from_jax(params)
        tscene = convert.scene_from_numpy(scene, "cpu")
        tlw, tfw = tweights(tgrid, tscene.surface_sdf, tscene.collision_sdf, tparams.dtype)
        _CACHE[T] = dict(
            jax=dict(grid=grid, scene=scene, params=params, lw=lw, fw=fw, cls=jclassify.classify(grid, lw, fw, params)),
            port=dict(grid=tgrid, scene=tscene, params=tparams, lw=tlw, fw=tfw,
                      cls=tclassify.classify(tgrid, tlw, tfw, tparams)),
        )
    return _CACHE[T]


TILES = pytest.mark.parametrize("T", [8, 16], ids=["T8", "T16"])


@TILES
def test_construct_tiles_equal(T):
    """The padding slabs on the same banded labels."""
    jx = _case(T)["jax"]
    lw, p = jx["lw"], jx["params"]
    banded = jclassify.construct_solid_boundary_layer(
        jclassify.construct_air_boundary_layer(jclassify.classify_cells(lw, jx["fw"]), lw, p.liquid_boundary_layer_size),
        lw, p.solid_boundary_layer_size)
    ref = jclassify.construct_tiles(banded, T, p.tile_padding)
    got = tclassify.construct_tiles(torch.from_numpy(np.array(banded)), T, p.tile_padding)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    assert not np.array_equal(np.asarray(ref), np.asarray(banded)), "the slabs must cut the interior"


@TILES
@pytest.mark.parametrize("field", ["cell_labels", "face_labels", "edge_labels", "cell_region", "face_region",
                                   "edge_region", "region_valid", "n_regions", "region_of_cube", "region_overflow"])
def test_classification_fields_equal(T, field):
    c = _case(T)
    a_j, a_t = getattr(c["jax"]["cls"], field), getattr(c["port"]["cls"], field)
    pairs = zip(a_t, a_j) if isinstance(a_j, (tuple, list)) else [(a_t, a_j)]
    for x_t, x_j in pairs:
        np.testing.assert_array_equal(_np(x_t), np.asarray(x_j), err_msg=field)
    if field == "n_regions":
        assert int(a_t) == {8: 16, 16: 4}[T], "the case must exercise several tiled regions"


@pytest.mark.parametrize("n, T", [(32, 8), (32, 16), (128, 16), (256, 8)])
def test_effective_max_regions_equal(n, T):
    jp = _jparams(T)
    got = tclassify.effective_max_regions(Grid(res=(n,) * 3, dx=1.0 / n), convert.params_from_jax(jp))
    assert got == jclassify.effective_max_regions(JGrid(res=(n,) * 3, dx=1.0 / n), jp)
    if (n, T) == (256, 8):
        assert got == 65536


def _assembled():
    if "asm" not in _CACHE:
        c = _case(16)
        out = {}
        for side, mod in (("jax", jsolver), ("port", tsolver)):
            s = c[side]
            R = (jclassify if side == "jax" else tclassify).effective_max_regions(s["grid"], s["params"])
            out[side] = mod.assemble(s["grid"], s["scene"], s["cls"], s["lw"], s["fw"], s["params"], R)[0]
        _CACHE["asm"] = out
    return _CACHE["asm"]


@pytest.mark.parametrize("field", ["com", "binv", "ffw"])
def test_assembled_fields_equal(field):
    a = _assembled()
    a_j, a_t = getattr(a["jax"], field), getattr(a["port"], field)
    pairs = zip(a_t, a_j) if isinstance(a_j, (tuple, list)) else [(a_t, a_j)]
    for x_t, x_j in pairs:
        assert _rel(x_t, x_j) <= ASM_RTOL, field


def _dense_sum(vals, roc, R):
    """The reference: a dense [R, ncubes] 0/1 product."""
    onehot = (roc[None, :].long() == torch.arange(R)[:, None]).to(vals.dtype)
    return (onehot @ vals.reshape(vals.shape[0], -1)).reshape((R,) + tuple(vals.shape[1:]))


def _cube_map(kind, rng):
    """(region_of_cube, R): tiled, one cube per region with -1 cubes, R = 2
    ncubes; untiled, many cubes per region in 64 slots."""
    if kind == "tiled":
        nc, R = 512, 1024
        roc = rng.permutation(R)[:nc]
        roc[rng.random(nc) < 0.3] = -1
    else:
        nc, R = 512, 64
        roc = rng.integers(-1, R // 2, nc)
    return torch.from_numpy(roc.astype(np.int32)), R


@pytest.mark.parametrize("kind", ["tiled", "untiled"])
def test_region_sum_matches_dense_product(kind):
    rng = np.random.default_rng(5)
    roc, R = _cube_map(kind, rng)
    vals = torch.from_numpy(rng.standard_normal((roc.shape[0], 3, 7)) * 10.0 ** rng.integers(-3, 4, (roc.shape[0], 1, 1)))
    rsum = RegionSum(roc, R)
    ref = _dense_sum(vals, roc, R)
    got = rsum(vals)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= SUM_RTOL * float(ref.abs().max())
    counts = torch.bincount(roc[roc >= 0].long(), minlength=R)
    assert rsum.table.shape == (R, max(int(counts.max()), 1))
    if kind == "untiled":
        assert rsum.table.shape[1] > 1


@pytest.mark.parametrize("kind", ["tiled", "untiled"])
def test_region_sum_bit_equal_to_jax_segment_sum(kind):
    """On the CPU the sum folds in cube order, as JAX's segment_sum does."""
    from polystokes_tpu.reduced import _cube_scatter as jcube_scatter

    rng = np.random.default_rng(9)
    roc, R = _cube_map(kind, rng)
    vals = rng.standard_normal((roc.shape[0], 26)) * 10.0 ** rng.integers(-3, 4, (roc.shape[0], 1))
    ref = np.asarray(jcube_scatter(jnp.asarray(vals), jnp.asarray(roc.numpy()), R))
    np.testing.assert_array_equal(RegionSum(roc, R)(torch.from_numpy(vals)).numpy(), ref)


def test_region_sum_bit_equal_across_calls():
    roc, R = _cube_map("untiled", np.random.default_rng(6))
    vals = torch.from_numpy(np.random.default_rng(7).standard_normal((roc.shape[0], 26))).to(torch.float32)
    rsum = RegionSum(roc, R)
    assert torch.equal(rsum(vals), rsum(vals))
    assert torch.equal(RegionSum(roc, R)(vals), rsum(vals))


def test_region_table_is_one_column_when_tiled():
    """256^3 at tile 8: 32 768 cubes, 65 536 slots, at most one cube each."""
    rng = np.random.default_rng(8)
    nc, R = 32768, 65536
    roc = rng.permutation(R)[:nc]
    roc[rng.random(nc) < 0.5] = -1
    rsum = RegionSum(torch.from_numpy(roc.astype(np.int32)), R)
    assert rsum.table.shape == (R, 1)
    vals = torch.from_numpy(rng.standard_normal(nc))
    got = rsum(vals)
    keep = roc >= 0
    np.testing.assert_array_equal(got.numpy()[roc[keep]], vals.numpy()[keep])
    assert int((got != 0).sum()) == int(keep.sum())
