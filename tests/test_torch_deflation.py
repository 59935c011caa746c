"""A-DEF2 deflation (``deflation.py``) in the port against the JAX package,
in fp64 on the CPU.

honey_coil 16^3, tiled at tile 8 (padding 2), CELL_ARROW: the case of
``tests/test_deflation.py``, k = 7 * 8 = 56 coarse unknowns.  Checked:

* E against JAX's ``_make_deflation`` (unpacked probes), with the port's
  probes through the packed kernels' twins and through the unpacked apply,
  within E_RTOL of max |E|; the masks equal;
* E^-1 against JAX's within E_RTOL (two LU inverses), and one deflated
  preconditioner apply and the projected guess against JAX's on the
  packed and the unpacked layout, the port's functions on JAX's state (so
  that the two inverses' rounding stays out), within APPLY_RTOL of max;
* W^T r0 = 0 after the projection of the step's right-hand side;
* ``make_fused_update`` is None under deflation;
* an unsupported configuration (untiled reduced) warns and steps exactly
  as without deflation;
* the deflated ``step`` (unpacked) and ``solve_chunked`` (packed) against
  JAX's deflated step, all stopped after STEP_ITERS iterations;
* deflation with ``coeff_bf16`` on the packed path: converged, and the
  coarse correction built from the bf16 apply.

The JAX side is built once (module-scoped fixture).
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import deflation as jdefl
from polystokes_tpu import pallas_apply as jpa
from polystokes_tpu import solver as jsolver
from polystokes_tpu import step as jstep
from polystokes_tpu.classify import effective_max_regions as jR
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import convert
from polystokes_tpu_torch import deflation as tdefl
from polystokes_tpu_torch import solver as tsolver

torch.set_num_threads(1)

E_RTOL = 1e-9  # the same applies, probe sums in another order
APPLY_RTOL = 1e-12  # fp64; the same state, the applies' sums in another order
STEP_ITERS = 20  # the fp64 CG trajectories agree to round-off this far
STEP_RTOL = 1e-10  # times max |v|
PROJ_RTOL = 1e-8  # |W^T r0| against |W^T b|, as tests/test_deflation.py
BASE = dict(dtype=jnp.float64, do_tile=True, tile_size=8, tile_padding=2, preconditioner=JPC.CELL_ARROW,
            bicgstab_fallback=False, deflation=True, use_pallas=False)


def _rel(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    return float(np.max(np.abs(port - ref))) / float(np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def case():
    grid, scene = jbuilders.honey_coil(n=16, dtype=jnp.float64)
    params = JParams(**BASE)
    R = jR(grid, params)
    cls, asm = jsolver._setup_jit(grid, scene, params)
    defl = jsolver._make_deflation(grid, cls, asm, params)
    tgrid, tparams = convert.grid_from_jax(grid), convert.params_from_jax(params)
    tscene = convert.scene_from_numpy(scene, "cpu")
    tcls, tasm = tsolver._setup(tgrid, tscene, tparams)
    rng = np.random.default_rng(23)
    mask = np.asarray(defl.masks)
    return dict(grid=grid, scene=scene, params=params, R=R, cls=cls, asm=asm, defl=defl, tgrid=tgrid,
                tscene=tscene, tparams=tparams, tcls=tcls, tasm=tasm, tdefl={},
                r=rng.standard_normal((7,) + grid.res) * mask, x0=rng.standard_normal((7,) + grid.res) * mask)


def _tdefl(case, packed):
    """The port's deflation state on one layout, built once per file."""
    p = case["tparams"].replace(use_pallas=packed)
    assert tsolver._use_packed(case["tgrid"], p) == packed
    if packed not in case["tdefl"]:
        case["tdefl"][packed] = tsolver._make_deflation(case["tgrid"], case["tcls"], case["tasm"], p)
    return case["tdefl"][packed], p


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_coarse_operator_matches_jax(case, packed):
    d, _ = _tdefl(case, packed)
    jd = case["defl"]
    assert (d.cs, d.tile) == (tuple(jd.cs), jd.tile) and d.e.shape == (56, 56)
    assert np.array_equal(d.masks.numpy(), np.asarray(jd.masks))
    assert _rel(d.e, jd.e) <= E_RTOL
    assert torch.equal(d.e, d.e.T)


def _jax_apply(case, packed):
    """JAX's apply on packed vectors (packed) or on PTau values.  The
    deflated preconditioners below wrap no base: JAX's CELL_ARROW factors
    take seconds to build eagerly here, and the deflated step with its
    CELL_ARROW base is held to JAX's below."""
    grid, cls, asm, R = case["grid"], case["cls"], case["asm"], case["R"]
    if packed:
        return jsolver.make_apply_packed(grid, cls, asm, case["params"].replace(use_pallas=True), R)
    return jsolver.make_apply(grid, cls, asm, case["params"], R)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_deflated_precond_and_guess_match_jax(case, packed):
    own, p = _tdefl(case, packed)
    jd = case["defl"]
    assert _rel(own.einv, jd.einv) <= E_RTOL
    d = tdefl.DeflationState(masks=torch.from_numpy(np.array(jd.masks)), e=torch.from_numpy(np.array(jd.e)),
                             einv=torch.from_numpy(np.array(jd.einv)), cs=tuple(jd.cs), tile=jd.tile)
    japply = _jax_apply(case, packed)
    tapply = (tsolver.make_apply_packed if packed else tsolver.make_apply)(
        case["tgrid"], case["tcls"], case["tasm"], p, case["R"])
    if packed:
        jz = jdefl.deflated_precond_packed(jd, japply)(jnp.asarray(case["r"]))
        tz = tdefl.deflated_precond_packed(d, tapply)(torch.from_numpy(case["r"]))
        jx = jdefl.deflate_guess_packed(jd, japply, jnp.asarray(case["r"]), jnp.asarray(case["x0"]))
        tx = tdefl.deflate_guess_packed(d, tapply, torch.from_numpy(case["r"]), torch.from_numpy(case["x0"]))
    else:
        from polystokes_tpu_torch.packed_apply import pack_ptau, unpack_ptau

        r, x0 = jpa.unpack_ptau(jnp.asarray(case["r"])), jpa.unpack_ptau(jnp.asarray(case["x0"]))
        tr, tx0 = unpack_ptau(torch.from_numpy(case["r"])), unpack_ptau(torch.from_numpy(case["x0"]))
        jz = jpa.pack_ptau(jdefl.deflated_precond_ptau(jd, japply)(r))
        tz = pack_ptau(tdefl.deflated_precond_ptau(d, tapply)(tr))
        jx = jpa.pack_ptau(jdefl.deflate_guess_ptau(jd, japply, r, x0))
        tx = pack_ptau(tdefl.deflate_guess_ptau(d, tapply, tr, tx0))
    assert _rel(tz, jz) <= APPLY_RTOL
    assert _rel(tx, jx) <= APPLY_RTOL


def test_projection_zeroes_the_coarse_residual(case):
    d, p = _tdefl(case, True)
    apply_k = tsolver.make_apply_packed(case["tgrid"], case["tcls"], case["tasm"], p, case["R"])
    b = tsolver.pack_ptau(tsolver.build_rhs(case["tgrid"], case["tcls"], case["tasm"], p, case["R"]))
    x0 = tdefl.deflate_guess_packed(d, apply_k, b, torch.zeros_like(b))
    q = tdefl._restrict(b - apply_k(x0), d.masks, d.cs, d.tile)
    scale = float(torch.linalg.vector_norm(tdefl._restrict(b, d.masks, d.cs, d.tile)))
    assert float(torch.linalg.vector_norm(q)) <= PROJ_RTOL * max(scale, 1.0)


def test_fused_update_is_off_under_deflation(case):
    p = case["tparams"].replace(use_pallas=True, fuse_update=True)
    fac = tsolver.precond_factors_packed(case["tgrid"], case["tcls"], case["tasm"], p)
    assert tsolver.make_fused_update(p.replace(deflation=False), fac, case["tcls"], case["tasm"]) is not None
    assert tsolver.make_fused_update(p, fac, case["tcls"], case["tasm"]) is None


def test_unsupported_deflation_warns_and_steps_undeflated(case):
    """Untiled reduced regions: the probes' support is unbounded, so the
    step warns and runs exactly the undeflated solve."""
    p = case["tparams"].replace(do_tile=False, max_regions=64, use_pallas=True, max_iterations=STEP_ITERS,
                                tolerance=1e-30)
    with pytest.warns(UserWarning, match="deflation requested but unsupported"):
        v1, _, s1 = tsolver.step(case["tgrid"], case["tscene"], p)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        v0, _, s0 = tsolver.step(case["tgrid"], case["tscene"], p.replace(deflation=False))
    assert s1["iterations"] == s0["iterations"] == STEP_ITERS
    assert all(torch.equal(a, b) for a, b in zip(v0, v1))


def test_deflated_step_and_chunked_match_jax(case):
    """JAX's deflated step (unpacked) against the port's deflated step
    (unpacked) and solve_chunked (packed, two segments), all stopped after
    STEP_ITERS iterations."""
    jp = case["params"].replace(max_iterations=STEP_ITERS, tolerance=1e-30)
    vj, _, sj = jstep(case["grid"], case["scene"], jp)
    tp = convert.params_from_jax(jp)
    vt, _, st = tsolver.step(case["tgrid"], case["tscene"], tp)
    vc, _, sc = tsolver.solve_chunked(case["tgrid"], case["tscene"], tp.replace(use_pallas=True),
                                      segment_iters=STEP_ITERS // 2)
    assert int(sj["iterations"]) == st["iterations"] == sc["iterations"] == STEP_ITERS
    scale = max(float(np.max(np.abs(np.asarray(v)))) for v in vj)
    for vel in (vt, vc):
        for a in range(3):
            np.testing.assert_allclose(vel[a].numpy(), np.asarray(vj[a]), rtol=0, atol=STEP_RTOL * scale)


def test_deflation_with_bf16_coefficients(case):
    """Both options on the packed path: the coarse operator is built from
    the bf16 apply (so it differs from the full-precision one by the bf16
    rounding), the projected guess zeroes W^T r0, and the step converges."""
    p = case["tparams"].replace(use_pallas=True, coeff_bf16=True, tolerance=1e-6)
    d16 = tsolver._make_deflation(case["tgrid"], case["tcls"], case["tasm"], p)
    d, _ = _tdefl(case, True)
    rel = _rel(d16.e, d.e.numpy())
    assert 0.0 < rel < 0.03
    _, _, st = tsolver.step(case["tgrid"], case["tscene"], p)
    assert st["converged"] and st["error"] < 1e-6
