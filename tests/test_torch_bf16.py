"""bf16 coefficient storage (``coeff_bf16``) in the port against the JAX
package, on the CPU.

honey_coil 16^3, tile 8, untiled cube regions (max_regions 64), in fp64
and f32.  Checked:

* the port's bf16 stack (``pack_coeffs(storage_dtype=torch.bfloat16)``),
  its uniform stack and the solver's bf16 reduced-face masks equal JAX's
  (``pack_coeffs(storage_dtype=jnp.bfloat16, pad=False)``) bit for bit;
* each twin that reads the stack (kernels 1-8 and 10-13), fed JAX's bf16
  stack, against the JAX wrapper in Pallas interpret mode on the same
  inputs: KERNEL_RTOL of max;
* the bf16 packed apply within BF16_RTOL of max of the f32 apply, and
  self-adjoint to SYM_RTOL (the counterpart of
  ``tests/test_pallas_apply.py::test_coeff_bf16_close_and_symmetric``);
* the unpacked path bit-equal with and without ``coeff_bf16``;
* a packed fp64 ``step`` with ``coeff_bf16`` against JAX's, both stopped
  after STEP_ITERS iterations, within STEP_RTOL of max |v|.

The JAX side of each dtype is built once (module-scoped fixtures).  The
CUDA forms against these twins are in ``test_torch_cuda_bf16.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import pallas_apply as jpa
from polystokes_tpu import solver as jsolver
from polystokes_tpu import step as jstep
from polystokes_tpu.classify import effective_max_regions as jR
from polystokes_tpu.config import BasisOrder as JB
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.deflation import packed_masks as jpacked_masks
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import convert
from polystokes_tpu_torch import packed_apply as tpa
from polystokes_tpu_torch import solver as tsolver
from polystokes_tpu_torch.config import BasisOrder as TB

torch.set_num_threads(1)

T = 8
K = 10
ALPHA = 0.37
KERNEL_RTOL = {"f64": 1e-12, "f32": 1e-5}  # the same products of T values, sums in another order
BF16_RTOL = 0.03  # the bf16 rounding of each coefficient (~0.4 %), as the JAX test bounds it
SYM_RTOL = 1e-4  # the JAX test's bound on <y, A x> - <x, A y>, f32
STEP_ITERS = 20  # the two fp64 CG trajectories agree to round-off this far
STEP_RTOL = 1e-10  # times max |v|
DTYPES = {"f64": (jnp.float64, torch.float64, np.float64), "f32": (jnp.float32, torch.float32, np.float32)}
BASE = dict(do_tile=False, tile_size=T, tile_padding=2, max_regions=64, use_pallas=True,
            preconditioner=JPC.CELL_ARROW, bicgstab_fallback=False)


def _bits(a):
    """A bf16 array (JAX) or tensor (port) as its uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _bf16(a):
    """JAX's bf16 array as a port tensor with the same bits."""
    return torch.from_numpy(np.asarray(a).view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)


def _rel(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    return float(np.max(np.abs(port.astype(np.float64) - ref))) / float(np.max(np.abs(ref)))


def _build(tag):
    jdt, tdt, ndt = DTYPES[tag]
    grid, scene = jbuilders.honey_coil(n=16, dtype=jdt)
    params = JParams(dtype=jdt, **BASE)
    R = jR(grid, params)
    cls, asm = jsolver._setup_jit(grid, scene, params)
    tgrid, tparams = convert.grid_from_jax(grid), convert.params_from_jax(params)
    tscene = convert.scene_from_numpy(scene, "cpu")
    tcls, tasm = tsolver._setup(tgrid, tscene, tparams)
    bf = jnp.bfloat16
    red = jsolver._region_algebra_packed(grid, cls, asm, params.replace(coeff_bf16=True), R)[1]
    rng = np.random.default_rng(17)
    mask = np.asarray(jpacked_masks(grid, cls, jnp.float64))
    shape = (7,) + grid.res
    cs = tuple(n // T for n in grid.res)
    red64 = np.asarray(red).astype(np.float64)
    arr = dict(x=rng.standard_normal(shape) * mask, r=rng.standard_normal(shape) * mask,
               p=rng.standard_normal(shape) * mask, og=rng.standard_normal(shape) * mask,
               s=rng.standard_normal((3,) + grid.res), u=rng.standard_normal((3,) + grid.res) * red64,
               v=rng.standard_normal((cs[0], cs[1], 3 * K, cs[2])))
    arr = {k: a.astype(ndt) for k, a in arr.items()}
    # the port's CELL_ARROW factors: an input both sides take as it is
    arr["fac"] = tpa.pack_arrow_factors(tsolver.precond_factors_packed(tgrid, tcls, tasm, tparams)).numpy()
    return dict(
        tag=tag, grid=grid, params=params, cls=cls, asm=asm, R=R, tgrid=tgrid, tparams=tparams, tcls=tcls, tasm=tasm,
        scene=scene, tscene=tscene, red=red, arr=arr,
        jc=jpa.pack_coeffs(asm, cls, storage_dtype=bf, pad=False),
        jc_pad=jpa.pack_coeffs(asm, cls, storage_dtype=bf, pad=True),
        jc_u=jpa.pack_coeffs(asm, None, storage_dtype=bf, pad=False),
        jc_u_pad=jpa.pack_coeffs(asm, None, storage_dtype=bf, pad=True),
    )


@pytest.fixture(scope="module", params=list(DTYPES))
def case(request):
    return _build(request.param)


def test_bf16_stack_equals_jax_bit_for_bit(case):
    """The 17- and 14-channel stacks and the solver's masks, rounded to bf16
    by each package from its own assembly."""
    tc = tpa.pack_coeffs(case["tasm"], case["tcls"], storage_dtype=torch.bfloat16)
    tu = tpa.pack_coeffs(case["tasm"], storage_dtype=torch.bfloat16)
    assert tc.dtype == tu.dtype == torch.bfloat16 and tc.is_contiguous()
    assert np.array_equal(_bits(tc), _bits(case["jc"]))
    assert np.array_equal(_bits(tu), _bits(case["jc_u"]))
    tp = case["tparams"].replace(coeff_bf16=True)
    red = tsolver._region_algebra_packed(case["tgrid"], case["tcls"], case["tasm"], tp, case["R"])[1]
    assert red.dtype == torch.bfloat16 and np.array_equal(_bits(red), _bits(case["red"]))


def _summed(outs):
    """A fused kernel's outputs with its <x, A x> partials summed (the two
    packages cut them into blocks of other sizes)."""
    return tuple(outs[:-1]) + (outs[-1].sum(),)


def _kernel_pair(name, case):
    """(port wrapper call, JAX wrapper call) of one kernel on the bf16 stack."""
    a, res = case["arr"], case["grid"].res
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    tc, tcu, tred = _bf16(case["jc"]), _bf16(case["jc_u"]), _bf16(case["red"])
    jc, jcu, jred = case["jc_pad"], case["jc_u_pad"], case["red"]
    alpha_t = torch.tensor(ALPHA, dtype=t["x"].dtype)
    alpha_j = jnp.asarray(ALPHA, dtype=j["x"].dtype)
    xpad = jpa._pad_halo(j["x"])
    q = JB.QUADRATIC
    pairs = {
        "moments": (lambda: tpa.moments_packed(t["x"], tc, T), lambda: jpa.moments_packed(xpad, jc, res, T, q)),
        "expand": (lambda: tpa.expand_packed(t["v"], tred, T), lambda: jpa.expand_packed(j["v"], jred, res, T, q)),
        "apply_reduced": (lambda: tpa.apply_reduced_packed(t["x"], tc, t["u"]),
                          lambda: jpa.apply_reduced_packed(xpad, jc, j["u"], res)),
        "grid_mom_pap": (lambda: _summed(tpa.grid_mom_pap_packed(t["x"], tc, T)),
                         lambda: _summed(jpa.grid_mom_pap_packed(xpad, jc, res, T, q))),
        "finish": (lambda: tpa.finish_packed(tc, t["og"], t["u"]), lambda: jpa.finish_packed(jc, j["og"], j["u"], res)),
        "apply_uniform_pap": (lambda: _summed(tpa.apply_uniform_pap_packed(t["x"], tcu)),
                              lambda: _summed(jpa.apply_uniform_pap_packed(j["x"], jcu, res))),
        "apply_uniform": (lambda: tpa.apply_uniform_packed(t["x"], tcu), lambda: jpa.apply_uniform_packed(j["x"], jcu, res)),
        "transpose_u": (lambda: tpa.transpose_u_packed(tc, t["u"]), lambda: jpa.transpose_u_packed(jc, j["u"], res)),
        "finish_update": (
            lambda: tpa.finish_update_packed(t["x"], t["r"], t["p"], alpha_t, tc, t["og"], t["u"], t["fac"], "arrow"),
            lambda: jpa.finish_update_packed(j["x"], j["r"], j["p"], alpha_j, jc, j["og"], j["u"], factors=j["fac"],
                                             kind="arrow")),
        "exp_finish_update": (
            lambda: tpa.exp_finish_update_packed(t["x"], t["r"], t["p"], alpha_t, tc, t["og"], t["v"], T, t["fac"], "arrow"),
            lambda: jpa.exp_finish_update_packed(j["x"], j["r"], j["p"], alpha_j, jc, j["og"], j["v"], res, T, q,
                                                 factors=j["fac"], kind="arrow")),
        "forward_s": (lambda: tpa.forward_s_packed(t["x"], tc), lambda: jpa.forward_s_packed(j["x"], jc, res)),
        "combine": (lambda: tpa.combine_packed(t["x"], tc, t["s"], t["u"]),
                    lambda: jpa.combine_packed(j["x"], jc, j["s"], j["u"], res)),
    }
    return pairs[name]


KERNELS = ["moments", "expand", "apply_reduced", "grid_mom_pap", "finish", "apply_uniform_pap", "apply_uniform",
           "transpose_u", "finish_update", "exp_finish_update", "forward_s", "combine"]


@pytest.mark.parametrize("name", KERNELS)
def test_twin_on_bf16_stack_matches_pallas(case, name):
    port, jax_ = _kernel_pair(name, case)
    got, ref = port(), jax_()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    rtol = KERNEL_RTOL[case["tag"]]
    for g, r in zip(got[:3], ref[:3]):  # the update kernels' x', r', z; the others' outputs
        assert _rel(g, r) <= rtol
    for g, r in zip(got[3:], ref[3:]):  # the update kernels' three dots
        assert abs(float(g) - float(r)) <= rtol * abs(float(r))


def test_bf16_apply_close_and_symmetric(case):
    """The bf16-coefficient packed apply within the bf16 rounding of the
    full-precision one, and exactly self-adjoint over the DOF masks (both
    sides read the same rounded values)."""
    tp = case["tparams"]
    a32 = tsolver.make_apply_packed(case["tgrid"], case["tcls"], case["tasm"], tp, case["R"])
    a16 = tsolver.make_apply_packed(case["tgrid"], case["tcls"], case["tasm"], tp.replace(coeff_bf16=True), case["R"])
    x, y = torch.from_numpy(case["arr"]["x"]), torch.from_numpy(case["arr"]["p"])
    ax32, ax16 = a32(x), a16(x)
    assert ax16.dtype == tp.dtype
    diff = float((ax32 - ax16).abs().max())
    assert 0.0 < diff < BF16_RTOL * float(ax32.abs().max())
    lhs, rhs = float((y.double() * ax16.double()).sum()), float((x.double() * a16(y).double()).sum())
    assert abs(lhs - rhs) < SYM_RTOL * max(abs(lhs), 1.0)


def test_unpacked_path_ignores_coeff_bf16(case):
    """use_pallas=False: the apply and a 20-iteration step bit-equal with and
    without coeff_bf16, as in JAX (the unpacked apply reads no stack)."""
    tp = case["tparams"].replace(use_pallas=False, max_iterations=STEP_ITERS, tolerance=1e-30)
    x = tpa.unpack_ptau(torch.from_numpy(case["arr"]["x"]))
    outs = [tsolver.make_apply(case["tgrid"], case["tcls"], case["tasm"], p, case["R"])(x)
            for p in (tp, tp.replace(coeff_bf16=True))]
    assert all(torch.equal(a, b) for a, b in zip(outs[0].fields(), outs[1].fields()))
    vels = [tsolver.step(case["tgrid"], case["tscene"], p)[0] for p in (tp, tp.replace(coeff_bf16=True))]
    assert all(torch.equal(a, b) for a, b in zip(*vels))


def test_bf16_packed_step_matches_jax():
    """The packed fp64 step with coeff_bf16 (fuse_pap, CELL_ARROW) against
    JAX's, both stopped after STEP_ITERS iterations."""
    grid, scene = jbuilders.honey_coil(n=16, dtype=jnp.float64)
    params = JParams(dtype=jnp.float64, **BASE, coeff_bf16=True, max_iterations=STEP_ITERS, tolerance=1e-30)
    vj, _, sj = jstep(grid, scene, params)
    vt, _, st = tsolver.step(convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"),
                             convert.params_from_jax(params))
    assert int(sj["iterations"]) == st["iterations"] == STEP_ITERS
    scale = max(float(np.max(np.abs(np.asarray(v)))) for v in vj)
    for a in range(3):
        np.testing.assert_allclose(vt[a].numpy(), np.asarray(vj[a]), rtol=0, atol=STEP_RTOL * scale)
