"""The export surface on a card (marker ``cuda``; each test skips without
CUDA).  This file imports no JAX:

    python -m pytest tests/test_torch_cuda_export.py -m cuda --noconftest -q

* the explicit blocks (``export.ExplicitOperators``) and ``vectors()``
  from the card's assembled state of honey_coil 32^3 (fp64, tiled at tile
  8, CELL_ARROW) against the CPU port's: identical sparsity after
  ``sum_duplicates`` and sorting, values within 1e-12 of each block's max;
* on A's configuration (untiled cube regions at tile 16, packed,
  CELL_ARROW, f32) at 16^3 and 32^3: ``schur_matrix() @ x`` and the
  factored ``schur_operator() @ x`` for a seeded x in the DOF order against
  the fused packed apply (kernels 4, 2, 5) and the unfused one (1, 2, 3)
  on the same x, within 1e-5 of max, and <x, A x> within 1e-5;
* ``solution_guess_ptau`` puts an exported solution on the card.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from polystokes_tpu_torch import PreconditionerType, SolverParams, solver
from polystokes_tpu_torch import export as ex
from polystokes_tpu_torch import packed_apply as pa
from polystokes_tpu_torch.classify import effective_max_regions
from polystokes_tpu_torch.scenes.builders import honey_coil

pytestmark = pytest.mark.cuda

ATOL = 1e-12
APPLY_RTOL = 1e-5
BLOCKS = ("G", "JG", "Dt", "JDt", "Mc", "McInv", "u", "uInv", "Mr", "BInv", "B", "uRed", "uInvRed", "JDtRed")


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _tiled_fp64():
    return SolverParams(dtype=torch.float64, tile_size=8, tile_padding=2, preconditioner=PreconditionerType.CELL_ARROW,
                        use_pallas=True, bicgstab_fallback=False, tolerance=1e-3)


def _ops(where, p, n=32, weights=True):
    g, s = honey_coil(n=n, dtype=p.dtype, device=where)
    cls, asm = solver._setup(g, s, p)
    kw = {}
    if weights:
        lw, fw = solver._weights(g, s, p)
        kw = dict(weights=(lw, fw), viscosity=s.viscosity)
    return g, s, cls, asm, ex.ExplicitOperators(g, cls, asm, p, **kw)


_CARD_CPU = {}


def _card_and_cpu():
    if not _CARD_CPU:
        p = _tiled_fp64()
        _CARD_CPU["cuda"] = _ops("cuda", p)[-1]
        _CARD_CPU["cpu"] = _ops("cpu", p)[-1]
    return _CARD_CPU["cuda"], _CARD_CPU["cpu"]


@pytest.mark.parametrize("block", BLOCKS)
def test_blocks_card_against_cpu(block):
    _require_cuda()
    card, cpu = _card_and_cpu()
    a, b = sp.csr_matrix(getattr(cpu, block)()), sp.csr_matrix(getattr(card, block)())
    for m in (a, b):
        m.sum_duplicates()
        m.sort_indices()
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
    scale = float(np.abs(a.data).max()) if a.nnz else 0.0
    assert np.abs(a.data - b.data).max(initial=0.0) <= ATOL * scale


def test_vectors_card_against_cpu():
    _require_cuda()
    card, cpu = _card_and_cpu()
    assert card.R == cpu.R and card.R > 0
    vc, vp = card.vectors(), cpu.vectors()
    for k in vp:
        assert np.abs(vc[k] - vp[k]).max(initial=0.0) <= ATOL * np.abs(vp[k]).max(initial=0.0), k


@pytest.mark.parametrize("n", [16, 32])
def test_exported_operator_against_the_kernels(n):
    _require_cuda()
    p = SolverParams(dtype=torch.float32, do_tile=False, tile_size=16, tile_padding=2, max_regions=64,
                     preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True, bicgstab_fallback=False)
    g, s, cls, asm, ops = _ops("cuda", p, n=n, weights=False)
    assert solver._use_packed(g, p) and solver.boundary_activity(g, s, p) == 0
    R = effective_max_regions(g, p)
    x = np.random.default_rng(n).standard_normal(ops.nP + ops.nS).astype(np.float32).astype(np.float64)
    sx = ops.schur_matrix() @ x
    scale = float(np.abs(sx).max())
    assert np.abs(ops.schur_operator() @ x - sx).max() <= APPLY_RTOL * scale
    xp = pa.pack_ptau(ex.ptau_from_dofs(x[:ops.nP], x[ops.nP:], ops, torch.float32, "cuda"))
    pa.reset_launches()
    ax, pap = solver.make_apply_packed_pap(g, cls, asm, p, R)(xp)
    au = solver.make_apply_packed(g, cls, asm, p, R)(xp)
    torch.cuda.synchronize()
    assert {k: v for k, v in pa.LAUNCHES.items() if v} == {"grid_mom_pap": 1, "finish": 1, "expand": 2, "moments": 1,
                                                            "apply_reduced": 1}
    for out in (ax, au):
        got = np.concatenate(ex.dofs_from_ptau(pa.unpack_ptau(out), ops)).astype(np.float64)
        assert np.abs(got - sx).max() <= APPLY_RTOL * scale
    assert abs(float(pap) - x @ sx) <= APPLY_RTOL * abs(x @ sx)


def test_solution_guess_lands_on_the_card(tmp_path):
    _require_cuda()
    card, _ = _card_and_cpu()
    p = np.arange(card.nP, dtype=np.float64)
    s = np.arange(card.nS, dtype=np.float64)
    prefix = str(tmp_path / "g.")
    np.savez_compressed(prefix + "solution.npz", pressure=p, stress=s)
    guess = ex.solution_guess_ptau(prefix, card, torch.float64)
    assert guess.p.is_cuda and guess.p.dtype == torch.float64
    back = ex.dofs_from_ptau(guess, card)
    assert np.array_equal(back[0], p) and np.array_equal(back[1], s)
