"""The port's host explicit path (``host_solve.solve_host`` and ``solve``,
the CLI's ``--solver eigen``) and the host preconditioners
(``precond_host``) against the JAX package's on the CPU, in fp64, on the
cases of ``tests/test_torch_export.py`` (its module cache: run serially
with it, the JAX side is set up once):

* ``solve_host`` for every ``matrix_scheme`` on the case without regions
  (blocks bit-equal to JAX's, so the solves run to the tolerance) and on
  the solid case at a fixed 10 iterations (tol 1e-14: CG then its MINRES
  retry on the Schur system, MINRES on the indefinite layouts), since its
  B and BInv differ from JAX's in the last bits and solves run to a loose
  tolerance part by round-off there (CG to tol 1e-3 ends 1e-3 of max |v|
  from JAX's): velocities within 1e-8 of max |v|, stats equal, the
  velocities on the scene's device in its dtype, and the stats'
  ``stats.json`` byte-equal to JAX's;
* ``host_solve.solve`` sends EIGEN to the host and any other solver type
  to ``step``;
* the GS smoother and the Eq-14 operators on one vector, and
  ``gauss_seidel_iteration`` on a random system, against JAX's.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from polystokes_tpu import export as jex
from polystokes_tpu import precond_host as jph
from polystokes_tpu.config import MatrixScheme as JScheme
from polystokes_tpu.host_solve import solve_host as j_solve_host

from polystokes_tpu_torch import export as tex
from polystokes_tpu_torch import host_solve
from polystokes_tpu_torch import precond_host as tph
from polystokes_tpu_torch.config import MatrixScheme, SolverType

from test_torch_export import _case

torch.set_num_threads(1)

VEL_ATOL = 1e-8  # times max |v| of JAX's velocities
FIXED_ITERS_SOLID = 10
SCHEMES = [s.value for s in MatrixScheme]

_RESULTS = {}


def _both(case, scheme):
    key = (case, scheme)
    if key not in _RESULTS:
        c = _case(case)
        jp = c["params"].replace(matrix_scheme=JScheme(scheme))
        if case == "solid":
            jp = jp.replace(tolerance=1e-14, max_iterations=FIXED_ITERS_SOLID)
        tp = c["tp"].replace(matrix_scheme=MatrixScheme(scheme), tolerance=jp.tolerance,
                             max_iterations=jp.max_iterations)
        vj, valid_j, sj = j_solve_host(c["grid"], c["scene"], jp)
        vt, valid_t, st = host_solve.solve_host(c["tg"], c["ts"], tp)
        _RESULTS[key] = dict(vj=[np.asarray(v) for v in vj], valid_j=[np.asarray(v) for v in valid_j], sj=sj,
                             vt=vt, valid_t=valid_t, st=st)
    return _RESULTS[key]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", ["uniform", "solid"])
def test_solve_host_matches_jax(case, scheme):
    r = _both(case, scheme)
    assert r["st"] == r["sj"], (r["st"], r["sj"])
    assert r["st"]["converged"] == (case == "uniform")
    scale = max(float(np.abs(v).max()) for v in r["vj"])
    for a in range(3):
        assert r["vt"][a].device.type == "cpu" and r["vt"][a].dtype == torch.float64
        np.testing.assert_allclose(r["vt"][a].numpy(), r["vj"][a], rtol=0, atol=VEL_ATOL * scale)
        assert np.array_equal(r["valid_t"][a].numpy(), r["valid_j"][a])


@pytest.mark.parametrize("scheme", ["pressure_stress", "all_dofs"])
def test_host_stats_json_is_jaxs(scheme, tmp_path):
    r = _both("uniform", scheme)
    tex.export_stats(str(tmp_path / "t."), r["st"], from_device=False)
    jex.export_stats(str(tmp_path / "j."), r["sj"])
    assert (tmp_path / "t.stats.json").read_bytes() == (tmp_path / "j.stats.json").read_bytes()


def test_solve_dispatches_on_the_solver_type():
    c = _case("uniform")
    p = c["tp"].replace(tolerance=1e-6)
    _, _, s_host = host_solve.solve(c["tg"], c["ts"], p.replace(solver_type=SolverType.EIGEN))
    assert s_host["solver"] == "eigen_host" and s_host["converged"]
    _, _, s_dev = host_solve.solve(c["tg"], c["ts"], p)
    assert "solver" not in s_dev and s_dev["converged"] and s_dev["operator_applies"] >= 1


@pytest.mark.parametrize("which", ["gs_smoother", "eq14"])
def test_host_preconditioners_match_jax(which):
    c = _case("solid")
    mj = getattr(jph, f"build_{which}")(c["jops"])
    mt = getattr(tph, f"build_{which}")(c["tops"])
    n = c["tops"].nV + c["tops"].nW + c["tops"].nP
    b = np.random.default_rng(7).standard_normal(n)
    zj, zt = mj.as_linear_operator() @ b, mt.as_linear_operator() @ b
    assert zt.shape == (n,)
    assert np.abs(zt - zj).max() <= 1e-12 * np.abs(zj).max()


def test_gauss_seidel_iteration_matches_jax():
    rng = np.random.default_rng(2)
    m = sp.random(40, 40, density=0.15, random_state=3, format="csr") + sp.diags(rng.uniform(2.0, 3.0, 40))
    m = m.tolil()
    m[5, 5] = 0.0  # an empty diagonal entry, which both guard
    m = m.tocsr()
    rhs, x0 = rng.standard_normal(40), rng.standard_normal(40)
    assert np.array_equal(tph.gauss_seidel_iteration(m, rhs, x0, 16), jph.gauss_seidel_iteration(m, rhs, x0, 16))
