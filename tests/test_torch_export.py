"""The port's export surface (``polystokes_tpu_torch.export``, the native
MatrixMarket writer, ``reduced.viscosity_incl_boundary`` and the small
helpers) against the JAX package's on the CPU, in fp64, with the JAX side
set up once per case:

* cases: ``tests/test_operators.make_case`` with ``reduced=True,
  solid=True`` (the solid-cut floor under interior tile regions) and with
  ``reduced=False`` (no regions) on the same grid and floor, state carried
  over through ``convert.scene_from_numpy`` / ``params_from_jax``;
* every ``ExplicitOperators`` block with identical sparsity (row and
  column arrays after ``sum_duplicates`` and index sorting) and values
  within 1e-12 of the block's max; ``vectors()``, ``guess_vectors()`` and
  the four scheme matrices with their right-hand sides the same way;
* ``viscosity_incl_boundary`` within 1e-12 of max;
* ``solve_explicit`` for every scheme at a fixed count of iterations,
  with ``method="direct"`` on the velocity-pressure layout (SuperLU on the
  other layouts takes 9-300 s a solve here; the fixed-count solves hold
  their systems and right-hand sides), and with each host preconditioner
  at one fixed GMRES cycle: x within 1e-10 of max.  Fixed counts, since Krylov
  trajectories part by round-off: 20 (``FIXED_ITERS``), but 10 for MINRES
  on the indefinite layouts of the solid case, where the port's B and
  BInv differ from JAX's by 5e-16 of max (another Cholesky inverse) and a
  perturbation of that size moves JAX's own 20-iteration MINRES x on
  ``all_dofs`` by 1e-2 of max;
* the explicit Schur matrix applied to x equals ``make_apply(x)``, in
  JAX and in the port (the relation the card's smoke holds the kernels
  to), and so does the port's factored ``schur_operator``;
  ``extract_residuals`` against JAX's;
* files both ways: the port writes and JAX reads, JAX writes and the port
  reads (``components.npz``, the ``.mtx`` files, ``solution.npz``,
  ``grids.npz``); ``stats.json`` equal to JAX's for the same step stats;
  the native writer's ``.mtx`` byte-equal to JAX's native writer's;
* the warm-start round trip through the port's ``step``: an exported
  explicit solution seeds the packed step, which converges in fewer than
  max(cold // 4, 2) iterations.
"""
import json

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from polystokes_tpu import basis as jbasis
from polystokes_tpu import classify as jcls_mod
from polystokes_tpu import export as jex
from polystokes_tpu import native as jnative
from polystokes_tpu import sdf as jsdf
from polystokes_tpu.classify import classify as jclassify
from polystokes_tpu.classify import effective_max_regions as jemr
from polystokes_tpu.operators import PTau as JPTau
from polystokes_tpu.reduced import gather_com as j_gather_com
from polystokes_tpu.reduced import viscosity_incl_boundary as j_vib
from polystokes_tpu.solver import assemble as jassemble
from polystokes_tpu.solver import build_rhs as jbuild_rhs
from polystokes_tpu.solver import edge_viscosity as j_edge_viscosity
from polystokes_tpu.weights import compute_weights as jweights

from polystokes_tpu_torch import basis, convert, native, sdf, solver
from polystokes_tpu_torch import classify as tcls_mod
from polystokes_tpu_torch import export as tex
from polystokes_tpu_torch.config import PreconditionerType, SolverParams
from polystokes_tpu_torch.reduced import gather_com, viscosity_incl_boundary
from polystokes_tpu_torch.scenes.builders import honey_coil

from test_operators import make_case

torch.set_num_threads(1)

ATOL = 1e-12  # times the max of each block or vector
X_ATOL = 1e-10  # times max |x| of the explicit solves
FIXED_ITERS = 20
MINRES_ITERS_SOLID = 10  # see the docstring: MINRES on the solid case's KKT layouts parts by round-off after
# the case without regions on the solid case's grid (one set of JAX compiles)
CASES = {"solid": dict(reduced=True, solid=True), "uniform": dict(res=(14, 12, 18), reduced=False, solid=True)}
BLOCKS = ("G", "JG", "Dt", "JDt", "Mc", "McInv", "u", "uInv", "Mr", "BInv", "B", "uRed", "uInvRed", "JDtRed")
SCHEMES = ("pressure_stress", "all_dofs", "pressure_velocity", "all_dofs_explicit_interior_stress")
SCHEME_MATRICES = {"pressure_stress": "schur_matrix", "all_dofs": "kkt_matrix",
                   "pressure_velocity": "pressure_velocity_matrix",
                   "all_dofs_explicit_interior_stress": "kkt_explicit_interior_stress_matrix"}

_CACHE = {}


def _case(name):
    """Both packages' classification, assembly and ExplicitOperators of one
    case (JAX's once per module)."""
    if name not in _CACHE:
        grid, params, scene = make_case(**CASES[name])
        R = jemr(grid, params)
        lw, fw = jweights(grid, scene.surface_sdf, scene.collision_sdf, params.dtype)
        cls = jclassify(grid, lw, fw, params)
        asm, _ = jassemble(grid, scene, cls, lw, fw, params, R)
        jops = jex.ExplicitOperators(grid, cls, asm, params, weights=(lw, fw), viscosity=scene.viscosity)
        tg, ts, tp = convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"), convert.params_from_jax(params)
        tlw, tfw = solver._weights(tg, ts, tp)
        tcls = tcls_mod.classify(tg, tlw, tfw, tp)
        tasm, _ = solver.assemble(tg, ts, tcls, tlw, tfw, tp, tcls_mod.effective_max_regions(tg, tp))
        tops = tex.ExplicitOperators(tg, tcls, tasm, tp, weights=(tlw, tfw), viscosity=ts.viscosity)
        _CACHE[name] = dict(grid=grid, params=params, scene=scene, R=R, lw=lw, fw=fw, cls=cls, asm=asm, jops=jops,
                            tg=tg, ts=ts, tp=tp, tlw=tlw, tfw=tfw, tcls=tcls, tasm=tasm, tops=tops)
    return _CACHE[name]


def _assert_sparse_equal(a, b, label):
    """Identical sparsity after sum_duplicates and sorting; values within
    ATOL of the max."""
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    for m in (a, b):
        m.sum_duplicates()
        m.sort_indices()
    assert a.shape == b.shape, label
    assert np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices), f"{label}: sparsity differs"
    scale = float(np.abs(a.data).max()) if a.nnz else 0.0
    assert np.abs(a.data - b.data).max(initial=0.0) <= ATOL * scale, label


def _assert_close(a, b, label, atol=ATOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, label
    scale = float(np.abs(a).max(initial=0.0))
    assert np.abs(a - b).max(initial=0.0) <= atol * scale, label


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", CASES)
def test_blocks_match_jax(case, block):
    c = _case(case)
    _assert_sparse_equal(getattr(c["jops"], block)(), getattr(c["tops"], block)(), f"{case} {block}")


@pytest.mark.parametrize("case", CASES)
def test_counts_vectors_and_guesses_match_jax(case):
    c = _case(case)
    j, t = c["jops"], c["tops"]
    assert (j.nP, j.nF, j.nE, j.nV, j.nS, j.R, j.nW) == (t.nP, t.nF, t.nE, t.nV, t.nS, t.R, t.nW)
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(j.face_idx + j.edge_idx, t.face_idx + t.edge_idx))
    vj, vt = j.vectors(), t.vectors()
    assert list(vj) == list(vt)
    for k in vj:
        _assert_close(vj[k], vt[k], f"{case} {k}")
    for i, (a, b) in enumerate(zip(j.guess_vectors(), t.guess_vectors())):
        _assert_close(a, b, f"{case} guess {i}")


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", CASES)
def test_scheme_matrices_match_jax(case, scheme):
    c = _case(case)
    name = SCHEME_MATRICES[scheme]
    _assert_sparse_equal(getattr(c["jops"], name)(), getattr(c["tops"], name)(), f"{case} {name}")
    if scheme == "all_dofs":
        _assert_close(c["jops"].kkt_rhs(), c["tops"].kkt_rhs(), f"{case} kkt_rhs")
    if scheme == "all_dofs_explicit_interior_stress":
        _assert_close(c["jops"].kkt_explicit_interior_stress_rhs(), c["tops"].kkt_explicit_interior_stress_rhs(),
                      f"{case} interior-stress rhs")


def test_viscosity_incl_boundary_matches_jax():
    """On the solid case (the case without regions has none to sum)."""
    case = "solid"
    c = _case(case)
    visc_e = [j_edge_viscosity(c["scene"].viscosity, e) for e in range(3)]
    vj = np.asarray(j_vib(c["grid"], c["cls"], c["asm"].com, c["scene"].viscosity, visc_e, c["params"], c["R"]))
    tvisc_e = [solver.edge_viscosity(c["ts"].viscosity, e) for e in range(3)]
    vt = viscosity_incl_boundary(c["tg"], c["tcls"], c["tasm"].com, c["ts"].viscosity, tvisc_e, c["tp"], c["tops"].R)
    _assert_close(vj, vt.numpy(), f"{case} viscosity_incl_boundary")
    assert np.abs(vj).max() > 0


def _solve_both(case, **kw):
    c = _case(case)
    xj, _, ij = jex.solve_explicit(c["grid"], c["cls"], c["asm"], c["params"], weights=(c["lw"], c["fw"]),
                                   viscosity=c["scene"].viscosity, **kw)
    xt, _, it = tex.solve_explicit(c["tg"], c["tcls"], c["tasm"], c["tp"], weights=(c["tlw"], c["tfw"]),
                                   viscosity=c["ts"].viscosity, **kw)
    return xj, ij, xt, it


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", CASES)
def test_solve_explicit_matches_jax(case, scheme):
    """Every scheme at a fixed count of iterations (CG, or MINRES on the
    indefinite layouts; tol 1e-14 so neither stops early)."""
    iters = MINRES_ITERS_SOLID if case == "solid" and scheme != "pressure_stress" else FIXED_ITERS
    xj, ij, xt, it = _solve_both(case, scheme=scheme, tol=1e-14, maxiter=iters)
    assert ij == it
    _assert_close(xj, xt, f"{case} {scheme}", atol=X_ATOL)


@pytest.mark.parametrize("case", CASES)
def test_direct_solve_matches_jax(case):
    xj, ij, xt, it = _solve_both(case, scheme="pressure_velocity", method="direct")
    assert ij == it == 0
    _assert_close(xj, xt, f"{case} direct", atol=X_ATOL)


@pytest.mark.parametrize("preconditioner", ["gs_smoother", "eq14"])
def test_preconditioned_solve_matches_jax(preconditioner):
    """The host preconditioners on the velocity-pressure layout: GMRES at a
    fixed restart cycle (20 iterations)."""
    xj, ij, xt, it = _solve_both("solid", scheme="pressure_velocity", preconditioner=preconditioner, tol=1e-14,
                                 maxiter=1)
    assert ij == it
    _assert_close(xj, xt, f"{preconditioner}", atol=X_ATOL)


def _dof_vector(ops, x):
    return np.concatenate(tex.dofs_from_ptau(x, ops))


@pytest.mark.parametrize("case", CASES)
def test_schur_matrix_is_make_apply_in_both(case):
    """schur_matrix() @ x == make_apply(x) on the active DOFs, in JAX and
    in the port (the unpacked apply), to round-off; extract_residuals
    against JAX's."""
    c = _case(case)
    t = c["tops"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(t.nP + t.nS)
    xt = tex.ptau_from_dofs(x[:t.nP], x[t.nP:], t, torch.float64, "cpu")
    xj = JPTau(p=jnp.asarray(xt.p.numpy()), tc=tuple(jnp.asarray(a.numpy()) for a in xt.tc),
               te=tuple(jnp.asarray(a.numpy()) for a in xt.te))
    from polystokes_tpu.solver import make_apply as j_make_apply

    sx = c["jops"].schur_matrix() @ x
    aj = j_make_apply(c["grid"], c["cls"], c["asm"], c["params"], c["R"])(xj)
    at = solver.make_apply(c["tg"], c["tcls"], c["tasm"], c["tp"], t.R)(xt)
    _assert_close(sx, _dof_vector(t, aj), f"{case} JAX apply")
    _assert_close(sx, _dof_vector(t, at), f"{case} port apply")
    _assert_close(t.schur_matrix() @ x, sx, f"{case} port schur")
    _assert_close(t.schur_operator() @ x, sx, f"{case} port schur_operator")
    bj = jbuild_rhs(c["grid"], c["cls"], c["asm"], c["params"], c["R"])
    bt = solver.build_rhs(c["tg"], c["tcls"], c["tasm"], c["tp"], t.R)
    rj = jex.extract_residuals(c["grid"], c["cls"], c["asm"], xj, bj, c["params"], c["R"])
    rt = tex.extract_residuals(c["tg"], c["tcls"], c["tasm"], xt, bt, c["tp"], t.R)
    for a, b in zip((rj.p,) + rj.tc + rj.te, rt.fields()):
        _assert_close(np.asarray(a), b.numpy(), f"{case} residual")


def _read_components(path):
    d = np.load(path)
    names = sorted(k[:-4] for k in d.files if k.endswith("_row"))
    mats = {n: sp.coo_matrix((d[f"{n}_val"], (d[f"{n}_row"], d[f"{n}_col"])), shape=tuple(d[f"{n}_shape"]))
            for n in names}
    return mats, {k[4:]: d[k] for k in d.files if k.startswith("Vec_")}


def test_files_interchange_both_ways(tmp_path):
    c = _case("solid")
    j, t = c["jops"], c["tops"]
    for writer, mod, ops, cls, lw, fw in (("port", tex, t, c["tcls"], c["tlw"], c["tfw"]),
                                          ("jax", jex, j, c["cls"], c["lw"], c["fw"])):
        prefix = str(tmp_path / writer / "run.")
        mod.export_component_matrices(prefix, ops, fmt="npz")
        mod.export_component_matrices(prefix, ops, fmt="mtx")
        mod.export_grids(prefix, cls, lw, fw)
    pt, pj = str(tmp_path / "port" / "run."), str(tmp_path / "jax" / "run.")
    mats_t, vecs_t = _read_components(pt + "components.npz")
    mats_j, vecs_j = _read_components(pj + "components.npz")
    assert sorted(mats_t) == sorted(mats_j) and sorted(vecs_t) == sorted(vecs_j)
    for n in mats_t:
        _assert_sparse_equal(mats_t[n], mats_j[n], f"components {n}")
        _assert_sparse_equal(scipy.io.mmread(pt + f"Mat_{n}.mtx"), scipy.io.mmread(pj + f"Mat_{n}.mtx"), f"mtx {n}")
    for n in vecs_t:
        _assert_close(vecs_t[n], vecs_j[n], f"vector {n}")
        _assert_close(scipy.io.mmread(pt + f"Vec_{n}.mtx"), scipy.io.mmread(pj + f"Vec_{n}.mtx"), f"mtx vector {n}")
    with np.load(pt + "grids.npz") as gt, np.load(pj + "grids.npz") as gj:
        assert sorted(gt.files) == sorted(gj.files)
        for k in gj.files:
            if k.endswith(("_labels", "_region")):
                assert np.array_equal(gt[k], gj[k]), k
            else:
                _assert_close(gj[k], gt[k], k)

    # solutions: a seeded vector in the DOF order, written by each package
    # and read by the other
    x = np.random.default_rng(5).standard_normal(t.nP + t.nS)
    xt = tex.ptau_from_dofs(x[:t.nP], x[t.nP:], t, torch.float64, "cpu")
    tex.export_solution(pt, xt, t)
    xj = JPTau(p=jnp.asarray(xt.p.numpy()), tc=tuple(jnp.asarray(a.numpy()) for a in xt.tc),
               te=tuple(jnp.asarray(a.numpy()) for a in xt.te))
    jex.export_solution(pj, xj, j)
    assert np.array_equal(jex.load_solution_guess(pt, j), x) and np.array_equal(tex.load_solution_guess(pj, t), x)
    for prefix in (pt, pj):
        gj = jex.solution_guess_ptau(prefix, j, jnp.float64)
        gt = tex.solution_guess_ptau(prefix, t, torch.float64)
        assert gt.p.device.type == "cpu" and gt.p.dtype == torch.float64
        for a, b in zip((gj.p,) + gj.tc + gj.te, gt.fields()):
            assert np.array_equal(np.asarray(a), b.numpy())
    with pytest.raises(ValueError, match="do not match"):
        tex.load_solution_guess(pt, _case("uniform")["tops"])


def test_stats_json_is_jaxs(tmp_path):
    """The port's step stats (Python scalars) write the file JAX writes for
    the same values as its step's 0-d arrays; the host solve's Python
    scalars are written as given in both."""
    step_stats = {"boundary_active": 0, "iterations": 37, "error": 4.5e-4, "converged": True, "operator_applies": 39,
                  "n_regions": 3, "region_overflow": False, "capture_seconds": 0.0, "fallback_kept": None,
                  "sharded": False}
    host_stats = {"iterations": 12, "converged": True, "scheme": "all_dofs", "n_regions": 3, "solver": "eigen_host"}
    for label, stats, jax_stats, from_device in (
            ("step", step_stats, {k: v if v is None else jnp.asarray(v) for k, v in step_stats.items()}, True),
            ("host", host_stats, host_stats, False)):
        pt, pj = str(tmp_path / f"{label}_t."), str(tmp_path / f"{label}_j.")
        tex.export_stats(pt, stats, from_device=from_device)
        jex.export_stats(pj, jax_stats)
        with open(pt + "stats.json") as ft, open(pj + "stats.json") as fj:
            text_t, text_j = ft.read(), fj.read()
        assert text_t == text_j, (text_t, text_j)
        assert json.loads(text_t)["iterations"] == stats["iterations"]


def test_native_mtx_byte_equal_to_jaxs(tmp_path):
    """Each package's writer on its own blocks (bit-equal ones here), and
    both writers on JAX's BInv (the port's differs in the last bits: its
    own Cholesky inverse)."""
    c = _case("solid")
    if native.get_lib() is None or jnative.get_lib() is None:
        pytest.skip("no g++ for the native libraries")
    pairs = [(name, getattr(c["tops"], name)(), getattr(c["jops"], name)()) for name in ("G", "Dt", "JDt", "uInv")]
    pairs.append(("BInv", c["jops"].BInv(), c["jops"].BInv()))
    for name, mt, mj in pairs:
        pt, pj = tmp_path / f"{name}_t.mtx", tmp_path / f"{name}_j.mtx"
        assert native.write_mtx(str(pt), mt) and jnative.write_mtx(str(pj), mj)
        assert pt.read_bytes() == pj.read_bytes(), name
        _assert_sparse_equal(scipy.io.mmread(str(pt)), mj, name)
    v = c["tops"].vectors()["stressRHS"]
    pt, pj = tmp_path / "v_t.mtx", tmp_path / "v_j.mtx"
    assert native.write_mtx_vector(str(pt), v) and jnative.write_mtx_vector(str(pj), c["jops"].vectors()["stressRHS"])
    assert pt.read_bytes() == pj.read_bytes()
    assert np.array_equal(scipy.io.mmread(str(pt)).ravel(), v)


def test_native_writers_return_false_without_the_library(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.write_mtx(str(tmp_path / "m.mtx"), sp.eye(3)) is False
    assert native.write_mtx_vector(str(tmp_path / "v.mtx"), np.ones(3)) is False


@pytest.mark.parametrize("helper", ["evaluate_velocity", "divergence", "is_reduced", "is_solved", "constant",
                                    "gather_com"])
def test_small_helpers_match_jax(helper):
    rng = np.random.default_rng(11)
    off = rng.standard_normal((5, 4, 3))
    if helper in ("evaluate_velocity", "divergence"):
        for b in (jbasis.BasisOrder.QUADRATIC, jbasis.BasisOrder.AFFINE):
            tb = basis.BasisOrder(b.value)
            w = rng.standard_normal((5, 4, b.value))
            if helper == "divergence":
                ref = jbasis.divergence(jnp.asarray(off), jnp.asarray(w), b)
                got = basis.divergence(torch.from_numpy(off), torch.from_numpy(w), tb)
                _assert_close(np.asarray(ref), got.numpy(), helper)
                continue
            for axis in range(3):
                ref = jbasis.evaluate_velocity(jnp.asarray(off), axis, jnp.asarray(w), b)
                got = basis.evaluate_velocity(torch.from_numpy(off), axis, torch.from_numpy(w), tb)
                _assert_close(np.asarray(ref), got.numpy(), helper)
    elif helper in ("is_reduced", "is_solved"):
        lbl = np.arange(6, dtype=np.int8).reshape(2, 3)
        ref = getattr(jcls_mod, helper)(jnp.asarray(lbl))
        assert np.array_equal(np.asarray(ref), getattr(tcls_mod, helper)(torch.from_numpy(lbl)).numpy())
    elif helper == "constant":
        x, y, z = np.zeros((4, 1, 1)), np.zeros((1, 3, 1)), np.zeros((1, 1, 2))
        ref = jsdf.constant(0.25)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
        got = sdf.constant(0.25)(*(torch.from_numpy(a) for a in (x, y, z)))
        assert got.dtype == torch.float64 and np.array_equal(np.asarray(ref), got.numpy())
    else:
        com = rng.standard_normal((6, 3))
        ids = rng.integers(-1, 6, (4, 5)).astype(np.int32)
        ref = j_gather_com(jnp.asarray(com), jnp.asarray(ids))
        assert np.array_equal(np.asarray(ref), gather_com(torch.from_numpy(com), torch.from_numpy(ids)).numpy())


def test_exported_solution_warm_starts_the_port_step(tmp_path):
    """The port's twin of the JAX package's round trip
    (tests/test_round3_fixes.py): solve_explicit at tol 1e-10, export the
    solution, load it as a PTau guess and step from it, packed (tile 8,
    CELL_ARROW) on honey_coil 16^3 in fp64; the explicit path takes the
    loaded vector back with info 0."""
    grid, scene = honey_coil(n=16, dtype=torch.float64, device="cpu")
    params = SolverParams(dtype=torch.float64, max_iterations=3000, tile_size=8, tile_padding=2,
                          bicgstab_fallback=False, tolerance=1e-3, preconditioner=PreconditionerType.CELL_ARROW,
                          use_pallas=True)
    _, _, cold = solver.step(grid, scene, params)
    assert cold["converged"]
    cls, asm = solver._setup(grid, scene, params)
    x, ops, info = tex.solve_explicit(grid, cls, asm, params, tol=1e-10, warm_start=False)
    assert info == 0
    prefix = str(tmp_path / "ws.")
    tex.export_solution(prefix, tex.ptau_from_dofs(x[:ops.nP], x[ops.nP:], ops, torch.float64, "cpu"), ops)
    iters = [0]
    _, _, info2 = tex.solve_explicit(grid, cls, asm, params, warm_start=False, x0=tex.load_solution_guess(prefix, ops),
                                     callback=lambda _x: iters.__setitem__(0, iters[0] + 1))
    assert info2 == 0
    guess = tex.solution_guess_ptau(prefix, ops, params.dtype)
    _, _, warm = solver.step(grid, scene, params, initial_guess=guess)
    assert warm["converged"]
    assert warm["iterations"] < max(cold["iterations"] // 4, 2), (warm["iterations"], cold["iterations"])
