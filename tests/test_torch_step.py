"""The port's whole ``step`` against the JAX package's packed step, and the
port's import hygiene.

honey_coil 16^3, tile 8, untiled cube regions, max_regions 64, CELL_ARROW,
fp64, tol 1e-3, no BiCGStab fallback, ``fuse_pap=False`` on both sides
(the JAX side through its Pallas kernels in interpret mode).  The host
surface's options (the export switches, ``matrix_scheme``, ``solver_type``
EIGEN) construct, come over from JAX's params and leave ``step`` as JAX's
dispatch leaves it.
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import step as jstep
from polystokes_tpu.config import BasisOrder as JBasisOrder
from polystokes_tpu.config import MatrixScheme as JMatrixScheme
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.config import SolverType as JSolverType
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import convert
from polystokes_tpu_torch import step as tstep
from polystokes_tpu_torch.config import BasisOrder, MatrixScheme, PreconditionerType, SolverParams, SolverType

torch.set_num_threads(1)

VEL_ATOL = 2e-4  # times max |v_jax|: the packed-against-XLA bound of tests/test_pallas_apply.py
ERROR_RTOL = 0.05
MAX_ITER_DIFF = 3

_RESULTS = {}


def _run():
    if not _RESULTS:
        grid, scene = jbuilders.honey_coil(n=16, dtype=jnp.float64)
        params = JParams(
            dtype=jnp.float64, do_tile=False, tile_size=8, tile_padding=2, max_regions=64,
            preconditioner=JPC.CELL_ARROW, tolerance=1e-3, max_iterations=2000, bicgstab_fallback=False,
            use_pallas=True, fuse_pap=False,
        )
        vj, _, sj = jstep(grid, scene, params)
        vt, _, st = tstep(convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"), convert.params_from_jax(params))
        _RESULTS.update(vj=[np.asarray(v) for v in vj], sj=sj, vt=[v.numpy() for v in vt], st=st)
    return _RESULTS


def test_both_converge_without_boundary_activity():
    r = _run()
    assert bool(r["sj"]["converged"]) and r["st"]["converged"]
    assert int(r["sj"]["boundary_active"]) == 0 and r["st"]["boundary_active"] == 0


def test_region_and_dof_counts_equal():
    r = _run()
    for key in ("n_regions", "n_pressures", "n_active_velocities", "n_stresses", "n_reduced_dofs"):
        assert r["st"][key] == int(r["sj"][key]), key
    assert r["st"]["n_regions"] >= 1


def test_iterations_agree():
    r = _run()
    assert abs(r["st"]["iterations"] - int(r["sj"]["iterations"])) <= MAX_ITER_DIFF


def test_velocities_agree():
    r = _run()
    scale = max(float(np.max(np.abs(v))) for v in r["vj"])
    for a in range(3):
        np.testing.assert_allclose(r["vt"][a], r["vj"][a], rtol=0, atol=VEL_ATOL * scale)


def test_error_agrees():
    r = _run()
    ej = float(r["sj"]["error"])
    assert abs(r["st"]["error"] - ej) <= ERROR_RTOL * ej


def test_operator_applies_counted():
    """One apply in pcg_init plus one per loop pass."""
    st = _run()["st"]
    assert st["operator_applies"] == st["iterations"] + 2


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "pre = set(sys.modules)\n"
        "import polystokes_tpu_torch, polystokes_tpu_torch.convert, polystokes_tpu_torch.scenes.builders\n"
        "import polystokes_tpu_torch.sim, polystokes_tpu_torch.domain, polystokes_tpu_torch.run\n"
        "import polystokes_tpu_torch.io.checkpoint\n"
        "import polystokes_tpu_torch.export, polystokes_tpu_torch.host_solve, polystokes_tpu_torch.precond_host\n"
        "import polystokes_tpu_torch.viz\n"
        "new = set(sys.modules) - pre\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'polystokes_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules or 'jax' in pre\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


_HOST_OPTIONS = [
    ("export_matrices", True, "export_matrices", True), ("export_stats", True, "export_stats", True),
    ("export_component_matrices", True, "export_component_matrices", True),
    ("matrix_scheme", MatrixScheme.ALL_DOFS, "matrix_scheme", JMatrixScheme.ALL_DOFS),
    ("solver_type", SolverType.EIGEN, "solver_type", JSolverType.EIGEN),
]
_STEPS = {}


def _small_step(params):
    """The port's step on jelly_jam 12^3 (fp64, tile 6, the unpacked
    default apply, IDENTITY, tol 1e-4), cached by params."""
    if params not in _STEPS:
        from polystokes_tpu_torch.scenes.builders import jelly_jam

        grid, scene = jelly_jam(n=12, dtype=torch.float64, device="cpu")
        _STEPS[params] = tstep(grid, scene, params)
    return _STEPS[params]


@pytest.mark.parametrize("field, value, jfield, jvalue", _HOST_OPTIONS, ids=[o[0] for o in _HOST_OPTIONS])
def test_host_surface_options_act_as_jaxs(field, value, jfield, jvalue):
    """Each host-surface option constructs, comes over from JAX's params
    and acts on ``step`` as JAX's does: the export switches and
    ``matrix_scheme`` leave the device step bit-equal to the default's (it
    always runs the factored pressure-stress system); EIGEN handed to
    ``step`` takes its MINRES branch, bit-equal to MINRES's."""
    base = SolverParams(dtype=torch.float64, tile_size=6, tolerance=1e-4, max_iterations=300)
    p = base.replace(**{field: value})
    assert getattr(p, field) == value
    jbase = JParams(dtype=jnp.float64, tile_size=6, tolerance=1e-4, max_iterations=300)
    assert convert.params_from_jax(dataclasses.replace(jbase, **{jfield: jvalue})) == p
    ref = base.replace(solver_type=SolverType.MINRES) if field == "solver_type" else base
    v_ref, _, s_ref = _small_step(ref)
    v, _, s = _small_step(p)
    assert s.keys() == s_ref.keys()
    for k in s:  # NaN equals NaN here (MINRES's error on this scene)
        assert s[k] == s_ref[k] or (isinstance(s[k], float) and np.isnan(s[k]) and np.isnan(s_ref[k])), k
    for a, b in zip(v, v_ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("field", ["coeff_bf16", "deflation"])
def test_bf16_and_deflation_options_run(field):
    """coeff_bf16 and deflation construct and step: honey_coil 16^3, tiled
    at tile 8, packed, CELL_ARROW, fp64, converged."""
    from polystokes_tpu_torch.scenes.builders import honey_coil

    grid, scene = honey_coil(n=16, dtype=torch.float64, device="cpu")
    params = SolverParams(**{field: True}, dtype=torch.float64, tile_size=8, use_pallas=True,
                          preconditioner=PreconditionerType.CELL_ARROW, tolerance=1e-4, bicgstab_fallback=False)
    assert getattr(params, field) is True
    _, _, stats = tstep(grid, scene, params)
    assert stats["converged"] and stats["error"] < 1e-4 and stats["boundary_active"] == 0


@pytest.mark.parametrize("field", ["fuse_pap", "do_reduced_regions", "fuse_update", "fuse_expand", "do_tile",
                                   "device_warm_start", "bicgstab_fallback", "use_pallas", "cube_regions"])
@pytest.mark.parametrize("value", [True, False])
def test_ported_options_construct(field, value):
    assert getattr(SolverParams(**{field: value}), field) is value


def test_tiles_without_padding_construct():
    """tile_padding=0 (tiles without padding slabs) runs, unpacked, as in JAX."""
    assert SolverParams(do_tile=True, tile_padding=0).tile_padding == 0


def test_affine_basis_is_ported():
    """BasisOrder.AFFINE (the CLI's --affine) constructs, with JAX's 11 DOFs."""
    p = SolverParams(basis=BasisOrder.AFFINE)
    assert p.basis == BasisOrder.AFFINE and p.reduced_dof == JParams(basis=JBasisOrder.AFFINE).reduced_dof == 11


def test_fuse_pap_defaults_on_as_in_jax():
    assert SolverParams().fuse_pap and JParams().fuse_pap


def test_bicgstab_fallback_defaults_on_as_in_jax():
    assert SolverParams().bicgstab_fallback and JParams().bicgstab_fallback


def test_do_tile_defaults_on_as_in_jax():
    assert SolverParams().do_tile and JParams().do_tile
    assert SolverParams(do_tile=True, tile_size=16, tile_padding=2).do_tile


def test_builders_default_to_the_card():
    """Every scene builder puts its tensors on the card unless asked for the CPU."""
    import inspect

    from polystokes_tpu_torch.scenes.builders import SCENES, armadillo_melt_si

    for fn in list(SCENES.values()) + [armadillo_melt_si]:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def _boundary_liquid():
    """honey_coil 16^3 with liquid filling the whole domain box."""
    from polystokes_tpu_torch.scenes.builders import honey_coil

    grid, scene = honey_coil(n=16, dtype=torch.float64, device="cpu")
    scene = dataclasses.replace(scene, surface_sdf=torch.full(grid.res, -1.0, dtype=torch.float64))
    return grid, scene, SolverParams(do_tile=False, dtype=torch.float64, tile_size=8, max_regions=64,
                                     preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True)


def test_check_pallas_raises_on_boundary_liquid():
    """The packed pre-flight warns with the count and switches the solve to
    the unpacked apply (use_pallas=False), as the JAX package's does."""
    from polystokes_tpu_torch.solver import check_pallas

    grid, scene, params = _boundary_liquid()
    with pytest.warns(UserWarning, match="index-0 planes"):
        assert check_pallas(grid, scene, params) == params.replace(use_pallas=False)


def test_step_fails_safe_on_boundary_liquid():
    """A direct step() reports the dropped index-0 activity and is not
    converged (the solver's fail-safe)."""
    grid, scene, params = _boundary_liquid()
    _, _, stats = tstep(grid, scene, params.replace(do_solve=False))
    assert stats["boundary_active"] > 0
    assert not stats["converged"]
