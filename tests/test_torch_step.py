"""The port's whole ``step`` against the JAX package's packed step, and the
port's import hygiene.

honey_coil 16^3, tile 8, untiled cube regions, max_regions 64, CELL_ARROW,
fp64, tol 1e-3, no BiCGStab fallback, ``fuse_pap=False`` on both sides
(the JAX side through its Pallas kernels in interpret mode).
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu import step as jstep
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import convert
from polystokes_tpu_torch import step as tstep
from polystokes_tpu_torch.config import SolverParams

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
        "new = set(sys.modules) - pre\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'polystokes_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules or 'jax' in pre\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# tiles without padding (do_tile is on by default) have no packed path in JAX
_ITEM = {"tile_padding": r"ROADMAP.md Queue 1 item 7 \(the unpacked apply\)"}


@pytest.mark.parametrize("field, value", [
    ("tile_padding", 0), ("cube_regions", False), ("coeff_bf16", True), ("deflation", True),
    ("cc_host_callback", True), ("use_pallas", False), ("bicgstab_fallback", True),
])
def test_unported_options_raise(field, value):
    with pytest.raises(NotImplementedError, match=_ITEM.get(field, "ROADMAP.md")):
        SolverParams(**{field: value})


@pytest.mark.parametrize("field", ["fuse_pap", "do_reduced_regions", "fuse_update", "fuse_expand", "do_tile"])
@pytest.mark.parametrize("value", [True, False])
def test_ported_options_construct(field, value):
    assert getattr(SolverParams(**{field: value}), field) is value


def test_fuse_pap_defaults_on_as_in_jax():
    assert SolverParams().fuse_pap and JParams().fuse_pap


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
    return grid, scene, SolverParams(do_tile=False, dtype=torch.float64, tile_size=8, max_regions=64)


def test_check_pallas_raises_on_boundary_liquid():
    """The packed pre-flight raises with the count instead of switching to
    another path."""
    from polystokes_tpu_torch.solver import check_pallas

    with pytest.raises(ValueError, match="index-0 planes"):
        check_pallas(*_boundary_liquid())


def test_step_fails_safe_on_boundary_liquid():
    """A direct step() reports the dropped index-0 activity and is not
    converged (the solver's fail-safe)."""
    grid, scene, params = _boundary_liquid()
    _, _, stats = tstep(grid, scene, params.replace(do_solve=False))
    assert stats["boundary_active"] > 0
    assert not stats["converged"]
