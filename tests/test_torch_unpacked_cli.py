"""The CLI's unpacked default, ``--pallas`` and ``--profile`` at 12^3 on the
CPU, and a JAX checkpoint written with ``use_pallas=False`` (the JAX CLI's
default) resumed by the port's CLI."""
import torch

import jax.numpy as jnp

from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.io import checkpoint as jck
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import run, solver
from polystokes_tpu_torch.io import checkpoint as tck

torch.set_num_threads(1)

SMALL = ["--scene", "jelly_jam", "--n", "12", "--fp64", "--tile-size", "6", "--max-iterations", "300",
         "--tolerance", "1e-4", "--device", "cpu", "--steps", "1"]


def _spy_step(monkeypatch):
    """Records the layout of every solver.step the CLI runs."""
    seen = []
    real = solver.step

    def spy(grid, scene, params, *a, **k):
        seen.append(solver._use_packed(grid, params))
        return real(grid, scene, params, *a, **k)

    monkeypatch.setattr(solver, "step", spy)
    return seen


def test_cli_default_runs_unpacked_and_pallas_packed(capsys, monkeypatch):
    seen = _spy_step(monkeypatch)
    run.main(SMALL)
    assert "step 0:" in capsys.readouterr().out
    run.main(SMALL + ["--pallas", "--precond", "cell_arrow"])
    out = capsys.readouterr().out
    assert "step 0:" in out and "converged=True" in out
    assert seen == [False, True]


def test_cli_profile_prints_the_stages(capsys):
    run.main(SMALL + ["--profile", "--max-iterations", "2000"])
    out = capsys.readouterr().out
    assert "step 0:" in out and "Solve iterations:" in out and "converged=True" in out
    for stage in ("build_integration_weights", "classify", "assemble", "build_rhs", "solve", "recover_velocity",
                  "apply_solution"):
        assert f"  {stage}: " in out, stage


def test_cli_resumes_a_jax_unpacked_checkpoint(tmp_path, capsys):
    grid, scene = jbuilders.jelly_jam(n=12, dtype=jnp.float64)
    jp = JParams(dtype=jnp.float64, tile_size=6, max_iterations=300, tolerance=1e-4)
    assert not jp.use_pallas
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, grid, scene, jp, step_index=2)
    _, _, params, k, _ = tck.load_checkpoint(path, device="cpu")
    assert not params.use_pallas and k == 2
    run.main(["--resume", path, "--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 2:" in out and "converged=True" in out
