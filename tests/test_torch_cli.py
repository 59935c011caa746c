"""The port's CLI (``polystokes_tpu_torch.run``) and checkpoints
(``polystokes_tpu_torch.io.checkpoint``) against the JAX package's.

* Params JSON: the port's text decodes in JAX to the same params and
  JAX's in the port, both texts are equal, a partial JSON overrides a
  base.
* Checkpoints interchange: JAX writes and the port loads, the port writes
  and JAX loads, with equal arrays, params, step index and extra state;
  neither keeps ``scene.density`` (the JAX format's).
* ``run.main`` with ``--device cpu``: JAX's CLI test invocation (jelly_jam
  n=12, fp64, tile 6) with a checkpoint, then ``--resume`` (the step index
  continues), ``--chunked``, ``--sim --steps 1``, and ``--crop`` on
  viscous_beam 64^3 (the smallest builder scene that CLI's margin of 4
  crops; 40 iterations), where the box is checked.
* The host surface's flags at 12^3 on the CPU, one run each:
  ``--solver eigen`` (its ``step k: ... scheme=...`` line),
  ``--scheme all_dofs`` with it, ``--export-prefix`` (grids, components
  and stats), ``--export-mtx`` (MatrixMarket files instead of the npz) and
  ``--viz`` (the rendered sheet); ``--device`` defaults to the card.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polystokes_tpu.config import BasisOrder as JBasisOrder
from polystokes_tpu.config import PreconditionerType as JPC
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.config import SolverType as JSolverType
from polystokes_tpu.io import checkpoint as jck
from polystokes_tpu.scenes import builders as jbuilders

from polystokes_tpu_torch import convert, domain, run
from polystokes_tpu_torch.config import BasisOrder, PreconditionerType, SolverParams, SolverType
from polystokes_tpu_torch.io import checkpoint as tck
from polystokes_tpu_torch.scenes.builders import jelly_jam

torch.set_num_threads(1)


def _pairs():
    """Equal params in both packages (every value one the port runs)."""
    return [
        (JParams(dtype=jnp.float64, basis=JBasisOrder.AFFINE, tile_size=8, preconditioner=JPC.DIAGONAL, use_pallas=True),
         SolverParams(dtype=torch.float64, basis=BasisOrder.AFFINE, tile_size=8, preconditioner=PreconditionerType.DIAGONAL,
                      use_pallas=True)),
        (JParams(solver_type=JSolverType.MINRES, do_tile=False, max_regions=64, tolerance=1e-5, use_pallas=True,
                 preconditioner=JPC.CELL_ARROW, fuse_update=True, constant_density=1000.0),
         SolverParams(solver_type=SolverType.MINRES, do_tile=False, max_regions=64, tolerance=1e-5,
                      fuse_update=True, constant_density=1000.0, preconditioner=PreconditionerType.CELL_ARROW,
                      use_pallas=True)),
    ]


def test_params_json_round_trips_both_ways():
    for jp, tp in _pairs():
        assert convert.params_from_jax(jp) == tp
        text = tck.params_to_json(tp)
        assert text == jck.params_to_json(jp)
        assert jck.params_from_json(text) == jp and tck.params_from_json(jck.params_to_json(jp)) == tp
        assert tck.params_from_json(text) == tp
    base = _pairs()[0][1]
    over = tck.params_from_json('{"tolerance": 1e-6, "solver_type": "BICGSTAB", "dtype": "float32"}', base=base)
    assert over == base.replace(tolerance=1e-6, solver_type=SolverType.BICGSTAB, dtype=torch.float32)


def _assert_scenes_equal(a, b):
    for name in ("surface_sdf", "collision_sdf", "viscosity", "dt"):
        assert np.array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name))), name
    for name in ("velocity", "collision_velocity"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            assert np.array_equal(np.asarray(x), np.asarray(y)), name


def test_checkpoints_interchange(tmp_path):
    rng = np.random.default_rng(5)
    jp, tp = _pairs()[0]
    grid, scene = jbuilders.jelly_jam_si(n=12, dtype=jnp.float64)
    vel = tuple(jnp.asarray(rng.standard_normal(grid.face_shape(a))) for a in range(3))
    scene = dataclasses.replace(scene, velocity=vel)
    extra = {"frame": np.asarray(7), "seed": rng.standard_normal(4)}

    path_j = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path_j, grid, scene, jp, step_index=3, extra=extra)
    g, s, p, k, ex = tck.load_checkpoint(path_j, device="cpu")
    assert g == convert.grid_from_jax(grid) and p == tp and k == 3 and s.density is None
    assert s.velocity[0].device.type == "cpu" and s.velocity[0].dtype == torch.float64
    _assert_scenes_equal(s, scene)
    assert set(ex) == set(extra) and all(np.array_equal(ex[n], extra[n]) for n in extra)

    path_t = str(tmp_path / "sub" / "port.npz")
    tck.save_checkpoint(path_t, g, convert.scene_from_numpy(scene, "cpu"), tp, step_index=4, extra=extra)
    g2, s2, p2, k2, ex2 = jck.load_checkpoint(path_t)
    assert g2 == grid and p2 == jp and k2 == 4 and s2.density is None
    _assert_scenes_equal(s2, scene)
    # the port also writes the scene's density, which JAX's loader returns
    # among the extras (ROADMAP.md Queue 3 divergence 5)
    assert set(ex2) == set(extra) | {"scene_density"} and all(np.array_equal(ex2[n], extra[n]) for n in extra)
    assert np.array_equal(ex2["scene_density"], np.asarray(scene.density))
    with np.load(path_t) as dt_, np.load(path_j) as dj:
        assert sorted(dt_.files) == sorted(dj.files + ["extra_scene_density"])


def test_cli_modes_on_the_cpu(tmp_path, capsys, monkeypatch):
    ck = str(tmp_path / "ck.npz")
    small = ["--scene", "jelly_jam", "--n", "12", "--fp64", "--tile-size", "6", "--max-iterations", "300",
             "--tolerance", "1e-4", "--device", "cpu"]
    run.main(small + ["--steps", "1", "--checkpoint", ck])
    out = capsys.readouterr().out
    assert "step 0:" in out and "converged=True" in out and f"checkpoint written to {ck}" in out
    _, s, p, k, _ = tck.load_checkpoint(ck, device="cpu")
    assert k == 1 and p.dtype == torch.float64 and p.tile_size == 6 and p.preconditioner == PreconditionerType.IDENTITY
    assert not torch.equal(s.velocity[2], jelly_jam(n=12, dtype=torch.float64, device="cpu")[1].velocity[2])

    run.main(["--resume", ck, "--steps", "1", "--device", "cpu"])
    assert "step 1:" in capsys.readouterr().out

    run.main(small + ["--chunked", "--segment-iters", "40"])
    out = capsys.readouterr().out
    assert "segment done: iters=40" in out and "step 0:" in out and "interrupted=False" in out

    run.main(small + ["--sim", "--steps", "1"])
    out = capsys.readouterr().out
    assert "frame 0:" in out and "converged=True" in out

    boxes = []
    real = domain.solve_cropped

    def spy(*args, **kw):
        res = real(*args, **kw)
        boxes.append(res[2].get("crop"))
        return res

    monkeypatch.setattr(domain, "solve_cropped", spy)
    run.main(["--scene", "viscous_beam", "--n", "64", "--crop", "--device", "cpu", "--precond", "cell_arrow",
              "--max-iterations", "40", "--segment-iters", "20"])
    out = capsys.readouterr().out
    assert "step 0:" in out and "iters=40" in out and "interrupted=False" in out
    assert boxes == [{"lo": (0, 16, 32), "hi": (64, 48, 64), "res": (64, 32, 32)}]


_SMALL = ["--scene", "jelly_jam", "--n", "12", "--fp64", "--tile-size", "6", "--max-iterations", "300",
          "--tolerance", "1e-4", "--device", "cpu"]
# flag -> (extra flags, the step line's marker, files under the prefix)
_HOST_FLAGS = {
    "--solver": (["--solver", "eigen"], "scheme=pressure_stress", []),
    "--scheme": (["--solver", "eigen", "--scheme", "all_dofs"], "scheme=all_dofs", []),
    "--export-prefix": (["--export-prefix", "{p}"], "iters=", ["grids.npz", "components.npz", "stats.json"]),
    "--export-mtx": (["--export-prefix", "{p}", "--export-mtx"], "iters=",
                     ["grids.npz", "stats.json", "Mat_G.mtx", "Mat_Inv_Mr_plus_2JDtuDJ.mtx", "Vec_stressRHS.mtx"]),
    "--viz": (["--export-prefix", "{p}", "--viz"], "iters=", ["grids.npz", "grids_a2.png"]),
}


@pytest.mark.parametrize("flag", list(_HOST_FLAGS))
def test_host_surface_flags_run(flag, tmp_path, capsys):
    extra, marker, files = _HOST_FLAGS[flag]
    prefix = str(tmp_path / "out" / "x.")
    run.main(_SMALL + [a.replace("{p}", prefix) for a in extra])
    out = capsys.readouterr().out
    step_lines = [ln for ln in out.splitlines() if ln.startswith("step 0:")]
    assert len(step_lines) == 1 and "converged=True" in step_lines[0] and marker in step_lines[0], out
    for f in files:
        assert (tmp_path / "out" / f"x.{f}").exists(), f
    if files:
        assert f"exported to {prefix}*" in out
    if flag == "--export-mtx":
        assert not (tmp_path / "out" / "x.components.npz").exists()
    if flag == "--viz":
        assert f"rendered {prefix}grids_a2.png" in out
    if flag == "--export-prefix":
        with open(prefix + "stats.json") as f:
            stats = json.load(f)
        assert stats["converged"] == 1.0 and stats["iterations"] >= 1


def test_device_defaults_to_the_card():
    assert run.build_argparser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("flags", [["--bf16-coeffs", "--pallas"], ["--deflation"], ["--deflation", "--pallas"]],
                         ids=["bf16-pallas", "deflation", "deflation-pallas"])
def test_bf16_and_deflation_flags_run(flags, capsys):
    """--bf16-coeffs and --deflation reach SolverParams and the step runs and
    converges at 16^3 (tile 8, the deflation tile with it)."""
    run.main(["--scene", "jelly_jam", "--n", "16", "--fp64", "--tile-size", "8", "--max-iterations", "2000",
              "--tolerance", "1e-4", "--precond", "cell_arrow", "--device", "cpu"] + flags)
    out = capsys.readouterr().out
    assert "step 0:" in out and "converged=True" in out
