"""The port's slice renderer (``polystokes_tpu_torch.viz``) against the JAX
package's on the CPU: the grids of the solid case of
``tests/test_torch_export.py`` (the port's classification and weights on
the CPU, written by the port's ``export_grids``) rendered by both
packages:

* the contact sheet and ``per_grid`` (with a ``names`` filter and another
  axis and index): the same file names, and pixel arrays equal
  (``matplotlib.image.imread``);
* ``python -m polystokes_tpu_torch.viz`` (``main``) prints the files it
  writes; an npz without 3-D grids raises as JAX's does;
* without matplotlib (as on a machine that lacks it) ``render_npz`` writes
  the same files through its plain PNG writer.
"""
import sys

import numpy as np
import pytest

from matplotlib.image import imread

from polystokes_tpu import viz as jviz

from polystokes_tpu_torch import classify, convert, solver, viz
from polystokes_tpu_torch import export as tex

from test_operators import make_case
from test_torch_export import CASES


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    grid, params, scene = make_case(**CASES["solid"])
    tg, ts, tp = convert.grid_from_jax(grid), convert.scene_from_numpy(scene, "cpu"), convert.params_from_jax(params)
    lw, fw = solver._weights(tg, ts, tp)
    prefix = str(tmp_path_factory.mktemp("grids") / "run.")
    tex.export_grids(prefix, classify.classify(tg, lw, fw, tp), lw, fw)
    return prefix + "grids.npz"


def _names(paths):
    return [p.rsplit("/", 1)[1] for p in paths]


@pytest.mark.parametrize("kw", [{}, dict(per_grid=True, names=["cell_", "fluid_face2"], axis=0, index=3)],
                         ids=["sheet", "per_grid"])
def test_render_matches_jax_pixel_for_pixel(grids, tmp_path, kw):
    got = viz.render_npz(grids, str(tmp_path / "port"), **kw)
    ref = jviz.render_npz(grids, str(tmp_path / "jax"), **kw)
    assert _names(got) == _names(ref) and len(got) == (3 if kw else 1)
    for a, b in zip(got, ref):
        assert np.array_equal(imread(a), imread(b)), a


def test_main_prints_the_files_and_refuses_an_npz_without_grids(grids, tmp_path, capsys):
    viz.main([grids, "--out", str(tmp_path), "--axis", "1", "--grids", "cell_labels", "--per-grid"])
    assert capsys.readouterr().out.split() == [str(tmp_path / "run.grids_cell_labels_a1.png")]
    flat = str(tmp_path / "flat.npz")
    np.savez(flat, pressure=np.zeros(4))
    for mod in (viz, jviz):
        with pytest.raises(ValueError, match="no 3-D grids"):
            mod.render_npz(flat)


@pytest.mark.parametrize("per_grid", [False, True])
def test_render_without_matplotlib(grids, tmp_path, monkeypatch, per_grid):
    ref = viz.render_npz(grids, str(tmp_path / "mpl"), names=["_region", "liquid_center"], per_grid=per_grid)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises ImportError
    got = viz.render_npz(grids, str(tmp_path / "plain"), names=["_region", "liquid_center"], per_grid=per_grid)
    assert _names(got) == _names(ref)
    monkeypatch.undo()
    for f in got:
        img = imread(f)
        assert img.ndim == 3 and img.shape[2] == 3 and min(img.shape[:2]) >= 32
        assert 0.0 <= img.min() and img.max() <= 1.0 and img.std() > 0
