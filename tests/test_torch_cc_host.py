"""The port's host connected components (``SolverParams.cc_host_callback``,
``classify.connected_components_host`` with its own native union-find and
the scipy form) against the JAX package's on the CPU, with the JAX side
run once in a module-scoped fixture:

* untiled classification of honey_coil 16^3 (fp64, max_regions 64): the
  port with the host union-find (native, then the scipy form) against
  JAX's ``cc_host_callback=True`` and against the port's device
  propagation, region partitions equal up to relabeling, the same
  ``n_regions`` and the same labels;
* the raw labels of a synthetic grid with a zero-weight interior face
  (``_numpy_cc``'s union-find branch): the port's native library bit-equal
  to JAX's, the scipy form equal to JAX's ``_numpy_cc``, all of them and
  the device propagation the same partition;
* an untiled packed step with ``cc_host_callback=True`` equal to the
  step without it, at a fixed 60 iterations.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from polystokes_tpu import classify as jclassify
from polystokes_tpu.config import SolverParams as JParams
from polystokes_tpu.native import connected_components_host as j_native_cc
from polystokes_tpu.scenes import builders as jbuilders
from polystokes_tpu.weights import compute_weights as j_weights

from polystokes_tpu_torch import PreconditionerType, SolverParams, classify, convert, native, solver, step
from polystokes_tpu_torch.classify import REDUCED

torch.set_num_threads(1)

N = 16


def _same_partition(a, b):
    """Equal support, and the joint labelling a bijection."""
    a, b = np.asarray(a), np.asarray(b)
    assert ((a >= 0) == (b >= 0)).all()
    m = a >= 0
    pairs = set(zip(a[m].ravel().tolist(), b[m].ravel().tolist()))
    assert len(pairs) == len(set(a[m].ravel().tolist())) == len(set(b[m].ravel().tolist()))
    return len(pairs)


def _synthetic(seed=1):
    """Random REDUCED cells in a 10 x 9 x 8 grid (x >= 3) and an isolated
    bar of them along z at x = 1, y = 2, cut in two by one zero-weight face
    (scipy's 6-connectivity would join what the union-find keeps apart)."""
    rng = np.random.default_rng(seed)
    shape = (10, 9, 8)
    labels = np.where(rng.random(shape) < 0.7, REDUCED, 3).astype(np.int8)
    labels[:3] = 3
    labels[1, 2, 1:7] = REDUCED
    fw = [rng.uniform(0.2, 1.0, tuple(s + (i == a) for i, s in enumerate(shape))) for a in range(3)]
    fw[2][1, 2, 4] = 0.0  # between cells (1, 2, 3) and (1, 2, 4)
    return labels, [f.astype(np.float32) for f in fw]


@pytest.fixture(scope="module")
def ref():
    grid, scene = jbuilders.honey_coil(n=N, dtype=jnp.float64)
    jp = JParams(dtype=jnp.float64, do_tile=False, max_regions=64, cc_host_callback=True)
    cls = jax.jit(lambda sc: jclassify.classify(grid, *j_weights(grid, sc.surface_sdf, sc.collision_sdf, jnp.float64),
                                                jp))(scene)
    labels, fws = _synthetic()
    return {"grid": grid, "scene": scene, "params": jp, "cls": cls,
            "native": j_native_cc(labels, *fws)[0], "numpy": jclassify._numpy_cc(labels, *fws)}


def _port_classify(ref, **kw):
    grid, scene = convert.grid_from_jax(ref["grid"]), convert.scene_from_numpy(ref["scene"], "cpu")
    params = convert.params_from_jax(ref["params"]).replace(**kw)
    return classify.classify(grid, *solver._weights(grid, scene, params), params)


@pytest.mark.parametrize("form", ["native", "scipy"])
def test_host_cc_classify_matches_jax(ref, form, monkeypatch):
    if form == "scipy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None  # the native form: g++ builds the union-find
    got = _port_classify(ref)
    dev = _port_classify(ref, cc_host_callback=False)
    want = ref["cls"]
    n = int(want.n_regions)
    assert n >= 1 and int(got.n_regions) == int(dev.n_regions) == n
    assert _same_partition(got.cell_region.numpy(), np.asarray(want.cell_region)) == n
    assert _same_partition(got.cell_region.numpy(), dev.cell_region.numpy()) == n
    np.testing.assert_array_equal(got.cell_labels.numpy(), np.asarray(want.cell_labels))
    np.testing.assert_array_equal(got.cell_labels.numpy(), dev.cell_labels.numpy())
    for a in range(3):
        np.testing.assert_array_equal(got.face_labels[a].numpy(), np.asarray(want.face_labels[a]))


def test_union_find_on_a_zero_weight_face(ref):
    labels, fws = _synthetic()
    t_labels = torch.from_numpy(labels)
    got_native, count = native.connected_components_host(labels, *fws)
    np.testing.assert_array_equal(got_native, ref["native"])  # the same algorithm, bit for bit
    got_numpy = classify._numpy_cc(labels, *fws)
    np.testing.assert_array_equal(got_numpy, ref["numpy"])
    liquid_w = {f"face{a}": torch.from_numpy(fws[a]) for a in range(3)}
    dev = classify.connected_components(t_labels, liquid_w, sum(labels.shape)).numpy()
    host = classify.connected_components_host(t_labels, liquid_w).numpy()
    assert count == _same_partition(got_native, got_numpy) == _same_partition(got_native, dev) >= 3
    np.testing.assert_array_equal(host, got_native)
    # the cut face splits what full 6-connectivity joins
    assert got_native[1, 2, 3] != got_native[1, 2, 4]
    assert got_native[1, 2, 1] == got_native[1, 2, 3] and got_native[1, 2, 4] == got_native[1, 2, 6]


def test_native_library_builds_into_build_dir():
    path = native.build()
    assert path is not None and path.exists()
    assert path.parent.parent.name == "polystokes_tpu_torch" and path.parent.parent.parent.name == "build"


def test_host_cc_step_equals_device_cc_step(ref):
    """The same regions give the same solve: 60 iterations of each step."""
    grid, scene = convert.grid_from_jax(ref["grid"]), convert.scene_from_numpy(ref["scene"], "cpu")
    p = SolverParams(dtype=torch.float64, do_tile=False, tile_size=8, max_regions=64, max_iterations=60,
                     preconditioner=PreconditionerType.CELL_ARROW, use_pallas=True, bicgstab_fallback=False)
    v_dev, _, s_dev = step(grid, scene, p)
    v_host, _, s_host = step(grid, scene, p.replace(cc_host_callback=True))
    assert s_host["iterations"] == s_dev["iterations"] == 60 and s_host["n_regions"] == s_dev["n_regions"] >= 1
    assert abs(s_host["error"] - s_dev["error"]) <= 1e-10 * s_dev["error"]
    vmax = max(float(v.abs().max()) for v in v_dev)
    for a, b in zip(v_host, v_dev):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10 * vmax)
