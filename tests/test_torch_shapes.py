"""The port's input-shape cells and training config against the
reference's (``repro.configs``): ``SHAPES``, ``TrainConfig``,
``SUBQUADRATIC`` and ``shape_cells`` for every arch, and the dry run's
shape-only inputs (``launch.specs``) against the reference's
``launch.specs`` on every cell of one arch."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jc  # noqa: E402
import repro_torch.configs as tc  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402


def test_shape_cells_match_reference():
    assert set(tc.SHAPES) == set(jc.SHAPES)
    for name, shp in jc.SHAPES.items():
        assert dataclasses.asdict(tc.SHAPES[name]) == dataclasses.asdict(shp)
    assert tc.SUBQUADRATIC == jc.SUBQUADRATIC
    assert tc.ARCHS == jc.ARCHS
    for arch in jc.ARCHS:
        assert tc.shape_cells(arch) == jc.shape_cells(arch), arch


def test_train_config_matches_reference():
    assert dataclasses.asdict(tc.TrainConfig()) == \
        dataclasses.asdict(jc.TrainConfig())
    assert [f.name for f in dataclasses.fields(tc.TrainConfig)] == \
        [f.name for f in dataclasses.fields(jc.TrainConfig)]


@pytest.mark.parametrize("shape", list(jc.SHAPES))
def test_input_specs_match_reference(shape):
    """Every stand-in's shape equals the reference's (a per-layer leaf
    its stacked leaf without the layer axis); dtypes equal but the
    integer inputs, int64 in the port."""
    arch = "recurrentgemma-2b"     # attention, RG-LRU and MLP blocks
    want = jspecs.input_specs(arch, shape, microbatches=4 if shape ==
                              "train_4k" else 1)
    got = tspecs.input_specs(arch, shape, microbatches=4 if shape ==
                             "train_4k" else 1)
    assert list(got) == list(want)
    for key, b in want["batch"].items():
        g = got["batch"][key]
        assert g.device.type == "meta" and tuple(g.shape) == b.shape
    cfg = tc.get_config(arch)
    stacked = jax.tree.leaves(want.get("state", want).get("params")
                              if "state" in want else want["params"])
    params = got["state"]["params"] if "state" in got else got["params"]
    n_layers = cfg.num_layers
    got_numel = sum(x.numel() for x in jax.tree.leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    want_numel = sum(int(x.size) for x in stacked)
    assert got_numel == want_numel
    if "caches" in want:
        ref = {tuple(x.shape[1:]) for x in jax.tree.leaves(want["caches"])}
        port = {tuple(x.shape) for c in got["caches"] for x in c.values()}
        assert port == ref
        assert len(got["caches"]) == n_layers
