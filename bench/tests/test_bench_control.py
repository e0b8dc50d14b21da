"""The control of the correctness check: the reference one precision step
below the configuration's, in the program's place, has to fail the
cell's limits.  On the CPU at smoke size with the committed limits; on
the card (``-m cuda``) at each cell's own size."""
import json

import pytest
import torch

import control
import harness
from conftest import ROOT

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["granite-3-2b-smoke.score-online",
                                  "qwen2-72b-stage8-smoke.score-backlog"])
def test_control_fails_at_smoke_size(root, cell, seed):
    cells = harness.Cells(root)
    got = control.control_numbers(cells, cell, seed, 2.0, "cpu")
    assert not got["passes"], got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell's own size")
    cells = harness.Cells(ROOT)
    got = control.control_numbers(cells, cell, SEEDS[0],
                                  cells.spec["run_seconds"], "cuda")
    assert not got["passes"], got


def test_the_f32_points_alone_lower_less_than_the_control(root):
    cells = harness.Cells(root)
    cell = "granite-3-2b-smoke.score-online"
    full = control.control_numbers(cells, cell, SEEDS[0], 2.0, "cpu")
    f32 = control.control_numbers(cells, cell, SEEDS[0], 2.0, "cpu", "f32")
    err = lambda got: got["compared"]["logit_err"]["value"]
    assert f32["points"] == "f32"
    assert 0 < err(f32) < err(full)
