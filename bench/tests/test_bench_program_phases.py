"""The per-layer metrics read from the server's own phase clock and call
timer (``phases.py``): a ``--trace 1`` run of each smoke cell on the CPU
reports every one with a finite value, and the card's idle time that the
server holds (its host gap) and the calls' device time fit in the window
together."""
import json
import math

import pytest

import harness

SEED = 2 ** 31 + 29
NEW = {"online": ("serve.host_gap_share.online", "serve.batch_wait_ms.online",
                  "step.mfu_calls.online"),
       "backlog": ("serve.host_gap_share.backlog",
                   "step.mfu_calls.backlog")}
CELLS = ("granite-3-2b-smoke.score-online",
         "granite-3-2b-smoke.score-backlog",
         "qwen2-72b-stage8-smoke.score-backlog")


def with_device_share(root, cell):
    """The smoke root with one more metric in ``cell``: the calls' device
    time over the window, from ``phases.call_device_share``."""
    (root / "bench" / "metrics" / "calls.device_share.py").write_text(
        "from phases import call_device_share as read\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "calls.device_share", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "server",
        "moves": "tokens_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_program_phase_metrics(root, cell):
    with_device_share(root, cell)
    out = harness.run_cell(harness.Cells(root), cell, seed=SEED,
                           seconds=1.5, trace=True, device="cpu",
                           t_start=0.0)
    assert out["correct"], out["compared"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    kind = cell.rsplit("-", 1)[-1]
    for name in NEW[kind]:
        assert name in m and math.isfinite(m[name]) and m[name] >= 0, name
    assert m["calls.device_share"] > 0
    gap = m[f"serve.host_gap_share.{kind}"]
    assert gap + m["calls.device_share"] <= 101.0
