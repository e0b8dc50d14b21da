"""Whole runs on the CPU at smoke size, the look for a card skipped: a
cell and a metric added as new files only are picked up by name, and a
timed path broken underneath makes ``correct`` false."""
import json

import pytest

import harness
from conftest import DENSE

SEED = 2 ** 31 + 11
ONLINE = "granite-3-2b-smoke.score-online"
BACKLOG = "qwen2-72b-stage8-smoke.score-backlog"


def run(root, name, *, trace=False, build=None, seconds=1.5):
    cells = harness.Cells(root)
    return harness.run_cell(cells, name, seed=SEED, seconds=seconds,
                            trace=trace, device="cpu", t_start=0.0,
                            build=build)


def test_sound_runs_are_correct(root):
    out = run(root, ONLINE)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"latency_p50_ms", "setup_s"}
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    out = run(root, BACKLOG, trace=True)
    assert out["correct"], out["compared"]
    assert {"step.mfu.backlog", "device.idle_share.backlog"} <= \
        set(out["metrics"])
    assert list(out)[-1] == "compared" and "breakdown" in out
    assert out["device"]["window_s"] >= 1.5


def test_a_new_cell_and_metric_are_new_files_only(root):
    (root / "bench" / "traffic" / "dummy-mix.json").write_text(json.dumps({
        "loop": "open", "rate_rps": 8.0,
        "lengths": {"dist": "uniform", "min": 3, "max": 9},
        "ladder": {"lengths": [16], "batches": [1, 2]},
        "queue_depth": 16, "check": {"sample": 2}, "why": "dummy"}))
    (root / "bench" / "metrics" / "dummy.requests.py").write_text(
        "def read(win):\n    return float(len(win.completed()))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({
        "name": "dummy", "config": "granite-3-2b-smoke",
        "traffic": "dummy-mix", "chips": 1, "why": "dummy"})
    spec["per_layer"].append({
        "name": "dummy.requests", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "server",
        "moves": "tokens_per_s", "workloads": ["dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run(root, "dummy", trace=True, seconds=1.0)
    assert out["correct"]
    assert out["metrics"]["dummy.requests"]["value"] >= 1


def faulty(fault):
    """The dense ``system.build`` with the server's timed path broken:
    ``fault`` wraps each program call's output, or the tokens it packs."""
    def build(cfg, w, traffic):
        server = DENSE.system.build(cfg, w, traffic)
        call = server._call_program

        def broken(program, tokens):
            return fault(call, program, tokens)

        server._call_program = broken
        return server
    return build


def answer_altered(call, program, tokens):
    out = call(program, tokens).clone()
    out[:, 1] = out[:, 1].flip(-1)       # one position's logits, each row
    return out


def half_the_batch(call, program, tokens):
    out = call(program, tokens).clone()
    b = out.shape[0]
    if b > 1:
        out[b // 2:] = out[:b - b // 2]  # the rest copied from the first
    return out


def token_altered(call, program, tokens):
    tokens = tokens.clone()
    tokens[:, 0] = (tokens[:, 0] + 1) % 512
    return call(program, tokens)


# Half of a batch left out needs full buckets: the backlog cell's.
@pytest.mark.parametrize("cell,fault", [
    (ONLINE, answer_altered), (BACKLOG, answer_altered),
    (ONLINE, token_altered), (BACKLOG, token_altered),
    (BACKLOG, half_the_batch)], ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    out = run(root, cell, build=faulty(fault))
    assert not out["correct"], out["compared"]


def test_a_request_never_answered_is_not_correct(root):
    def build(cfg, w, traffic):
        server = DENSE.system.build(cfg, w, traffic)
        submit = server.submit

        def lose_first(tokens, **kw):
            fut = submit(tokens, **kw)
            if not getattr(server, "_lost", False):
                server._lost = True
                fut.set_exception = lambda exc: None
                fut.set_result = lambda row: None
            return fut

        server.submit = lose_first
        return server

    harness.DRAIN_S, old = 1.0, harness.DRAIN_S
    try:
        out = run(root, BACKLOG, build=build)
    finally:
        harness.DRAIN_S = old
    assert out["failed"] >= 1 and not out["correct"]
    assert out["compared"]["unanswered"]["value"] >= 1
