"""The port's serve and train CLIs with ``--trace-out`` / ``--metrics-out``
on the CPU at the smoke config, their files held to the reference's
trace-smoke requirements (``Makefile`` target ``trace-smoke``) by both
packages' validators, and the spans and events the runs must show."""
import collections
import json

import pytest

torch = pytest.importorskip("torch")

from repro.obs import validate as jvalidate  # noqa: E402
from repro_torch import engine, obs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.obs import validate as tvalidate  # noqa: E402

SERVE_CATS = ("plan", "cache", "dispatch", "serve")
SERVE_METRICS = ("plan_resolve_total", "plan_cache_events_total",
                 "serve_latency_us")


def _validate(trace, metrics, cats, names):
    assert jvalidate.validate_trace(trace, require_cats=cats) == []
    assert jvalidate.validate_metrics(metrics, require_names=names) == []
    assert tvalidate.main(["--trace", trace, "--require-cats",
                           ",".join(cats), "--metrics", metrics,
                           "--require-metrics", ",".join(names)]) == 0


def _names(path):
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    return collections.Counter(e["name"] for e in evs), evs


def _run(main, argv):
    # main() turns tracing on for the process; the scope restores it.
    with obs.tracing():
        assert main(argv) == 0


def test_serve_pruned_trace_and_metrics(tmp_path, capsys):
    engine.clear_cache()          # the patterns are new to this process
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    _run(serve.main, ["--smoke", "--batch", "2", "--prompt-len", "16",
                      "--prune-ffn", "0.25", "--device", "cpu",
                      "--trace-out", trace, "--metrics-out", metrics])
    out = capsys.readouterr().out
    assert "plans built during serving: 0" in out
    assert f"[serve] trace: {trace}" in out
    _validate(trace, metrics, SERVE_CATS, SERVE_METRICS)
    names, evs = _names(trace)
    matrices = 3 * get_smoke_config("llama3.2-1b").num_layers
    assert names["dispatch"] == 2 * matrices          # cold + warm forward
    for span in ("serve.plan", "serve.forward_cold", "serve.forward_warm"):
        (ev,) = [e for e in evs if e["name"] == span]
        assert ev["ph"] == "X" and ev["dur"] > 0 and ev["cat"] == "serve"
    # Every FFN pattern is built once and resolved once.
    assert names["plan.build"] == names["plan.resolve"] == \
        names["cache.miss"] == matrices
    with open(metrics) as f:
        fams = json.load(f)["metrics"]
    phases = {v["labels"]["phase"]
              for v in fams["serve_latency_us"]["values"]}
    assert {"plan", "cold", "warm"} <= phases
    assert "serve_replans_total" in fams and "plan_execute_total" in fams


def test_serve_online_trace(tmp_path, capsys):
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    _run(serve.main, ["--smoke", "--prune-ffn", "0.25", "--serve",
                      "--device", "cpu", "--serve-requests", "10",
                      "--trace-out", trace, "--metrics-out", metrics])
    assert "10/10 ok (0 shed, 0 error)" in capsys.readouterr().out
    _validate(trace, metrics, ("serve", "dispatch"),
              ("serve_requests_total", "plan_cache_events_total"))
    names, evs = _names(trace)
    assert names["serve.enqueue"] == 10
    assert names["serve.warmup"] == 1 and names["serve.shed"] == 0
    assert names["serve.execute"] == names["serve.batch"] == \
        names["serve.resolve"] >= 1
    assert names["serve.window"] == names["serve.idle"] >= 1
    fills = sum(e["args"]["fill"] for e in evs if e["name"] == "serve.batch")
    assert fills == 10
    enqueued = {e["args"]["rid"] for e in evs if e["name"] == "serve.enqueue"}
    called = [r for e in evs if e["name"] == "serve.batch"
              for r in e["args"]["rids"]]
    assert len(enqueued) == len(called) == 10
    assert enqueued == set(called)
    # The batcher thread emits the batch spans, the caller the enqueues.
    tids = {e["name"]: e["tid"] for e in evs}
    assert tids["serve.execute"] != tids["serve.enqueue"]


def test_serve_generate_trace(tmp_path):
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    _run(serve.main, ["--smoke", "--gen", "2", "--batch", "1",
                      "--prompt-len", "8", "--device", "cpu",
                      "--trace-out", trace, "--metrics-out", metrics])
    _validate(trace, metrics, ("serve",), ("serve_latency_us",))
    names, _ = _names(trace)
    assert names["serve.generate"] == 1


def test_train_trace_and_metrics(tmp_path, capsys):
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    _run(train.main, ["--smoke", "--steps", "2", "--global-batch", "2",
                      "--seq-len", "16", "--device", "cpu",
                      "--trace-out", trace, "--metrics-out", metrics])
    # each block's attention in its ``model`` span, run again by the
    # backward's recompute (per-block remat): 2 steps x 2 x the layers
    mixers = 2 * 2 * get_smoke_config("llama3.2-1b").num_layers
    out = capsys.readouterr().out
    assert f"[train] trace: {trace} ({2 + mixers} events)" in out
    _validate(trace, metrics, (), ("train_step_latency_us",))
    names, evs = _names(trace)
    assert names["train.step"] == 2 and names["attention"] == mixers
    steps = [e for e in evs if e["cat"] == "train"]
    assert [e["args"]["step"] for e in steps] == [0, 1]
    assert {e["cat"] for e in evs} == {"train", "model"}
