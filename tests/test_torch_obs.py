"""The port's observability (``repro_torch.obs``) against the reference's
``repro.obs``: the same call sequence traced in both packages, the plan
cache's and the engine's counters after it (5 gets of one pattern resolve
once), every roofline function and the accountant's rows and report, the
roof calibration on the CPU, the trace/metrics validators' problem lists,
the disabled path and concurrent spans.  Inputs come from numpy seeds."""
import collections
import json
import os
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import Epilogue as JEpilogue  # noqa: E402
from repro.core import ExecutionConfig as JExec  # noqa: E402
from repro.core import PlanPolicy as JPlanPolicy  # noqa: E402
from repro.core import csr as jcsr  # noqa: E402
from repro.core.plan import build_plan as jbuild_plan  # noqa: E402
from repro.core.spmm import execute_plan as jexecute  # noqa: E402
from repro.engine import PlanCache as JPlanCache  # noqa: E402
from repro.obs import roofline as jroof  # noqa: E402
from repro.obs import validate as jvalidate  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.core import Epilogue, ExecutionConfig, PlanPolicy  # noqa: E402
from repro_torch.core.plan import build_plan  # noqa: E402
from repro_torch.core.spmm import execute_plan  # noqa: E402
from repro_torch.engine import PlanCache  # noqa: E402
from repro_torch.obs import roofline as troof  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.obs import validate as tvalidate  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# (m, k, nnz_per_row, pad): irregular rows, a padded tail, a regular one.
PATTERNS = {"irregular": (41, 96, (1, 17), 8),
            "regular": (64, 48, 6, 0)}


def _pair(kind, seed=0):
    """The same random CSR in both packages (JAX draws, port converts)."""
    m, k, npr, pad = PATTERNS[kind]
    key = jax.random.PRNGKey(seed)
    ja = jcsr.random_csr(key, m, k, nnz_per_row=npr)
    if pad:
        ja = jcsr.random_csr(key, m, k, nnz_per_row=npr,
                             pad_to=int(ja.row_ptr[-1]) + pad)
    ta = convert.csr_from_numpy(np.asarray(ja.row_ptr),
                                np.asarray(ja.col_ind),
                                np.asarray(ja.vals), ja.shape, device="cpu")
    return ja, ta


def _operands(a_shape, n=12, seed=3):
    rng = np.random.default_rng(seed)
    m, k = a_shape
    return (rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal(m).astype(np.float32))


def _counts(registry, name, keep=lambda labels: True, by=None):
    fam = registry.get(name)
    if fam is None:
        return {}
    out = collections.Counter()
    for c in fam.children():
        if keep(c.labels):
            key = tuple(c.labels[k] for k in by) if by else \
                tuple(sorted(c.labels.items()))
            out[key] += c.value
    return out


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _run_ref(ja, b, bias, gets):
    cache = JPlanCache()
    pol = JPlanPolicy()
    pol.resolve(ja)
    plan = None
    for _ in range(gets):
        plan = cache.get(ja, pol)
    out = jexecute(plan, ja.vals, b, JExec(
        impl="xla", epilogue=JEpilogue(bias=True, activation="relu")),
        bias=bias)
    return cache, plan, np.asarray(out)


def _run_port(ta, b, bias, gets):
    cache = PlanCache()
    pol = PlanPolicy()
    pol.resolve(ta)
    plan = None
    for _ in range(gets):
        plan = cache.get(ta, pol)
    out = execute_plan(plan, ta.vals, torch.from_numpy(b), ExecutionConfig(
        epilogue=Epilogue(bias=True, activation="relu")),
        bias=torch.from_numpy(bias))
    return cache, plan, out.numpy()


def _sequence_both(kind, gets):
    """One call sequence traced in each package: resolve, ``gets`` cache
    gets, then ``execute_plan`` with a bias+relu epilogue."""
    ja, ta = _pair(kind)
    b, bias = _operands(ta.shape)
    with jobs.tracing() as jtr:
        jcache, jplan, jout = _run_ref(ja, b, bias, gets)
    with obs.tracing() as ttr:
        tcache, tplan, tout = _run_port(ta, b, bias, gets)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    return (jtr, jcache, jplan), (ttr, tcache, tplan)


def _multiset(tracer):
    return collections.Counter((e["cat"], e["name"])
                               for e in tracer.events())


# ------------------------------------------------------------------ trace ---


@pytest.mark.parametrize("kind", sorted(PATTERNS))
def test_trace_matches_reference(kind):
    (jtr, _, _), (ttr, _, _) = _sequence_both(kind, gets=2)
    assert _multiset(ttr) == _multiset(jtr)
    assert _multiset(ttr) == collections.Counter({
        ("plan", "plan.resolve"): 2, ("cache", "cache.miss"): 1,
        ("plan", "plan.build"): 1, ("cache", "cache.hit"): 1,
        ("dispatch", "dispatch"): 1})
    for name in ("plan.resolve", "plan.build"):
        assert [e["args"] for e in ttr.events(name=name)] == \
            [e["args"] for e in jtr.events(name=name)], name
    (jd,), (td,) = jtr.events(name="dispatch"), ttr.events(name="dispatch")
    assert (jd["args"]["impl"], td["args"]["impl"]) == ("xla", "torch")
    shared = set(jd["args"]) & set(td["args"]) - {"impl"}
    assert set(td["args"]) - {"impl"} <= shared   # tk: reference only
    assert {k: td["args"][k] for k in shared} == \
        {k: jd["args"][k] for k in shared}
    hit_args = [{k: v for k, v in e["args"].items() if k != "cache"}
                for e in ttr.events(name="cache.hit")]
    assert hit_args == [{k: v for k, v in e["args"].items() if k != "cache"}
                        for e in jtr.events(name="cache.hit")]
    assert hit_args == [{"alias": True, "method": td["args"]["method"]}]
    for e in ttr.events():
        assert e["tid"] == threading.get_ident() and e["pid"] == os.getpid()
        json.dumps(e)                     # plain Python values only


def test_inline_dispatch_matches_reference():
    from repro.core import spmm as jspmm
    from repro_torch.core import spmm as tspmm
    ja, ta = _pair("irregular")
    b, _ = _operands(ta.shape)
    with jobs.tracing() as jtr:
        jspmm(ja, b, JPlanPolicy(method="rowsplit"), JExec(impl="xla"),
              plan="inline")
    with obs.tracing() as ttr:
        tspmm(ta, torch.from_numpy(b), PlanPolicy(method="rowsplit"),
              plan="inline")
    (jd,), (td,) = jtr.events(name="dispatch"), ttr.events(name="dispatch")
    assert {k: v for k, v in td["args"].items() if k != "impl"} == \
        {k: v for k, v in jd["args"].items() if k not in ("impl", "tk")}
    assert td["args"]["inline"] is True


# --------------------------------------------------------------- counters ---


@pytest.mark.parametrize("kind", sorted(PATTERNS))
def test_counters_match_reference_five_gets_one_resolve(kind):
    """The plan-cache fault's regression test: 5 gets of one pattern with
    ``PlanPolicy()`` resolve once in both packages (the raw-request alias
    map answers the repeats); the cache's events and the per-plan execute
    counts agree."""
    jres = _counts(jobs.registry, "plan_resolve_total", by=("rung",
                                                           "method"))
    tres = _counts(obs.registry, "plan_resolve_total", by=("rung",
                                                          "method"))
    jexe = _counts(jobs.registry, "plan_execute_total", by=("plan",))
    texe = _counts(obs.registry, "plan_execute_total", by=("plan",))
    (_, jcache, _), (_, tcache, _) = _sequence_both(kind, gets=5)
    # The sequence's own PlanPolicy.resolve, then the first get's.
    jd = _delta(_counts(jobs.registry, "plan_resolve_total",
                        by=("rung", "method")), jres)
    td = _delta(_counts(obs.registry, "plan_resolve_total",
                        by=("rung", "method")), tres)
    assert td == jd and sum(td.values()) == 2
    for cache, reg in ((jcache, jobs.registry), (tcache, obs.registry)):
        ev = _counts(reg, "plan_cache_events_total",
                     keep=lambda lb, n=cache.name: lb["cache"] == n,
                     by=("event",))
        assert {k: v for k, v in ev.items() if v} == \
            {("hit",): 4, ("miss",): 1}
    assert tcache.stats().__dict__ == jcache.stats().__dict__
    assert _delta(_counts(obs.registry, "plan_execute_total",
                          by=("plan",)), texe) == \
        _delta(_counts(jobs.registry, "plan_execute_total", by=("plan",)),
               jexe)
    for name, cache in (("plan_cache_size", tcache),
                        ("plan_cache_aliases", tcache)):
        (child,) = [c for c in obs.registry.get(name).children()
                    if c.labels["cache"] == cache.name]
        assert child.value == 1


def test_alias_key_holds_tunedb_digest():
    """Swapping the TuneDB misses the alias map: the request resolves
    against the new DB, never from the old one's plan."""
    from repro_torch.tune.db import TuneDB
    _, ta = _pair("regular")
    cache = PlanCache()
    first = cache.get(ta, PlanPolicy(tunedb=TuneDB(backend="a")))
    db = TuneDB(backend="b")
    db.threshold = 0.5                  # picks differently: a new digest
    before = _counts(obs.registry, "plan_resolve_total", by=("rung",))
    second = cache.get(ta, PlanPolicy(tunedb=db))
    assert _delta(_counts(obs.registry, "plan_resolve_total",
                          by=("rung",)), before) == {("calibrated",): 1}
    again = cache.get(ta, PlanPolicy(tunedb=db))
    assert again is second
    assert cache.stats().aliases == 2
    assert first.meta.method in ("merge", "rowsplit")


def test_alias_map_is_bounded():
    """Cycling distinct raw requests (new heuristic thresholds, one plan)
    keeps the alias map at 4 entries a plan slot in both packages; the
    overflow is counted as alias evictions and the fast path still hits."""
    from repro.core import Heuristic as JHeuristic
    from repro_torch.core import Heuristic
    ja, ta = _pair("regular")
    jcache, tcache = JPlanCache(maxsize=4), PlanCache(maxsize=4)
    for i in range(50):
        jcache.get(ja, JPlanPolicy(heuristic=JHeuristic(threshold=100. + i)))
        tcache.get(ta, PlanPolicy(heuristic=Heuristic(threshold=100. + i)))
    s = tcache.stats()
    assert (s.misses, s.hits, s.size) == (1, 49, 1)
    assert s.aliases == len(tcache._aliases) == 16
    assert s.alias_evictions == 50 - 16
    assert s.__dict__ == jcache.stats().__dict__
    tcache.get(ta, PlanPolicy(heuristic=Heuristic(threshold=149.)))
    assert tcache.stats().hits == 50


def test_execute_counter_gated_on_tracing():
    _, ta = _pair("regular")
    b, _ = _operands(ta.shape)
    plan = PlanCache().get(ta)
    label = f"{plan.meta.method}:{ta.m}x{ta.k}:nnz{ta.nnz_pad}"
    before = _counts(obs.registry, "plan_execute_total", by=("plan",))
    execute_plan(plan, ta.vals, torch.from_numpy(b))
    assert _delta(_counts(obs.registry, "plan_execute_total",
                          by=("plan",)), before) == {}
    with obs.tracing():
        execute_plan(plan, ta.vals, torch.from_numpy(b))
    assert _delta(_counts(obs.registry, "plan_execute_total",
                          by=("plan",)), before) == {(label,): 1}


# --------------------------------------------------------------- roofline ---


DTYPES = ("float32", "bfloat16", "float16", "float64")


def _metas():
    ja, ta = _pair("irregular")
    out = []
    for method in ("merge", "rowsplit", "rowgroup"):
        jm = jbuild_plan(ja, method=method).meta
        tm = build_plan(ta, PlanPolicy(method=method)).meta
        assert (jm.shape, jm.nnz_pad, jm.method) == \
            (tm.shape, tm.nnz_pad, tm.method)
        out.append((jm, tm))
    return out


@pytest.mark.parametrize("val_dtype", DTYPES)
def test_roofline_models_match_reference(val_dtype):
    for jm, tm in _metas():
        for n in (1, 12, 128):
            for batch in (1, 3):
                for out_dtype in (None, "float32", "bfloat16"):
                    for b_dtype in (None, "float32", "bfloat16"):
                        for flags in ((False, False), (True, False),
                                      (True, True), None):
                            jep = tep = None
                            if flags is not None:
                                jep = JEpilogue(bias=flags[0],
                                                residual=flags[1])
                                tep = Epilogue(bias=flags[0],
                                               residual=flags[1])
                            kw = dict(val_dtype=val_dtype,
                                      out_dtype=out_dtype, batch=batch,
                                      b_dtype=b_dtype)
                            assert troof.plan_min_bytes(
                                tm, n, epilogue=tep, **kw) == \
                                jroof.plan_min_bytes(jm, n, epilogue=jep,
                                                     **kw)
                    for b_dtype in (None, "bfloat16"):
                        assert troof.plan_bwd_min_bytes(
                            tm, n, val_dtype=val_dtype, b_dtype=b_dtype,
                            batch=batch) == jroof.plan_bwd_min_bytes(
                            jm, n, val_dtype=val_dtype, b_dtype=b_dtype,
                            batch=batch)
    rng = np.random.default_rng(5)
    for _ in range(40):
        m, k, n, nnz = (int(x) for x in rng.integers(1, 5000, 4))
        vb, ib, ob = (int(x) for x in rng.choice([2, 4, 8], 3))
        assert troof.spmm_min_bytes(m, k, n, nnz, val_bytes=vb,
                                    idx_bytes=ib, out_bytes=ob) == \
            jroof.spmm_min_bytes(m, k, n, nnz, val_bytes=vb, idx_bytes=ib,
                                 out_bytes=ob)
        for bias in (False, True):
            for res in (False, True):
                assert troof.epilogue_tail_bytes(
                    m, n, out_bytes=ob, bias=bias, residual=res) == \
                    jroof.epilogue_tail_bytes(m, n, out_bytes=ob,
                                              bias=bias, residual=res)
                assert troof.fused_epilogue_ceiling(
                    m, k, n, nnz, val_bytes=vb, out_bytes=ob, bias=bias,
                    residual=res) == jroof.fused_epilogue_ceiling(
                    m, k, n, nnz, val_bytes=vb, out_bytes=ob, bias=bias,
                    residual=res)
        for dc in DTYPES:
            assert troof.sddmm_min_bytes(
                nnz, m, k, n, batch=2, dc_dtype=dc, b_dtype=val_dtype) == \
                jroof.sddmm_min_bytes(nnz, m, k, n, batch=2, dc_dtype=dc,
                                      b_dtype=val_dtype)
        assert troof.spmm_flops(nnz, n) == jroof.spmm_flops(nnz, n)


def test_accountant_rows_and_report_match_reference():
    jacc, tacc = jroof.RooflineAccountant(), troof.RooflineAccountant()
    rng = np.random.default_rng(9)
    for jm, tm in _metas():
        for _ in range(3):
            n = int(rng.integers(1, 256))
            wall = float(rng.uniform(1.0, 900.0))
            calls = int(rng.integers(1, 5))
            for dt in ("float32", "bfloat16"):
                jacc.account_plan(jm, n, wall_us=wall, impl="cuda",
                                  val_dtype=dt, calls=calls)
                tacc.account_plan(tm, n, wall_us=wall, impl="cuda",
                                  val_dtype=dt, calls=calls)
    for acc in (jacc, tacc):
        acc.record(("moe", "grouped_gemm", "cuda", "bfloat16"),
                   wall_us=304.0, min_bytes=1.5e8, flops=3e11)
        acc.record(("sddmm", "sddmm", "cuda", "float32"), wall_us=540.0,
                   min_bytes=2.4e8, calls=3)
    jr = jroof.Roof("cuda:H100", 3.0e12, 1 << 26, "measured")
    tr = troof.Roof("cuda:H100", 3.0e12, 1 << 26, "measured")
    for jroof_, troof_ in ((None, None), (jr, tr)):
        assert tacc.rows(troof_) == jacc.rows(jroof_)
        assert tacc.report(troof_) == jacc.report(jroof_)
    assert len(tacc) == len(jacc) == 8
    assert "% of roof" in tacc.report(tr)
    tacc.reset()
    assert tacc.report() == jroof.RooflineAccountant().report() == \
        "roofline: no executions recorded"


def test_obs_report_combines_legs():
    PlanPolicy().resolve(_pair("regular")[1])       # a ladder rung to rate
    obs.accountant.reset()
    try:
        obs.accountant.record(("spmm", "rowsplit", "cuda", "float32"),
                              wall_us=10.0, min_bytes=3.0e7)
        roof = troof.Roof("cpu", 1.0e10, 1 << 16, "measured")
        with obs.tracing():
            obs.event("x", cat="serve")
            text = obs.report(roof=roof)
    finally:
        obs.accountant.reset()
    assert "== resolution ladder ==" in text
    assert "== metrics ==" in text and "plan_resolve_total" in text
    assert "spmm rowsplit/cuda float32: 3000.00 GB/s achieved = " \
        "30000.0% of roof" in text
    assert text.endswith("== trace == 1 events buffered")


def test_measure_roof_on_cpu_measured_cached_forced(tmp_path):
    troof.clear_roof_memo()
    try:
        kw = dict(cache_dir=str(tmp_path), elements=1 << 14, repeat=2,
                  device="cpu")
        first = troof.measure_roof(**kw)
        assert (first.backend, first.source, first.elements) == \
            ("cpu", "measured", 1 << 14)
        assert first.bytes_per_s > 0 and first.gb_per_s == \
            first.bytes_per_s / 1e9
        assert troof.measure_roof(**kw) is first          # in-process memo
        troof.clear_roof_memo()
        cached = troof.measure_roof(**kw)
        assert cached.source == "cached"
        assert cached.bytes_per_s == first.bytes_per_s
        with open(tmp_path / "roofline_roof_torch.json") as f:
            data = json.load(f)
        assert set(data) == {"cpu"} and data["cpu"]["elements"] == 1 << 14
        forced = troof.measure_roof(force=True, **kw)
        assert forced.source == "measured"
        assert not (tmp_path / "roofline_roof.json").exists()
    finally:
        troof.clear_roof_memo()
    assert troof.DEFAULT_ELEMENTS == {"cuda": 1 << 26, "cpu": 1 << 24}


def test_measure_roof_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        troof.measure_roof(cache_dir=None)


# ------------------------------------------------------------- validation ---


BAD_TRACES = {
    "not_json": "{nope",
    "no_events": json.dumps({"foo": 1}),
    "events_not_list": json.dumps({"traceEvents": {"a": 1}}),
    "too_few": json.dumps({"traceEvents": []}),
    "bad_event": json.dumps({"traceEvents": [
        3, {"name": "a", "ph": "X", "ts": 1, "pid": 1, "tid": 2},
        {"ph": "i", "cat": "plan"}]}),
    "missing_cat": json.dumps({"traceEvents": [
        {"name": "a", "cat": "plan", "ph": "X", "ts": 1, "dur": 2,
         "pid": 1, "tid": 2}]}),
}
BAD_METRICS = {
    "not_json": "[1,",
    "bad_schema": json.dumps({"schema": 2, "metrics": {"a": {}}}),
    "empty": json.dumps({"schema": 1, "metrics": {}}),
    "malformed": json.dumps({"schema": 1, "metrics": {
        "a": {"type": "counter"}, "b": 3}}),
    "missing_name": json.dumps({"schema": 1, "metrics": {
        "a": {"type": "counter", "values": []}}}),
}


@pytest.mark.parametrize("case", sorted(BAD_TRACES))
def test_validate_trace_problems_match_reference(case, tmp_path):
    path = tmp_path / f"{case}.json"
    path.write_text(BAD_TRACES[case])
    kw = dict(require_cats=("plan", "dispatch"), min_events=2)
    want = jvalidate.validate_trace(str(path), **kw)
    assert want
    assert tvalidate.validate_trace(str(path), **kw) == want


@pytest.mark.parametrize("case", sorted(BAD_METRICS))
def test_validate_metrics_problems_match_reference(case, tmp_path):
    path = tmp_path / f"{case}.json"
    path.write_text(BAD_METRICS[case])
    kw = dict(require_names=("plan_resolve_total",))
    want = jvalidate.validate_metrics(str(path), **kw)
    assert want
    assert tvalidate.validate_metrics(str(path), **kw) == want


def test_port_trace_passes_reference_validator(tmp_path, capsys):
    (_, _, _), (ttr, _, _) = _sequence_both("irregular", gets=2)
    path = ttr.export(str(tmp_path / "sub" / "trace.json"))
    metrics = obs.dump_metrics(str(tmp_path / "metrics.json"))
    cats = ("plan", "cache", "dispatch")
    names = ("plan_resolve_total", "plan_cache_events_total",
             "plan_execute_total")
    assert jvalidate.validate_trace(path, require_cats=cats) == []
    assert tvalidate.validate_trace(path, require_cats=cats) == []
    assert jvalidate.validate_metrics(metrics, require_names=names) == []
    assert tvalidate.validate_metrics(metrics, require_names=names) == []
    argv = ["--trace", path, "--require-cats", ",".join(cats),
            "--metrics", metrics, "--require-metrics", ",".join(names)]
    assert tvalidate.main(argv) == 0
    assert tvalidate.main(argv[:2] + ["--require-cats", "serve"]) == 1
    err = capsys.readouterr().err
    assert "no events in required category 'serve'" in err
    doc = json.load(open(path))
    assert doc["otherData"] == {"producer": "repro_torch.obs",
                                "clock": "perf_counter_us",
                                "dropped_events": 0}


# ------------------------------------------------------- disabled, threads ---


def test_disabled_path_enters_no_range_and_records_nothing(monkeypatch):
    """Tracing off: no profiler range, no clock read, no event, no
    plan_execute_total increment on resolve, get, execute and inline."""
    from repro_torch.core import spmm as tspmm

    def boom(*a, **k):
        raise AssertionError("entered while tracing is off")

    _, ta = _pair("irregular")
    b, bias = _operands(ta.shape)
    with obs.tracing() as tr:
        obs.disable()
        monkeypatch.setattr(torch.profiler, "record_function", boom)
        monkeypatch.setattr(ttrace, "_now_us", boom)
        before = _counts(obs.registry, "plan_execute_total")
        cache = PlanCache()
        for _ in range(2):
            plan = cache.get(ta, PlanPolicy())
        execute_plan(plan, ta.vals, torch.from_numpy(b), ExecutionConfig(
            epilogue=Epilogue(bias=True)), bias=torch.from_numpy(bias))
        tspmm(ta, torch.from_numpy(b), plan="inline")
        with obs.span("serve.batch", cat="serve"):
            obs.event("serve.enqueue", cat="serve")
        assert len(tr) == 0 and tr.dropped == 0
        assert _counts(obs.registry, "plan_execute_total") == before
        assert not obs.is_enabled()
    monkeypatch.undo()
    entered = []
    real = torch.profiler.record_function

    def spy(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with obs.tracing() as tr:              # on, no capture: no range
        execute_plan(plan, ta.vals, torch.from_numpy(b))
        with obs.span("serve.batch", cat="serve"):
            pass
    assert entered == []
    assert [e["name"] for e in tr.events()] == ["dispatch", "serve.batch"]
    with obs.tracing() as tr:              # on, in a capture: the ranges
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with obs.span("serve.batch", cat="serve"):
                execute_plan(plan, ta.vals, torch.from_numpy(b))
    kernel = f"spmm_{plan.meta.method}_torch"
    assert entered == ["serve.batch", kernel]
    names = collections.Counter(e.name for e in prof.events())
    assert names["serve.batch"] == 1 and names[kernel] == 1
    assert [e["name"] for e in tr.events()] == ["dispatch", "serve.batch"]


def test_tracing_restores_previous_state():
    assert not obs.is_enabled()
    with obs.tracing(capacity=4) as outer:
        with obs.tracing() as inner:
            obs.event("a")
        assert obs.get_tracer() is outer and len(inner) == 1
        for i in range(6):
            obs.event(f"e{i}")
        assert len(outer) == 4 and outer.dropped == 2
        assert [e["name"] for e in outer.events()] == \
            ["e2", "e3", "e4", "e5"]
    assert not obs.is_enabled()


def test_concurrent_spans_lose_nothing():
    threads_n, per = 8, 300
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.tracing() as tr:
            start = threading.Barrier(threads_n)

            def work(i):
                start.wait(timeout=30)
                for j in range(per):
                    with obs.span("work", cat="serve", i=i, j=j):
                        obs.event("tick", cat="serve", i=i)

            ts = [threading.Thread(target=work, args=(i,))
                  for i in range(threads_n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(prev)
    evs = tr.events()
    assert len(evs) == 2 * threads_n * per and tr.dropped == 0
    by_tid = collections.Counter(e["tid"] for e in evs)
    assert len(by_tid) == threads_n
    assert set(by_tid.values()) == {2 * per}
    for i in range(threads_n):
        js = sorted(e["args"]["j"] for e in evs
                    if e["name"] == "work" and e["args"]["i"] == i)
        assert js == list(range(per))


def test_repro_trace_env_enables_at_import():
    code = ("from repro_torch.obs import trace; "
            "raise SystemExit(0 if trace.is_enabled() and "
            "trace.get_tracer() is not None else 1)")
    env = dict(os.environ, REPRO_TRACE="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    assert subprocess.run([sys.executable, "-c", code], env=env,
                          timeout=120).returncode == 0
    env["REPRO_TRACE"] = "0"
    assert subprocess.run([sys.executable, "-c", code], env=env,
                          timeout=120).returncode == 1
