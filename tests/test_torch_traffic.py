"""The bytes-moved analyzer (``repro_torch.analysis.traffic``): clean at
this tree against the floor and the committed baseline, which covers the
full grid; its compulsory floor equal to the reference's
(``repro.analysis.traffic._min_bytes``) on every row; the launch models'
gathers in the ``cuda`` rows; and each diagnostic on its injected fault
(T011 a gratuitous transpose, T012 a forced float32 copy, T020-T022 on a
temporary baseline)."""
import json
import os
import types

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import traffic as jtraffic  # noqa: E402
from repro_torch.analysis import traffic  # noqa: E402
from repro_torch.analysis.kernel_audit import representative  # noqa: E402
from repro_torch.core import PlanPolicy, build_plan  # noqa: E402
from repro_torch.kernels import ref, registry  # noqa: E402


def codes(diags):
    return [d.code for d in diags]


def _variant(name):
    return next(v for v in traffic._variants() if v.name == name)


@pytest.fixture(scope="module")
def analyzed():
    return traffic.analyze_all()


@pytest.fixture(scope="module")
def plans():
    a = representative(traffic.PATTERN)
    return {m: build_plan(a, PlanPolicy(method=m, with_transpose=True))
            for m in registry.method_names()}


def test_rows_clean_against_floor_and_baseline(analyzed):
    rows, diags = analyzed
    assert diags == [], "\n".join(map(str, diags))
    base = traffic.load_baseline()
    assert traffic.check_baseline(rows, base) == []
    for r in rows:
        assert r.bytes > r.min_bytes > 0, r.key
        assert r.transposes == 0, r.key


def test_committed_baseline_covers_full_grid():
    path = traffic.BASELINE_PATH
    assert os.path.dirname(path).endswith(os.path.join("repro_torch",
                                                       "analysis"))
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    assert data["schema"] == traffic.SCHEMA_VERSION
    want = {f"{m}/{impl}/{v.name}/{p}" for m in registry.method_names()
            for impl in traffic.IMPLS for v in traffic._variants()
            for p in traffic.PASSES}
    assert set(data["rows"]) == want


def test_floor_equals_the_reference_min_bytes(plans):
    jvars = {v.name: v for v in jtraffic._variants()}
    assert set(jvars) == {v.name for v in traffic._variants()}
    for method, plan in plans.items():
        meta = types.SimpleNamespace(shape=plan.meta.shape,
                                     nnz_pad=plan.meta.nnz_pad)
        for var in traffic._variants():
            for pass_ in traffic.PASSES:
                assert traffic.min_bytes(plan.meta, var, pass_) == \
                    jtraffic._min_bytes(meta, jvars[var.name], pass_,
                                        traffic.N, traffic.BATCH), \
                    (method, var.name, pass_)


def test_cuda_rows_count_a_b_row_a_nonzero(plans):
    plan = plans["rowsplit"]
    spec = registry.get_method("rowsplit")
    var = _variant("f32")
    nnz = int(plan.fwd["nz_valid"].sum())
    fwd = traffic.cuda_bytes(spec, plan, var, "fwd")
    gathers = nnz * traffic.N * 4 * traffic.BATCH
    assert gathers < fwd < gathers * 1.2
    # the backward: dB gathers a cotangent row a nonzero, SDDMM a B row
    assert traffic.cuda_bytes(spec, plan, var, "bwd") - fwd > 2 * gathers


def test_gratuitous_transpose_fires_t011(plans, monkeypatch):
    real = ref.rowsplit_execute_ref

    def flipped(structure, vals, b, m, **kw):
        b = b.transpose(-1, -2).contiguous().transpose(-1, -2)
        return real(structure, vals, b, m, **kw)

    monkeypatch.setattr(ref, "rowsplit_execute_ref", flipped)
    row = traffic.analyze_variant(registry.get_method("rowsplit"),
                                  plans["rowsplit"], _variant("f32"),
                                  "torch", "fwd")
    assert row.transposes >= 1
    assert "T011" in codes(traffic.check_row(row))


def test_forced_f32_copy_fires_t012(plans, monkeypatch):
    real = ref.merge_execute_ref

    def widened(structure, vals, b, m, tm, **kw):
        b.to(torch.float32)              # materialised wide, then unused
        return real(structure, vals, b, m, tm, **kw)

    monkeypatch.setattr(ref, "merge_execute_ref", widened)
    spec = registry.get_method("merge")
    row = traffic.analyze_variant(spec, plans["merge"],
                                  _variant("bf16_acc32"), "torch", "fwd")
    assert codes(traffic.check_row(row)) == ["T012"]


def test_baseline_gate_t020_t021_t022(analyzed, tmp_path):
    rows, _ = analyzed
    path = str(tmp_path / "base.json")
    assert codes(traffic.check_baseline(
        rows, traffic.load_baseline(path))) == ["T021"]   # no baseline
    data = traffic.update_baseline(rows, path)
    assert traffic.check_baseline(rows, traffic.load_baseline(path)) == []
    key = rows[0].key
    data["rows"][key]["bytes"] = int(rows[0].bytes / 1.05)
    dropped = rows[1].key
    del data["rows"][dropped]
    data["rows"]["ghost/cuda/f32/fwd"] = dict(data["rows"][key])
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)
    got = [(d.code, d.where) for d in traffic.check_baseline(
        rows, traffic.load_baseline(path))]
    assert ("T020", key) in got
    assert ("T021", dropped) in got
    assert ("T022", "ghost/cuda/f32/fwd") in got


def test_baseline_schema_mismatch_is_loud(tmp_path):
    path = tmp_path / "old.json"
    path.write_text(json.dumps({"schema": 0, "rows": {}}))
    with pytest.raises(ValueError, match="schema"):
        traffic.load_baseline(str(path))
