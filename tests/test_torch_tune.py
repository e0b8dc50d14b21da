"""The port's autotuner against the reference's: ``calibrate`` and
``class_signature``, the TuneDB's semantics and JSON schema (a file either
package writes loads in the other), the ``PlanPolicy`` ladder rung for
rung on the ``paper`` suite, ``tune_candidates``, ``tune_suite`` and the
CLI on the CPU, the engine's process-default DB, and ``serve --tunedb``.
"""
import ast
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import matrices as jmat  # noqa: E402
from repro import tune as jtune  # noqa: E402
from repro.core import PlanPolicy as JPlanPolicy  # noqa: E402
from repro.core import calibrate as jcalibrate  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core.plan import pattern_fingerprint as jfingerprint  # noqa: E402
from repro.kernels import registry as jregistry  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch import matrices as tmat  # noqa: E402
from repro_torch.core import Heuristic, PlanPolicy, calibrate  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core.plan import pattern_fingerprint  # noqa: E402
from repro_torch.engine.cache import PlanCache  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.tune import (SCHEMA_VERSION, TimingResult,  # noqa: E402
                              TuneDB, TuneRecord, backend_key,
                              class_signature, timeit, tune_pattern,
                              tune_suite)
from repro_torch.tune.autotune import pick_winner  # noqa: E402
from repro_torch.tune.cli import main as tune_main  # noqa: E402

PAPER = [sp.name for sp in jmat.get_suite("paper")]
CORPUS = [sp.name for sp in jmat.get_suite("mini")] + PAPER


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The same suite matrix from both packages (reference, port)."""
    jspec = next(sp for s in ("mini", "paper") for sp in jmat.get_suite(s)
                 if sp.name == name)
    tspec = next(sp for s in ("mini", "paper") for sp in tmat.get_suite(s)
                 if sp.name == name)
    return jspec(), tspec()


def _rec(method, merge_us, rowsplit_us, a, cls=TuneRecord, **kw):
    s = tmat.compute_stats(a) if isinstance(a.row_ptr, torch.Tensor) \
        else jmat.compute_stats(a)
    return cls(method=method, merge_us=merge_us, rowsplit_us=rowsplit_us,
               m=s.m, k=s.k, d=s.d, cv=s.cv, n=64, **kw)


def _counts(family):
    return {tuple(c.labels.values()): c.value for c in family.children()}


def _rung(family, fn):
    """Call ``fn`` and return (its result, the one ladder rung it
    incremented in ``plan_resolve_total``)."""
    before = _counts(family)
    out = fn()
    after = _counts(family)
    moved = [key for key, v in after.items() if v != before.get(key, 0)]
    assert len(moved) == 1, moved
    return out, moved[0][0]


# ------------------------------------------------ calibrate, signature ---

@pytest.mark.parametrize("seed", range(6))
def test_calibrate_matches_reference_on_random_timings(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    ds = rng.choice([1.0, 2.0, 4.5, 8.0, 9.35, 16.0, 33.3], size=n)
    rs, ms = rng.uniform(1, 100, n), rng.uniform(1, 100, n)
    assert calibrate(ds, rs, ms) == jcalibrate(ds, rs, ms)


@pytest.mark.parametrize("ds,rs,ms", [
    ([2.0, 8.0, 32.0], [10.0] * 3, [10.0] * 3),          # ties
    ([5.0], [20.0], [10.0]),                               # one point
    ([5.0], [10.0], [20.0]),
    ([2.0, 8.0, 32.0], [20.0] * 3, [10.0] * 3),           # all merge
    ([2.0, 8.0, 32.0], [10.0] * 3, [20.0] * 3),           # all rowsplit
    ([0.0, 0.0, 3.0], [1.0, 2.0, 1.0], [2.0, 1.0, 2.0]),  # d = 0 rows
])
def test_calibrate_edges_match_reference(ds, rs, ms):
    ds, rs, ms = (np.array(x) for x in (ds, rs, ms))
    thr, acc = calibrate(ds, rs, ms)
    assert (thr, acc) == jcalibrate(ds, rs, ms)
    assert acc == pytest.approx(np.mean((ds < thr) == (ms < rs)))


@pytest.mark.parametrize("seed", range(4))
def test_class_signature_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        m, k = (int(x) for x in rng.integers(0, 1 << 18, 2))
        d = float(rng.choice([0.0, rng.uniform(0, 4096)]))
        cv = float(rng.choice([0.0, 0.1, 0.5, 1.0, rng.uniform(0, 3)]))
        assert class_signature(m, k, d, cv) == \
            jtune.class_signature(m, k, d, cv)


# -------------------------------------------------------- persistence ---

def test_tunedb_round_trip(tmp_path):
    db = TuneDB(backend="test")
    a = tmat.uniform(0, 32, 32, 4)
    db.record("fp0", _rec("merge", 10.0, 20.0, a, t=16, name="u"))
    db.record("fp1", _rec("rowsplit", 30.0, 15.0, a, l_pad=7,
                          timings={"merge": 30.0, "rowsplit": 15.0}))
    db.calibrate_threshold()
    path = tmp_path / "tune.json"
    db.save(path)
    back = TuneDB.load(path, backend="test")
    assert back.as_dict() == db.as_dict()
    assert back.digest() == db.digest()
    assert back.lookup_exact("fp1").l_pad == 7
    assert back.threshold == db.threshold


def test_tunedb_schema_version_mismatch(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({"schema_version": SCHEMA_VERSION + 1,
                                "backend": "test", "entries": {}}))
    with pytest.warns(UserWarning, match="schema version"):
        db = TuneDB.load(path, backend="test")
    assert len(db) == 0
    assert db.choose(tmat.uniform(1, 16, 64, 2)) == "merge"
    with pytest.raises(ValueError, match="schema version"):
        TuneDB.load(path, backend="test", strict=True)


@pytest.mark.parametrize("text", ["{this is not json", "[1, 2]"])
def test_tunedb_corrupt_file_falls_back(tmp_path, text):
    path = tmp_path / "tune.json"
    path.write_text(text)
    with pytest.warns(UserWarning, match="corrupt|not a JSON object"):
        db = TuneDB.load(path, backend="test")
    assert len(db) == 0
    a = tmat.uniform(2, 16, 64, 30)
    assert db.choose(a) == Heuristic().choose(a) == "rowsplit"
    with pytest.raises(ValueError):
        TuneDB.load(path, backend="test", strict=True)


def test_tunedb_backend_mismatch(tmp_path):
    db = TuneDB(backend="torch-cuda:NVIDIA H100 80GB HBM3")
    db.record("fp", _rec("merge", 1.0, 2.0, tmat.uniform(0, 8, 8, 2)))
    path = tmp_path / "tune.json"
    db.save(path)
    with pytest.warns(UserWarning, match="backend"):
        loaded = TuneDB.load(path, backend="torch-cpu")
    assert len(loaded) == 0 and loaded.backend == "torch-cpu"
    assert len(TuneDB.load(path, backend=db.backend)) == 1


def test_tunedb_malformed_entry(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({"schema_version": SCHEMA_VERSION,
                                "backend": "test",
                                "entries": {"fp": {"not_a_field": 1}}}))
    with pytest.warns(UserWarning, match="malformed"):
        db = TuneDB.load(path, backend="test")
    assert len(db) == 0
    with pytest.raises(ValueError, match="malformed"):
        TuneDB.load(path, backend="test", strict=True)


def test_tunedb_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TuneDB.load(tmp_path / "absent.json", backend="test")


def test_backend_key_names_the_port_and_its_device():
    assert backend_key("cpu") == "torch-cpu"
    if not torch.cuda.is_available():
        assert backend_key() == "torch-cpu"
    assert TuneDB().backend == backend_key()
    # The reference's key never matches the port's.
    assert jtune.backend_key() != backend_key()


def test_plain_versions_timed_on_a_card_are_not_the_cards_db(
        tmp_path, monkeypatch):
    """``--impl torch`` on a card keys its DB apart: the card's launchers
    (which load under the kernels' key) do not read the plain versions'
    timings as the kernels'."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "Some Card")
    kernels = backend_key("cuda")
    plain = backend_key("cuda", impl="torch")
    assert kernels == "torch-cuda:Some Card" == backend_key("cuda", "cuda")
    assert plain == "torch-cuda-plain:Some Card"
    assert backend_key("cpu", impl="torch") == "torch-cpu"
    db = TuneDB(backend=plain)
    db.record("fp", _rec("merge", 1.0, 2.0, tmat.uniform(0, 8, 8, 2)))
    path = tmp_path / "plain.json"
    db.save(path)
    with pytest.warns(UserWarning, match="backend"):
        assert len(TuneDB.load(path, backend=kernels)) == 0
    with pytest.raises(ValueError, match="backend"):
        TuneDB.load(path, backend=kernels, strict=True)
    try:
        with pytest.warns(UserWarning, match="backend"):
            assert len(engine.load_tunedb(path, backend=kernels)) == 0
    finally:
        engine.set_tunedb(None)
    assert len(TuneDB.load(path, backend=plain)) == 1


# -------------------------------------------------- resolution ladder ---

def test_resolve_exact_beats_class_beats_threshold():
    db = TuneDB(backend="test")
    a = tmat.power_law(7, 256, 256, 4.0)
    twin = tmat.power_law(8, 256, 256, 4.0)      # same class, other pattern
    db.record(pattern_fingerprint(twin), _rec("rowsplit", 100.0, 50.0, twin))
    assert db.resolve(a) == ("rowsplit", "class")
    db.record(pattern_fingerprint(a), _rec("merge", 50.0, 100.0, a))
    assert db.resolve(a) == ("merge", "exact")
    far = tmat.uniform(9, 16, 2048, 512)
    assert db.resolve(far) == (None, "miss")
    assert db.choose(far) == db.heuristic().choose(far)


def test_class_majority_vote():
    db = TuneDB(backend="test")
    for seed, (method, mu, ru) in enumerate(
            [("merge", 10, 20), ("merge", 10, 20), ("rowsplit", 20, 10)]):
        a = tmat.power_law(20 + seed, 256, 256, 4.0)
        rec = _rec(method, float(mu), float(ru), a)
        db.record(pattern_fingerprint(a), rec)
    assert db.lookup_class(rec.signature) == "merge"


def test_calibrated_threshold_fallback():
    db = TuneDB(backend="test")
    for seed, (d, mu, ru) in enumerate(
            [(2, 10, 30), (4, 10, 30), (8, 10, 30), (16, 30, 10),
             (32, 30, 10)]):
        a = tmat.uniform(seed, 64, 64, d)
        db.record(pattern_fingerprint(a),
                  _rec("merge" if mu < ru else "rowsplit", float(mu),
                       float(ru), a))
    thr, acc = db.calibrate_threshold()
    assert 8.0 < thr <= 16.0 and acc == 1.0
    assert db.heuristic().threshold == thr
    with pytest.raises(ValueError, match="empty"):
        TuneDB(backend="test").calibrate_threshold()


def test_record_overwrite_updates_class_aggregate():
    db = TuneDB(backend="test")
    a = tmat.power_law(30, 256, 256, 4.0)
    rec = _rec("merge", 10.0, 20.0, a)
    db.record("fp", rec)
    assert db.lookup_class(rec.signature) == "merge"
    db.record("fp", _rec("rowsplit", 20.0, 10.0, a))
    assert db.lookup_class(rec.signature) == "rowsplit"
    assert len(db) == 1


def test_digest_tracks_content():
    db = TuneDB(backend="test")
    d0 = db.digest()
    db.record("fp", _rec("merge", 1.0, 2.0, tmat.uniform(0, 8, 8, 2)))
    d1 = db.digest()
    assert d0 != d1
    db.calibrate_threshold()
    assert db.digest() != d1


# ------------------------------------ the same DB in both packages ---

def _ladder_db(path):
    """A reference TuneDB over the paper suite that reaches every rung:
    exact records (merge with t=32, rowsplit with a wider pad, rowgroup)
    for every fourth matrix, class evidence from a stand-in record for the
    next, a calibrated threshold for the rest; saved to ``path``."""
    jdb = jtune.TuneDB(backend="test")
    exact = [("merge", dict(t=32)), ("rowsplit", dict(l_pad=None)),
             ("rowgroup", {})]
    for i, name in enumerate(PAPER):
        ja, _ = _pair(name)
        if i % 4 == 0:
            method, kw = exact[(i // 4) % 3]
            if method == "rowsplit":
                kw = dict(l_pad=int(np.diff(np.asarray(ja.row_ptr)).max())
                          + 5)
            mu, ru = (10.0, 20.0) if method == "merge" else (20.0, 10.0)
            jdb.record(jfingerprint(ja),
                       _rec(method, mu, ru, ja, cls=jtune.TuneRecord,
                            name=name, timings={"merge": mu, "rowsplit": ru,
                                                "rowgroup": 15.0}, **kw))
        elif i % 4 == 1:
            # Class evidence that contradicts the paper's rule.
            d = jmat.compute_stats(ja).d
            mu, ru = (20.0, 10.0) if d < 9.35 else (10.0, 20.0)
            jdb.record(f"stand-in-{name}",
                       _rec("merge" if mu < ru else "rowsplit", mu, ru, ja,
                            cls=jtune.TuneRecord, name=f"{name}~"))
    jdb.threshold, jdb.threshold_accuracy = 5.5, 0.75
    jdb.save(path)
    return jdb


def test_reference_db_loads_in_the_port_and_resolves_alike(tmp_path):
    path = tmp_path / "ref.json"
    jdb = _ladder_db(path)
    with pytest.warns(UserWarning, match="backend"):
        assert len(TuneDB.load(path)) == 0      # cpu:cpu is not the port's
    tdb = TuneDB.load(path, backend="test")
    assert tdb.as_dict() == jdb.as_dict()
    assert tdb.digest() == jdb.digest()
    for name in PAPER:
        ja, ta = _pair(name)
        assert tdb.resolve(ta) == jdb.resolve(ja), name
        assert tdb.choose(ta) == jdb.choose(ja), name
    # And the port's file loads in the reference.
    tdb.save(tmp_path / "port.json")
    back = jtune.TuneDB.load(tmp_path / "port.json", backend="test")
    assert back.as_dict() == jdb.as_dict()


@pytest.mark.parametrize("name", PAPER)
def test_plan_policy_resolve_matches_reference(name, tmp_path):
    """The same DB content: the port's PlanPolicy.resolve and the
    reference's give the same (method, t, l_pad) from the same rung."""
    path = tmp_path / "ref.json"
    jdb = _ladder_db(path)
    tdb = TuneDB.load(path, backend="test")
    ja, ta = _pair(name)
    j, jrung = _rung(jconfig._resolve_total,
                     lambda: JPlanPolicy(tunedb=jdb).resolve(ja))
    t, trung = _rung(tconfig._resolve_total,
                     lambda: PlanPolicy(tunedb=tdb).resolve(ta))
    assert (t.method, t.t, t.l_pad) == (j.method, j.t, j.l_pad)
    assert trung == jrung
    i = PAPER.index(name)
    assert trung == {0: "exact", 1: "class"}.get(i % 4, trung)


def test_plan_policy_rungs_without_a_db_and_on_fallback():
    ja, ta = _pair("uniform_d32")
    for jpol, tpol, rung in (
            (JPlanPolicy(tunedb=None), PlanPolicy(tunedb=None), "analytic"),
            (JPlanPolicy(method="merge", tunedb=None),
             PlanPolicy(method="merge", tunedb=None), "explicit")):
        j, jr = _rung(jconfig._resolve_total, lambda: jpol.resolve(ja))
        t, tr = _rung(tconfig._resolve_total, lambda: tpol.resolve(ta))
        assert (t.method, t.t, t.l_pad) == (j.method, j.t, j.l_pad)
        assert tr == jr == rung
    # An exact rowgroup record, but the caller pinned a global l_pad that
    # only row-split takes: "auto" falls back to the analytic choice.
    db = TuneDB(backend="test")
    db.record(pattern_fingerprint(ta), _rec("rowgroup", 20.0, 10.0, ta))
    lmax = int(ta.row_lengths().max())
    t, tr = _rung(tconfig._resolve_total, lambda: PlanPolicy(
        tunedb=db, l_pad=lmax + 1).resolve(ta))
    assert (t.method, t.l_pad, tr) == ("rowsplit", lmax + 1, "analytic")
    # An exact record naming a method this process lacks drops a rung.
    db.record(pattern_fingerprint(ta), _rec("nope", 20.0, 10.0, ta))
    with pytest.warns(UserWarning, match="unregistered method"):
        t, tr = _rung(tconfig._resolve_total,
                      lambda: PlanPolicy(tunedb=db).resolve(ta))
    assert tr == "class" and t.method == "rowsplit"


def test_exact_hit_replays_tuned_params():
    a = tmat.uniform(40, 32, 48, 6)
    lmax = int(a.row_lengths().max())
    db = TuneDB(backend="test")
    db.record(pattern_fingerprint(a),
              _rec("rowsplit", 100.0, 50.0, a, l_pad=lmax + 3))
    r = PlanPolicy(tunedb=db).resolve(a)
    assert (r.method, r.l_pad) == ("rowsplit", lmax + 3)
    assert PlanPolicy(tunedb=db, l_pad=lmax).resolve(a).l_pad == lmax


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name", CORPUS)
def test_tune_candidates_match_reference(name, wide):
    ja, ta = _pair(name)
    assert registry.method_names() == jregistry.method_names()
    for method in registry.method_names():
        got = registry.get_method(method).tune_candidates(ta, wide)
        assert got == jregistry.get_method(method).tune_candidates(ja, wide)
        # Inside the CUDA merge kernel's one-warp chunk.
        assert all(c.get("t", 16) <= 32 for c in got)


# ------------------------------------------------------- the engine ---

def test_cache_keys_on_the_resolved_request():
    """DBs that pick differently give two plans; DBs that pick alike share
    one — a DB swap can never serve a plan resolved against another."""
    a = tmat.power_law(41, 128, 128, 4.0)
    fp = pattern_fingerprint(a)
    dbs = {}
    for tag, method, mu, ru in (("merge", "merge", 10.0, 20.0),
                                ("rowsplit", "rowsplit", 20.0, 10.0),
                                ("merge_again", "merge", 11.0, 21.0)):
        dbs[tag] = TuneDB(backend="test")
        dbs[tag].record(fp, _rec(method, mu, ru, a))
    cache = PlanCache()
    p1 = cache.get(a, PlanPolicy(tunedb=dbs["merge"]))
    p2 = cache.get(a, PlanPolicy(tunedb=dbs["rowsplit"]))
    assert (p1.meta.method, p2.meta.method) == ("merge", "rowsplit")
    assert cache.stats().misses == 2
    p3 = cache.get(a, PlanPolicy(tunedb=dbs["merge_again"]))
    assert p3 is p1 and cache.stats().hits == 1 and len(cache) == 2
    assert cache.get(a, PlanPolicy(tunedb=None)).meta.method == \
        Heuristic().choose(a)


def test_process_default_tunedb():
    a = tmat.uniform(42, 32, 512, 30)             # analytic: rowsplit
    db = TuneDB(backend="test")
    db.record(pattern_fingerprint(a), _rec("merge", 10.0, 20.0, a))
    cache = PlanCache()
    try:
        engine.set_tunedb(db)
        assert engine.current_tunedb() is db
        assert PlanPolicy().resolved_tunedb() is db
        assert cache.get(a).meta.method == "merge"
    finally:
        engine.set_tunedb(None)
    assert cache.get(a).meta.method == "rowsplit"


def test_sparse_linear_reaches_calibrated_threshold_rung():
    from repro_torch.models.sparse import SparseLinear

    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (32, 16)).astype(np.float32))
    d = 0.5 * 32                          # 16: the paper's rule says rowsplit
    db = TuneDB(backend="test")
    far = tmat.uniform(50, 8, 8, 2)
    db.record(pattern_fingerprint(far), _rec("merge", 1.0, 2.0, far))
    db.threshold = d + 1.0                # calibrated: d = 16 -> merge
    try:
        engine.set_tunedb(db)
        assert SparseLinear.from_dense(w, 0.5).plan.meta.method == "merge"
    finally:
        engine.set_tunedb(None)
    assert SparseLinear.from_dense(w, 0.5).plan.meta.method == "rowsplit"


def test_load_tunedb_installs_it_and_degrades_on_a_corrupt_file(tmp_path):
    good = tmp_path / "good.json"
    db = TuneDB(backend="test")
    a = tmat.uniform(43, 32, 512, 30)
    db.record(pattern_fingerprint(a), _rec("merge", 10.0, 20.0, a))
    db.save(good)
    bad = tmp_path / "bad.json"
    bad.write_text("garbage{")
    try:
        loaded = engine.load_tunedb(good, backend="test")
        assert engine.current_tunedb() is loaded and len(loaded) == 1
        assert PlanCache().get(a).meta.method == "merge"
        with pytest.warns(UserWarning, match="corrupt"):
            empty = engine.load_tunedb(bad)
        assert len(empty) == 0 and engine.current_tunedb() is empty
        assert PlanCache().get(a).meta.method == Heuristic().choose(a)
    finally:
        engine.set_tunedb(None)


# ----------------------------------------------------- live tuning ---

def test_timeit_on_the_cpu():
    r = timeit(lambda x: x * 2, torch.ones(4), warmup=1, repeat=3)
    assert len(r.samples) == 3 and float(r) == r.median > 0
    assert r.min <= r.p50 <= r.p95 <= r.max and r.cv >= 0


def test_tune_suite_records_and_calibrates_on_the_cpu():
    db = TuneDB(backend=backend_key("cpu"))
    logs = []
    tune_suite(tmat.get_suite("mini"), db, impl="torch", warmup=1, repeat=2,
               device="cpu", log=logs.append)
    assert len(db) == 3
    for spec in tmat.get_suite("mini"):
        rec = db.lookup_exact(pattern_fingerprint(spec()))
        assert rec.name == spec.name
        assert set(rec.timings) == set(registry.method_names())
        core = min(("merge", "rowsplit"), key=rec.timings.get)
        assert rec.method == core or rec.timings[rec.method] < \
            rec.timings[core]
        assert rec.merge_us == rec.timings["merge"] > 0
        assert rec.rowsplit_us == rec.timings["rowsplit"] > 0
        if rec.method == "merge":
            assert rec.t == 16 and rec.l_pad is None
        if rec.method == "rowsplit":
            assert rec.l_pad == tmat.compute_stats(spec()).max_len
    assert db.threshold is not None
    assert any("calibrated" in line for line in logs)
    tune_suite(tmat.get_suite("mini"), db, impl="torch", warmup=1, repeat=2,
               device="cpu", log=logs.append)
    assert any("cached" in line for line in logs)


def test_winner_leaves_the_core_pair_only_beyond_the_noise():
    def us(*samples):
        return TimingResult(samples)

    # rowsplit (median 100, cv ~0.008) is the core pair's best.
    core = dict(merge=us(150, 150, 150), rowsplit=us(99, 100, 101))
    assert pick_winner(dict(core, rowgroup=us(101, 102, 103))) == "rowsplit"
    # 2 % faster, inside rowgroup's own 5 % noise: not taken.
    assert pick_winner(dict(core, rowgroup=us(93, 98, 103))) == "rowsplit"
    # 2 % faster with a tight spread: beyond both cvs, taken.
    assert pick_winner(dict(core, rowgroup=us(97.9, 98, 98.1))) == \
        "rowgroup"
    assert pick_winner(dict(core, rowgroup=us(50, 50, 50))) == "rowgroup"
    # One sample a timing has no spread: any win is taken.
    assert pick_winner(dict(merge=us(99.9), rowsplit=us(100.0),
                            rowgroup=us(99.8))) == "rowgroup"
    # Within the core pair the faster wins, however close.
    assert pick_winner(dict(merge=us(99.9, 100, 100.1),
                            rowsplit=us(100.0, 100.1, 100.2),
                            rowgroup=us(99, 99.95, 100.9))) == "merge"


def test_tunedb_pick_is_the_ladder_plan_policy_climbs():
    """``TuneDB.pick`` holds the exact and class rungs that
    ``PlanPolicy.resolve`` takes: the same method and rung on every
    ``paper`` matrix, the exact record's params replayed."""
    db = TuneDB(backend="test")
    for i, name in enumerate(PAPER):
        _, ta = _pair(name)
        if i % 3 == 0:
            db.record(pattern_fingerprint(ta),
                      _rec("merge", 10.0, 20.0, ta, t=32))
        elif i % 3 == 1:
            db.record(f"stand-in-{name}", _rec("rowsplit", 20.0, 10.0, ta))
    db.calibrate_threshold()
    for name in PAPER:
        _, ta = _pair(name)
        method, rung, rec = db.pick(ta, registered=registry.method_names())
        assert (method, rung) == db.resolve(ta)
        r, prung = _rung(tconfig._resolve_total,
                         lambda: PlanPolicy(tunedb=db).resolve(ta))
        if rung == "miss":
            assert prung == "calibrated" and rec is None
        else:
            assert (r.method, prung) == (method, rung), name
        if rung == "exact":
            assert r.t == rec.t == 32
    # A class naming no registered method is a miss.
    _, ta = _pair(PAPER[1])
    assert db.pick(ta, registered=("merge",)) == (None, "miss", None)


def test_tune_pattern_wide_sweeps_every_candidate():
    a = tmat.power_law(2, 64, 48, 4.0)          # longest row 18
    logs = []
    rec = tune_pattern(a, n=8, impl="torch", warmup=0, repeat=1, wide=True,
                       log=logs.append)
    want = sum(len(registry.get_method(m).tune_candidates(a, True))
               for m in registry.method_names())
    assert len(logs) == want == 6     # t 16/8/32, pads 18/24, rowgroup
    assert rec.n == 8 and rec.d == tmat.compute_stats(a).d


def test_cli_writes_extends_and_refuses_a_mismatched_db(tmp_path, capsys):
    path = tmp_path / "tune.json"
    argv = ["--suite", "mini", "--out", str(path), "--device", "cpu",
            "--warmup", "1", "--repeat", "2"]
    assert tune_main(argv) == 0
    raw = json.loads(path.read_text())
    assert raw["backend"] == "torch-cpu" and len(raw["entries"]) == 3
    assert raw["threshold"] is not None
    assert tune_main(argv) == 0
    assert "extending" in capsys.readouterr().out
    # A reference DB (backend cpu:cpu) and a corrupt file stay untouched.
    jdb = jtune.TuneDB(backend="cpu:cpu")
    jdb.save(tmp_path / "ref.json")
    for bad, text in ((tmp_path / "ref.json", None),
                      (tmp_path / "corrupt.json", "{corrupt")):
        if text is not None:
            bad.write_text(text)
        before = bad.read_text()
        with pytest.raises(SystemExit):
            tune_main(["--suite", "mini", "--out", str(bad), "--device",
                       "cpu"])
        assert "refusing to overwrite" in capsys.readouterr().err
        assert bad.read_text() == before
    with pytest.raises(SystemExit):
        tune_main(["--out", str(path), "--device", "cpu"])


def test_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tune_main(["--suite", "mini", "--out", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()


def test_python_m_tune_on_the_cpu(tmp_path):
    import os
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(root, "src")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = tmp_path / "t.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "--suite", "mini",
         "--out", str(out), "--device", "cpu", "--warmup", "1",
         "--repeat", "2"], capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "calibrated_threshold" in proc.stdout
    assert len(TuneDB.load(out, backend="torch-cpu")) == 3


def test_serve_tunedb_on_the_cpu(tmp_path, capsys):
    """``serve --tunedb`` with a DB that tuned the smoke model's own pruned
    FFN patterns: every plan resolves from an exact record, none is built
    while serving, and the plans run the recorded methods."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.sparse import SparseLinear

    cfg = get_smoke_config("llama3.2-1b")
    params = M.init_params(cfg, 0, "cpu")
    db = TuneDB(backend=backend_key("cpu"))
    for lp in params["blocks"]:
        for name, w in lp["mlp"].items():
            a = SparseLinear.from_dense(
                w, 0.25, policy=PlanPolicy(method="merge",
                                           with_transpose=False)).weight
            db.record(pattern_fingerprint(a),
                      tune_pattern(a, n=8, impl="torch", warmup=0, repeat=1,
                                   name=name))
    path = tmp_path / "tune.json"
    db.save(path)
    try:
        assert serve.main(["--smoke", "--prune-ffn", "0.25", "--device",
                           "cpu", "--batch", "2", "--prompt-len", "8",
                           "--tunedb", str(path)]) == 0
        out = capsys.readouterr().out
        assert f"backend=torch-cpu entries={len(db)}" in out
        assert "plans built during serving: 0" in out
        rungs = out.split("plan_resolve_total of this run: ")[1]
        rungs = ast.literal_eval(rungs.splitlines()[0])
        assert sum(rungs.values()) == len(db) == 3 * cfg.num_layers
        assert all(key.startswith("exact/") for key in rungs)
        picks = sorted(rec.method for rec in db.entries.values())
        assert sorted(m for key, n in rungs.items()
                      for m in [key.split("/")[1]] * n) == picks
    finally:
        engine.set_tunedb(None)
