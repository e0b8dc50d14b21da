"""The port's plan linter (``repro_torch.analysis.planlint``) against the
reference's (``repro.analysis.planlint``): clean plans of every method give
no finding in either, each corruption of the reference's own mutation
tests (``tests/test_analysis.py``, P001-P060) applied to both packages'
plans of one numpy-seeded pattern gives the same code set, the
``REPRO_VERIFY_PLANS`` hook on build and on a cache hit, and the
``python -m repro_torch.analysis`` CLI."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import planlint as jlint  # noqa: E402
from repro.core import csr as jcsr  # noqa: E402
from repro.core.plan import build_plan as jbuild_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis import cli, planlint, set_verify_plans  # noqa: E402
from repro_torch.analysis import _flags  # noqa: E402
from repro_torch.core import PlanPolicy, build_plan, csr as tcsr  # noqa: E402
from repro_torch.engine import PlanCache  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
METHODS = ("merge", "rowsplit", "rowgroup")
# (m, k, nnz_per_row, padded slots): the reference's mutation pattern (m
# not a multiple of the row tile, nnz_pad > nnz), and three more.
PATTERNS = {"mutation": (41, 96, (1, 17), 8),
            "regular": (64, 48, 6, 0),
            "short_rows": (96, 64, (0, 4), 3),
            "zero_nnz": (16, 8, 0, 0)}


def _pair(kind, seed=7):
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


def codes(diags):
    return {d.code for d in diags}


@pytest.fixture(scope="module")
def pair():
    return _pair("mutation")


@pytest.fixture(scope="module")
def plans(pair):
    ja, ta = pair
    return {m: (jbuild_plan(ja, method=m),
                build_plan(ta, PlanPolicy(method=m))) for m in METHODS}


@pytest.mark.parametrize("kind", sorted(PATTERNS))
@pytest.mark.parametrize("method", METHODS)
def test_clean_plans_have_no_findings(kind, method):
    ja, ta = _pair(kind)
    jplan = jbuild_plan(ja, method=method)
    tplan = build_plan(ta, PlanPolicy(method=method))
    assert jlint.verify_plan(jplan, ja) == []
    assert planlint.verify_plan(tplan, ta) == []
    assert planlint.verify_plan(tplan) == []          # CSR-free path too
    fwd_only = build_plan(ta, PlanPolicy(method=method,
                                         with_transpose=False))
    assert planlint.verify_plan(fwd_only, ta) == []


# --------------------------------------------------------------- mutations ---
# Each corruption edits host numpy copies of one plan's arrays (or its meta
# or CSR) and is applied alike to the reference's plan and the port's.


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _like(template, arr):
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr))
    return jnp.asarray(arr)


def _with_fwd(plan, **arrays):
    fwd = dict(plan.fwd)
    fwd.update({k: _like(plan.fwd[k], v) for k, v in arrays.items()})
    return dataclasses.replace(plan, fwd=fwd)


def _live(slot, nnz_pad):
    return np.argwhere(slot < nnz_pad)


def dup_slot(plan, a):
    slot = _np(plan.fwd["slot_nz"]).copy()
    (r0, c0), (r1, c1) = _live(slot, plan.meta.nnz_pad)[:2]
    slot[r1, c1] = slot[r0, c0]
    return _with_fwd(plan, slot_nz=slot), a


def sentinel_at_live(plan, a):
    slot = _np(plan.fwd["slot_nz"]).copy()
    r, c = np.argwhere(slot == plan.meta.nnz_pad)[0]
    slot[r, c] = 0
    return _with_fwd(plan, slot_nz=slot), a


def missing_nonzero(plan, a):
    slot = _np(plan.fwd["slot_nz"]).copy()
    slot[tuple(_live(slot, plan.meta.nnz_pad)[0])] = plan.meta.nnz_pad
    return _with_fwd(plan, slot_nz=slot), a


def slot_past_sentinel(plan, a):
    slot = _np(plan.fwd["slot_nz"]).copy()
    slot[0, 0] = plan.meta.nnz_pad + 3
    return _with_fwd(plan, slot_nz=slot), a


def dead_range_slot(plan, a):
    slot = _np(plan.fwd["slot_nz"]).copy()
    r, c = np.argwhere(slot == plan.meta.nnz_pad)[0]
    slot[r, c] = int(_np(a.row_ptr)[-1])
    return _with_fwd(plan, slot_nz=slot), a


def scrambled_tiles(plan, a):
    tile = _np(plan.fwd["tile"]).copy()
    tile[1:] = tile[:-1][::-1][: len(tile) - 1]
    return _with_fwd(plan, tile=tile), a


def tile_skipped(plan, a):
    tile = _np(plan.fwd["tile"]).copy()
    tile[tile == 1] = 0
    return _with_fwd(plan, tile=tile), a


def first_flag(plan, a):
    first = _np(plan.fwd["first"]).copy()
    first[0] = 0
    return _with_fwd(plan, first=first), a


def lrow_wrong_row(plan, a):
    lrow = _np(plan.fwd["lrow"]).copy()
    r0, c0 = _live(_np(plan.fwd["slot_nz"]), plan.meta.nnz_pad)[0]
    lrow[r0, c0] = (lrow[r0, c0] + 1) % 8
    return _with_fwd(plan, lrow=lrow), a


def truncated_l_pad(plan, a):
    meta = dataclasses.replace(plan.meta, l_pad=plan.meta.l_pad - 1)
    return dataclasses.replace(plan, meta=meta), a


def ell_slot_wrong_row(plan, a):
    slot = _np(plan.fwd["slot_nz"]).copy()
    nnz_pad = plan.meta.nnz_pad
    r0, r1 = [r for r in range(slot.shape[0])
              if (slot[r] < nnz_pad).any()][:2]
    c0 = int(np.argwhere(slot[r0] < nnz_pad)[0, 0])
    c1 = int(np.argwhere(slot[r1] < nnz_pad)[0, 0])
    slot[r0, c0], slot[r1, c1] = slot[r1, c1], slot[r0, c0]
    return _with_fwd(plan, slot_nz=slot), a


def live_slot_on_pad_row(plan, a):
    slot = _np(plan.fwd["slot_nz"]).copy()
    assert slot.shape[0] > plan.meta.m
    slot[-1, 0] = 0
    return _with_fwd(plan, slot_nz=slot), a


def bad_group_table(plan, a):
    extra = list(plan.meta.extra)
    m_g, l_g = extra[0]
    extra[0] = (m_g + 1, l_g)
    meta = dataclasses.replace(plan.meta, extra=tuple(extra))
    return dataclasses.replace(plan, meta=meta), a


def non_permutation(plan, a):
    inv = _np(plan.fwd["inv_pos"]).copy()
    inv[1] = inv[0]
    return _with_fwd(plan, inv_pos=inv), a


def bwd_missing(plan, a):
    return dataclasses.replace(plan, bwd=None), a


def bwd_coverage(plan, a):
    bwd = dict(plan.bwd)
    slot = _np(bwd["slot_nz"]).copy()
    slot[tuple(_live(slot, plan.meta.nnz_pad)[0])] = plan.meta.nnz_pad
    bwd["slot_nz"] = _like(plan.bwd["slot_nz"], slot)
    return dataclasses.replace(plan, bwd=bwd), a


def unregistered_method(plan, a):
    meta = dataclasses.replace(plan.meta, method="nope")
    return dataclasses.replace(plan, meta=meta), a


def coords_missing(plan, a):
    fwd = {k: v for k, v in plan.fwd.items() if k != "nz_cols"}
    return dataclasses.replace(plan, fwd=fwd), a


def valid_not_prefix(plan, a):
    valid = _np(plan.fwd["nz_valid"]).copy()
    valid[0] = False
    return _with_fwd(plan, nz_valid=valid), a


def _csr_like(a, row_ptr=None, col_ind=None):
    rp = _np(a.row_ptr) if row_ptr is None else row_ptr
    ci = _np(a.col_ind) if col_ind is None else col_ind
    mod = tcsr if isinstance(a.row_ptr, torch.Tensor) else jcsr
    return mod.CSR(_like(a.row_ptr, rp), _like(a.col_ind, ci), a.vals,
                   a.shape)


def row_ptr_drops(plan, a):
    rp = _np(a.row_ptr).copy()
    rp[2], rp[3] = rp[3] + 1, rp[2]
    return plan, _csr_like(a, row_ptr=rp)


def col_out_of_range(plan, a):
    ci = _np(a.col_ind).copy()
    ci[0] = a.shape[1] + 5
    return plan, _csr_like(a, col_ind=ci)


def other_csr(plan, a):
    ja, ta = _pair("regular")
    return plan, (ta if isinstance(a.row_ptr, torch.Tensor) else ja)


# (corruption, the method whose plan it corrupts, codes it must raise --
# the reference's own tests assert these).
MUTATIONS = {
    "P001_row_ptr": (row_ptr_drops, "merge", {"P001"}),
    "P002_col_ind": (col_out_of_range, "merge", {"P002"}),
    "P003_other_csr": (other_csr, "merge", {"P003"}),
    "P011_unregistered": (unregistered_method, "merge", {"P011"}),
    "P012_coords": (coords_missing, "rowsplit", {"P012"}),
    "P012_prefix": (valid_not_prefix, "merge", {"P012"}),
    "P020_duplicate": (dup_slot, "merge", {"P020", "P021"}),
    "P020_sentinel": (sentinel_at_live, "merge", {"P020"}),
    "P021_missing": (missing_nonzero, "merge", {"P021"}),
    "P022_past_sentinel": (slot_past_sentinel, "merge", {"P022"}),
    "P022_dead_range": (dead_range_slot, "merge", {"P022"}),
    "P030_scrambled": (scrambled_tiles, "merge", None),
    "P031_skipped": (tile_skipped, "merge", {"P031"}),
    "P031_first": (first_flag, "merge", {"P031"}),
    "P032_lrow": (lrow_wrong_row, "merge", {"P032"}),
    "P040_l_pad": (truncated_l_pad, "rowsplit", {"P040"}),
    "P041_wrong_row": (ell_slot_wrong_row, "rowsplit", {"P041"}),
    "P042_pad_row": (live_slot_on_pad_row, "rowsplit", {"P042"}),
    "P050_groups": (bad_group_table, "rowgroup", {"P050"}),
    "P051_inv_pos": (non_permutation, "rowgroup", {"P051"}),
    "P060_bwd": (bwd_missing, "merge", {"P060"}),
    "P021_bwd": (bwd_coverage, "rowsplit", {"P021"}),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_corruption_gives_reference_codes(case, pair, plans):
    corrupt, method, must = MUTATIONS[case]
    jplan, tplan = plans[method]
    ja, ta = pair
    jbad, jcsr_ = corrupt(jplan, ja)
    tbad, tcsr_ = corrupt(tplan, ta)
    if case.startswith(("P001", "P002")):
        # A corrupt CSR is the CSR check's: the plan checks assume a sane
        # row_ptr (the reference's own tests call verify_csr here).
        want, got = jlint.verify_csr(jcsr_), planlint.verify_csr(tcsr_)
        assert [str(d) for d in got] == [str(d) for d in want]
        assert must <= codes(got)
        return
    want = jlint.verify_plan(jbad, jcsr_)
    got = planlint.verify_plan(tbad, tcsr_)
    assert codes(got) == codes(want)
    assert [(d.code, d.where) for d in got] == \
        [(d.code, d.where) for d in want]
    if must is None:                  # the reference asserts any of these
        assert codes(got) & {"P030", "P031", "P032"}
    else:
        assert must <= codes(got)
    if case == "P021_bwd":
        assert any(d.code == "P021" and "bwd" in d.where for d in got)
    with pytest.raises(planlint.PlanVerificationError) as e:
        planlint.check_plan(tbad, tcsr_)
    assert e.value.diagnostics == tuple(got)
    assert f"plan verification failed ({len(got)} finding(s)):" in \
        str(e.value)


def test_unhashable_extra_p010(plans):
    _, tplan = plans["merge"]
    meta = dataclasses.replace(tplan.meta, extra=[1, 2])
    got = planlint.verify_plan(dataclasses.replace(tplan, meta=meta))
    assert "P010" in codes(got)


# ------------------------------------------------------------------- hook ---


@pytest.fixture
def spy(monkeypatch):
    """Counts planlint.verify_plan calls; ``spy.fail`` makes them find a
    P020."""
    calls = []

    class Spy:
        fail = False

    real = planlint.verify_plan

    def verify(plan, a=None):
        calls.append(plan.meta.method)
        if Spy.fail:
            return [planlint.Diagnostic("P020", "plan.fwd", "injected")]
        return real(plan, a)

    monkeypatch.setattr(planlint, "verify_plan", verify)
    Spy.calls = calls
    return Spy


def test_verify_hook_gating_on_build_and_cache_hit(pair, spy):
    _, ta = pair
    prev = set_verify_plans(False)
    try:
        cache = PlanCache()
        plan = cache.get(ta, PlanPolicy(method="merge"))     # off: a build
        cache.get(ta, PlanPolicy(method="merge"))            # off: a hit
        assert spy.calls == []
        assert set_verify_plans(True) is False
        assert _flags.verify_plans is True
        cache.get(ta, PlanPolicy(method="merge"))            # on: a hit
        assert spy.calls == ["merge"]
        build_plan(ta, PlanPolicy(method="rowsplit"))        # on: a build
        assert spy.calls == ["merge", "rowsplit"]
        spy.fail = True
        with pytest.raises(planlint.PlanVerificationError, match="P020"):
            cache.get(ta, PlanPolicy(method="merge"))
        with pytest.raises(planlint.PlanVerificationError, match="P020"):
            PlanCache().get(ta, PlanPolicy(method="rowgroup"))
        assert cache.stats().misses == 1
        assert plan.meta.method == "merge"
    finally:
        set_verify_plans(prev)


def test_verify_hook_env_var():
    code = ("from repro_torch.analysis import _flags; "
            "raise SystemExit(0 if _flags.verify_plans else 1)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    for value, rc in (("1", 0), ("0", 1), ("", 1)):
        env["REPRO_VERIFY_PLANS"] = value
        assert subprocess.run([sys.executable, "-c", code], env=env,
                              timeout=120).returncode == rc, value


# -------------------------------------------------------------------- CLI ---

# The keys of the reference's planlint record (repro.analysis.cli.
# run_planlint).
PAYLOAD_KEYS = {"command", "exit", "suite", "plans_checked", "diagnostics"}


def test_cli_planlint_mini_on_cpu(tmp_path, capsys):
    path = tmp_path / "out" / "planlint.json"
    assert cli.main(["planlint", "--suite", "mini", "--device", "cpu",
                     "--json", str(path)]) == 0
    rec = json.loads(path.read_text())
    assert set(rec) == PAYLOAD_KEYS
    assert rec == {"command": "planlint", "exit": 0, "suite": "mini",
                   "plans_checked": 15, "diagnostics": []}
    assert "15 plan(s) verified on suite 'mini' (cpu), 0 finding(s)" in \
        capsys.readouterr().out
    path = tmp_path / "all.json"
    assert cli.main(["all", "--device", "cpu", "--json", str(path)]) == 0
    rec = json.loads(path.read_text())
    assert rec["command"] == "all" and rec["exit"] == 0
    assert set(rec["legs"]) == {"lint", "planlint", "audit", "traffic"}
    assert set(rec["legs"]["planlint"]) == PAYLOAD_KEYS


def test_cli_planlint_reports_findings(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(planlint, "verify_plan", lambda plan, a=None: [
        planlint.Diagnostic("P021", "plan.fwd", "injected")])
    path = tmp_path / "planlint.json"
    assert cli.main(["planlint", "--device", "cpu", "--json",
                     str(path)]) == 1
    rec = json.loads(path.read_text())
    # One a method plan (9), one a shard of each two-shard plan (2 x 6).
    assert rec["exit"] == 1 and len(rec["diagnostics"]) == 9 + 2 * 6
    assert rec["diagnostics"][0] == {"code": "P021", "where": "plan.fwd",
                                     "message": "injected"}
    assert "plan.fwd: P021 injected" in capsys.readouterr().out


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(SystemExit) as e:
        cli.main(["planlint"])
    assert e.value.code == 2
