"""The port's launch models and the analyses built on them
(``repro_torch.kernels.introspect``, ``repro_torch.analysis.kernel_audit``,
``.access``, ``.lint`` and the ``python -m repro_torch.analysis`` CLI):
clean at this tree, each diagnostic code on its injected fault, the
models' launches equal to the host wrappers' and C entries' arithmetic at
Llama-3.2-1B's FFN shapes on 132 SMs, and the rowgroup permutation and
lint checks against the reference's on the same inputs."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.analysis import access as jaccess  # noqa: E402
from repro.analysis import lint as jlint  # noqa: E402
from repro_torch.analysis import access, cli, kernel_audit, lint  # noqa: E402
from repro_torch.core import PlanPolicy, build_plan, csr  # noqa: E402
from repro_torch.kernels import introspect as I  # noqa: E402
from repro_torch.kernels import (flash_attention, merge_spmm,  # noqa: E402
                                 moe_gemm, registry, rowsplit_spmm, sddmm)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
F32 = kernel_audit.Variant("f32", "float32", "float32", "float32", None,
                           None)


def codes(diags):
    return [d.code for d in diags]


@pytest.fixture(scope="module")
def irregular():
    return kernel_audit.representative("irregular")


@pytest.fixture(scope="module")
def plans(irregular):
    return {m: build_plan(irregular, PlanPolicy(method=m))
            for m in registry.method_names()}


def _models(plan, var=F32, n=256, batch=2):
    spec = registry.get_method(plan.meta.method)
    return spec.traffic(plan, n, batch, var, I.H100_SXM)


def _with_structure(plan, **arrays):
    return dataclasses.replace(plan, fwd={**plan.fwd, **arrays})


# ------------------------------------------------------------ the models ---


def test_every_method_has_a_traffic_hook():
    for name in registry.method_names():
        assert registry.get_method(name).traffic is not None, name


@pytest.mark.parametrize("name,shape,npr", [
    ("w1", (8192, 2048), 512), ("w2", (2048, 8192), 2048)])
def test_llama_grids_match_host_and_c_entry(name, shape, npr):
    # Llama-3.2-1B's FFN at keep 0.25: 4.19 M nonzeros, n = 128, batch 1.
    m, k = shape
    a = csr.random_csr(3, m, k, nnz_per_row=npr)
    n, sms = 128, 132
    rs = _models(build_plan(a, PlanPolicy(method="rowsplit",
                                          with_transpose=False)),
                 n=n, batch=1)
    l = -(-npr // 16) * 16
    r = rowsplit_spmm.row_parts(m, n, l, 1, sms)
    assert r == {"w1": 1, "w2": 2}[name]
    # repro_rowsplit_spmm: warps = batch m n_slices parts, 8 a block.
    assert [x.grid for x in rs] == [(-(-(m * 1 * r) // 8), 1, 1)]
    assert rs[0].block == 256 and rs[0].min_blocks == 4
    assert rs[0].smem == 4 * 8 * 128
    mg = _models(build_plan(a, PlanPolicy(method="merge",
                                          with_transpose=False)),
                 n=n, batch=1)
    n_chunks = a.nnz_pad // 16 + -(-m // 8)
    g = merge_spmm.range_chunks(16)
    workers = -(-n_chunks // g)
    assert g == 64
    assert [x.grid for x in mg] == [(-(-workers // 8), 1, 1),
                                    (-(-(workers + 1) // 8), 1, 1)]
    # Each live slot gathers one 512-byte B row: 2 GB a matrix.
    b_read = {o.name: o.read_bytes for o in rs[0].operands}["b"]
    assert b_read == a.nnz() * n * 4
    assert {o.name: o.read_bytes for o in mg[0].operands}["b"] == b_read


def test_rowsplit_walk_stops_at_the_first_group_with_a_dead_slot():
    # Rows of 40 live slots in an ELL of 128: two groups walked (the
    # second partial), each prefetching the next, so three fetched and
    # the fourth never; 40 B rows; every value gathered.
    a = csr.random_csr(0, 8, 512, nnz_per_row=40)
    plan = build_plan(a, PlanPolicy(method="rowsplit", l_pad=128))
    (model,) = _models(plan, n=128, batch=1)
    ops = {o.name: o.read_bytes for o in model.operands}
    assert ops["cols"] == ops["slot_nz"] == 4 * 8 * 96
    assert ops["vals"] == 4 * 8 * 40
    assert ops["b"] == 4 * 128 * 8 * 40


def test_merge_writers_hold_every_row_once_across_ranges():
    a = kernel_audit.representative("long_rows")
    plan = build_plan(a, PlanPolicy(method="merge"))
    rng, fix = _models(plan)
    split, past = merge_spmm.split_rows(plan.fwd, a.m, 64, a.nnz_pad)
    assert len(split) > 3                      # rows cross ranges
    assert np.array_equal(rng.writers(), np.ones((2, a.m, 2), np.int64))
    assert fix.writers is None


def test_moe_and_flash_models_mirror_the_c_entries():
    be = torch.arange(64, dtype=torch.int32)
    (wg,) = moe_gemm.launch_models(be, tokens=4096, d_in=2048, d_out=1024,
                                   n_experts=64, dtype="bfloat16",
                                   card=I.H100_SXM)
    # min(items, sms x resident): one 116.8 KB block an SM.
    assert wg.symbol == "repro::moe_gemm_wgmma_kernel"
    assert wg.grid == (132, 1, 1) and wg.block == 160
    assert wg.dynamic_smem == 4 * (8192 + 16384) + 64 * 136 * 2 + 1024
    (simt,) = moe_gemm.launch_models(be, tokens=4096, d_in=2048,
                                     d_out=1024, n_experts=64,
                                     dtype="float32", card=I.H100_SXM)
    assert simt.grid == (64, 8, 1) and simt.static_smem == 4 * 32 * (65 + 128)
    (fa,) = flash_attention.launch_models(b=1, s=2048, h=32, kvh=8, dh=64,
                                          dtype="bfloat16")
    assert fa.symbol == "repro::flash_wgmma_kernel<64>"
    assert fa.grid == (32, 11, 1) and fa.block == 512
    assert fa.dynamic_smem == 192 * 128 + 4 * 128 * 128 + 1024
    (mma,) = flash_attention.launch_models(b=2, s=100, h=4, kvh=2, dh=32,
                                           dtype="bfloat16")
    assert mma.symbol == "repro::flash_bf16_kernel<32>"
    assert mma.grid == (8, 2, 1) and mma.static_smem == 2 * 2 * 64 * 40


def test_sddmm_model_counts_rows_once_a_run(plans):
    plan = plans["merge"]
    fwd = plan.fwd
    m, k = plan.meta.shape
    (model,) = sddmm.launch_models(fwd["nz_rows"], fwd["nz_cols"],
                                   fwd["nz_valid"], m=m, k=k, n=128,
                                   batch=1, dc_dtype="float32",
                                   b_dtype="float32")
    ops = {o.name: o.read_bytes for o in model.operands}
    nnz = int(fwd["nz_valid"].sum())
    assert ops["b"] == nnz * 128 * 4
    # Rows change at most once a row within a worker, plus a reload at
    # every worker's start.
    assert m * 512 <= ops["dc"] <= (m + model.grid[0] * 8) * 512
    assert model.static_smem == 1024 + 4 * 8 * 32 * 33


def test_symbol_normalization_matches_profiler_names():
    name = ("void repro::rowsplit_kernel<1, float, float, float>(int const*, "
            "int const*, float const*, float const*, repro::Epilogue, "
            "float*, int, int, int, int, int, int, int, int)")
    assert I.normalize_symbol(name) == I.normalize_symbol(
        I.template("rowsplit_kernel", 1, "float", "float", "float"))


# ------------------------------------------------------------- the audit ---


def test_audit_is_clean_at_this_tree():
    rows, diags = kernel_audit.audit_all()
    assert diags == [], "\n".join(map(str, diags))
    assert {r.method for r in rows} >= set(registry.method_names()) | set(
        access.EXTRA_KERNELS)
    assert all(r.ok for r in rows)


def test_audit_fails_loudly_on_a_method_without_a_model_k001():
    spec = registry.MethodSpec(
        name="_nomodel", description="d",
        build_structure=registry.get_method("merge").build_structure,
        execute=registry.get_method("merge").execute, inline=None,
        resolve_params=registry.get_method("merge").resolve_params,
        tune_candidates=None, heuristic_rank=None, traffic=None)
    registry.register_method(spec)
    try:
        _, diags = kernel_audit.audit_method("_nomodel")
        assert codes(diags) == ["K001"]
        assert ("T101", "_nomodel") in [(d.code, d.where) for d in
                                       access.check_coverage(set())]
    finally:
        registry._REGISTRY.pop("_nomodel")


def test_audit_stale_override_k002():
    kernel_audit.register_audit("_ghost", lambda *a: [])
    try:
        _, diags = kernel_audit.audit_all()
        assert ("K002", "_ghost") in [(d.code, d.where) for d in diags]
    finally:
        kernel_audit._AUDITS.pop("_ghost")


def test_out_of_range_column_k030(plans):
    plan = plans["rowsplit"]
    cols = plan.fwd["cols"].clone()
    live = plan.fwd["slot_nz"] < plan.meta.nnz_pad
    r, s = (int(x) for x in torch.nonzero(live)[5])
    cols[r, s] = plan.meta.k
    (model,) = _models(_with_structure(plan, cols=cols))
    diags, ok = kernel_audit.audit_models("rowsplit", [model], I.H100_SXM)
    assert not ok and codes(diags) == ["K030"]
    assert "cols of live slots" in diags[0].message


def test_live_slot_past_a_sentinel_k030(plans):
    # A dead slot before a live one: the walk ends at its group, so the
    # live slot after it is never reached.
    plan = plans["rowsplit"]
    slot = plan.fwd["slot_nz"].clone()
    slot[0, 0] = plan.meta.nnz_pad
    (model,) = _models(_with_structure(plan, slot_nz=slot))
    assert "before its row's first sentinel" in " ".join(
        kernel_audit.check_in_bounds(model))


def test_merge_row_both_whole_and_fixed_up_k040(plans):
    plan = plans["merge"]
    g = merge_spmm.range_chunks(plan.meta.t)
    tile, first = plan.fwd["tile"].clone(), plan.fwd["first"].clone()
    # Worker 1 opens at a tile three ranges later: S_0 moves into worker
    # 3's range, so that row is stored whole by worker 3 and by the
    # fix-up of S_0.
    tile[g] = tile[4 * g - 1]
    first[g] = 1
    rng, fix = _models(_with_structure(plan, tile=tile, first=first))
    split, _ = merge_spmm.split_rows({**plan.fwd, "tile": tile,
                                      "first": first}, plan.meta.m, g,
                                     plan.meta.nnz_pad)
    assert split[1] > split[2]
    assert "stored more than once" in " ".join(
        kernel_audit.check_single_writer(rng))
    diags, _ = kernel_audit.audit_models("merge", [rng, fix], I.H100_SXM)
    assert "K040" in codes(diags)


def test_shared_memory_and_grid_limits_k020():
    (fa,) = flash_attention.launch_models(b=1, s=256, h=2, kvh=1, dh=128,
                                          dtype="bfloat16")
    assert kernel_audit.check_resources(fa, I.H100_SXM) == []
    big = dataclasses.replace(fa, dynamic_smem=240 * 1024)
    probs = kernel_audit.check_resources(big, I.H100_SXM)
    assert any("opt-in" in p for p in probs)
    diags, _ = kernel_audit.audit_models("flash", [big], I.H100_SXM)
    assert set(codes(diags)) == {"K020"}
    (tall,) = flash_attention.launch_models(b=1, s=64 * 70000, h=1, kvh=1,
                                            dh=32, dtype="bfloat16")
    assert any("grid" in p for p in kernel_audit.check_resources(
        tall, I.H100_SXM))
    two = dataclasses.replace(fa, min_blocks=2)
    assert any("__launch_bounds__" in p for p in
               kernel_audit.check_resources(two, I.H100_SXM))
    empty = dataclasses.replace(fa, grid=(0, 1, 1))
    assert any("0 blocks" in p for p in
               kernel_audit.check_resources(empty, I.H100_SXM))


def test_narrow_accumulator_k050(plans):
    (model,) = _models(plans["rowsplit"])
    narrow = dataclasses.replace(model, acc_dtype="bfloat16")
    diags, _ = kernel_audit.audit_models("rowsplit", [narrow], I.H100_SXM)
    assert codes(diags) == ["K050"]


def test_card_limits_from_the_committed_table_on_the_cpu():
    c = I.card_of("cpu")
    assert (c.sms, c.smem_block_optin, c.smem_sm, c.regs_sm,
            c.threads_sm) == (132, 232_448, 233_472, 65_536, 2048)


# ------------------------------------------------------ coalescing proof ---


def test_access_is_clean_at_this_tree():
    diags = access.check_all()
    assert diags == [], "\n".join(map(str, diags))


@pytest.mark.parametrize("body,dtype", [("f32x4", "float32"),
                                        ("bf16x8", "bfloat16"),
                                        ("scalar", "float32")])
def test_strided_b_load_fires_t110(plans, body, dtype):
    var = kernel_audit.Variant(dtype, dtype, dtype, "float32", None, None)
    n = 256 if body != "scalar" else 254
    (model,) = _models(plans["rowsplit"], var=var, n=n)
    assert model.body == body
    assert access.check_launch(model) == []
    k, isz = plans["rowsplit"].meta.k, I.nbytes(dtype)
    # B read column-major: neighbouring lanes a whole column apart.
    strided = I.WarpAccess("B column", (I.lanes(0, k * isz, isz),))
    ops = tuple(dataclasses.replace(o, warp=(strided,)) if o.name == "b"
                else o for o in model.operands)
    diags = access.check_launch(dataclasses.replace(model, operands=ops))
    assert codes(diags) == ["T110"]


def test_backward_stream_fires_t120(plans):
    plan = plans["merge"]
    slot = plan.fwd["slot_nz"].clone()
    live = torch.nonzero(slot.reshape(-1) < plan.meta.nnz_pad)[:, 0]
    i, j = int(live[3]), int(live[4])
    flat = slot.reshape(-1)
    flat[i], flat[j] = flat[j].clone(), flat[i].clone()
    rng, _ = _models(_with_structure(plan, slot_nz=slot))
    assert codes(access.check_launch(rng)) == ["T120"]


def test_rowgroup_mutations_give_the_reference_codes_t130_t131():
    # The port's rowgroup plan (its structure is array-equal to the
    # reference's, tests/test_torch_rowgroup.py) and the same mutated
    # numpy inv_pos through both packages' checkers.
    tplan = build_plan(kernel_audit.representative("irregular"),
                       PlanPolicy(method="rowgroup"))
    inv = tplan.fwd["inv_pos"].numpy().copy()

    def both(inv_pos):
        j = jaccess.check_rowgroup_plan(types.SimpleNamespace(
            meta=tplan.meta, fwd={"inv_pos": inv_pos}))
        t = access.check_rowgroup_plan(types.SimpleNamespace(
            meta=tplan.meta, fwd={"inv_pos": torch.from_numpy(inv_pos)}))
        return codes(j), codes(t)

    assert both(inv) == ([], [])
    dup = inv.copy()
    dup[1] = dup[0]
    j, t = both(dup)
    assert j == t == ["T130"]
    order = np.argsort(inv)
    start = 0
    for m_g, _ in tplan.meta.extra:
        if m_g > 1:
            r0, r1 = order[start], order[start + 1]
            swapped = inv.copy()
            swapped[r0], swapped[r1] = inv[r1], inv[r0]
            break
        start += m_g
    j, t = both(swapped)
    assert j == t and "T131" in t


def test_coverage_is_bidirectional_t101_t102(monkeypatch):
    pruned = {k: v for k, v in access.EXTRA_KERNELS.items() if k != "sddmm"}
    monkeypatch.setattr(access, "EXTRA_KERNELS", pruned)
    diags = access.check_all()
    assert ("T101", "csrc/sddmm.cu:sddmm_kernel") in [
        (d.code, d.where) for d in diags]
    stale = dict(access.EXTRA_KERNELS, ghost=lambda *a: [])
    monkeypatch.setattr(access, "EXTRA_KERNELS", stale)
    assert ("T102", "repro_torch.kernels.ghost") in [
        (d.code, d.where) for d in access.check_coverage()]
    # A model of a kernel no source defines is stale too.
    assert ("T102", "gone_kernel") in [
        (d.code, d.where) for d in access.check_coverage(
            set(access.defined_kernels()) | {"gone_kernel"})]


def test_every_global_kernel_is_found():
    assert set(access.defined_kernels()) == {
        "rowsplit_kernel", "merge_range_kernel", "merge_fixup_kernel",
        "sddmm_kernel", "moe_gemm_f32_kernel", "moe_gemm_bf16_kernel",
        "moe_gemm_wgmma_kernel", "flash_bf16_kernel", "flash_wgmma_kernel",
        "flash_f32_kernel"}


# ------------------------------------------------------------------ lint ---


LINT_FIXTURE = """\
from repro import spmm
c = spmm(a, b, method="merge", interpret=True)
d = spmm(a, b, policy)
e = get_plan(a, l_pad=32)
f = execute_plan(plan, vals, b, impl="xla")    # noqa: RL002
spec = MethodSpec(name="x", description="d", build_structure=f,
                  execute=g, inline=h)
ok = registry.MethodSpec(
    name="y", description="d", build_structure=f, execute=g, inline=h,
    resolve_params=r, tune_candidates=None, heuristic_rank=None,
    traffic=None)
pos = MethodSpec("z")
"""


def test_rl002_rl003_match_the_reference(tmp_path):
    p = tmp_path / "fixture.py"
    p.write_text(LINT_FIXTURE)

    def found(mod):
        return sorted((d.code, int(d.where.rsplit(":", 1)[1]))
                      for d in mod.lint_file(str(p))
                      if d.code in ("RL002", "RL003"))

    assert found(lint) == found(jlint)
    assert found(lint) == [("RL002", 2), ("RL002", 4), ("RL003", 6),
                           ("RL003", 12)]


def test_rl001_host_sync_in_jit(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent("""
        import jax, numpy as np

        @jax.jit
        def f(x):
            return np.asarray(x) + x.item()

        @jax.jit
        def g(x):
            return x.item()    # noqa: RL001

        def host_only(x):
            return float(np.asarray(x))
    """))
    assert codes(lint.lint_file(str(p))) == ["RL001", "RL001"]


def test_rl001_host_sync_in_cuda_graph_capture(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent("""
        import torch

        def capture(fn, x, g):
            n = x.sum().item()
            with torch.cuda.graph(g):
                y = fn(x)
                scale = float(y.max())
                rows = y.cpu()
                ok = y.tolist()    # noqa: RL001
            return n, scale, rows, ok
    """))
    diags = lint.lint_file(str(p))
    assert [(d.code, int(d.where.rsplit(":", 1)[1])) for d in diags] == [
        ("RL001", 8), ("RL001", 9)]
    assert all("CUDA graph capture" in d.message for d in diags)


def test_port_tree_lints_clean():
    roots = lint.default_roots(os.path.abspath(ROOT))
    assert any(r.endswith("chip_smoke.py") for r in roots)
    assert any(r.endswith("test_torch_analysis.py") for r in roots)
    diags = lint.run_lint(repo_root=os.path.abspath(ROOT))
    assert diags == [], "\n".join(map(str, diags))


# ------------------------------------------------------------------- CLI ---


def test_cli_lint_exit_codes(tmp_path):
    good = tmp_path / "good.py"
    good.write_text("def f(x):\n    return x.item()\n")
    assert cli.run_repo_lint([str(good)], out=open(os.devnull, "w")) == 0
    bad = tmp_path / "bad.py"
    bad.write_text("import jax\n@jax.jit\ndef f(x):\n    return x.item()\n")
    assert cli.run_repo_lint([str(bad)], out=open(os.devnull, "w")) == 1


def test_cli_audit_report_and_json(tmp_path):
    report, path = tmp_path / "audit.txt", tmp_path / "audit.json"
    assert cli.main(["audit", "--device", "cpu", "--out", str(report),
                     "--json", str(path)]) == 0
    rec = json.loads(path.read_text())
    assert rec["command"] == "audit" and rec["exit"] == 0
    assert rec["diagnostics"] == [] and rec["rows"]
    assert "no findings" in report.read_text()


def test_cli_without_a_card_asks_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        cli.main(["audit"])


def test_module_all_on_the_cpu_writes_nested_json(tmp_path):
    path = tmp_path / "all.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "all", "--device",
         "cpu", "--json", str(path)], capture_output=True, text=True,
        env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rec = json.loads(path.read_text())
    assert rec["command"] == "all" and rec["exit"] == 0
    assert set(rec["legs"]) == {"lint", "planlint", "audit", "traffic"}
    for leg, payload in rec["legs"].items():
        assert payload["command"] == leg and payload["exit"] == 0
        assert payload["diagnostics"] == []
    assert rec["legs"]["traffic"]["checked_baseline"] is True
