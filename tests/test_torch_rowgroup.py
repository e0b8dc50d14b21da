"""The row-grouped SpMM method and the plan-per-call ``spmm(plan="inline")``
regime in the port, against the JAX reference on the same numpy inputs.

Rowgroup buckets rows by the octave of their length and runs the
row-split kernel once per bucket; on the CPU each bucket runs the
kernel's plain version, and ``ref.rowsplit_schedule_ref`` replays the
kernel's schedule per bucket with the row parts the card would use.

Tolerances are the reference's: f32 rtol/atol 2e-5 and bf16 2e-2
(tests/test_kernels.py), gradients rtol 1e-4 / atol 1e-5
(tests/test_spmm_grad.py).  Integer structures are array-equal.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CSR as JCSR  # noqa: E402
from repro.core import Epilogue as JEpilogue  # noqa: E402
from repro.core import ExecutionConfig as JExecutionConfig  # noqa: E402
from repro.core import PlanPolicy as JPlanPolicy  # noqa: E402
from repro.core import build_plan as jbuild_plan  # noqa: E402
from repro.core import execute_plan as jexecute_plan  # noqa: E402
from repro.core import spmm as jspmm  # noqa: E402
from repro.kernels import rowgroup_spmm as jrowgroup  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (CSR, Epilogue, ExecutionConfig,  # noqa: E402
                              PlanPolicy, build_plan, execute_plan,
                              power_law_csr, random_csr, spmm)
from repro_torch.kernels import (ref, registry, rowgroup_spmm,  # noqa: E402
                                 rowsplit_spmm)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
GRAD = dict(rtol=1e-4, atol=1e-5)
N = 24
SMS = 132                       # the H100's SMs, for the row-parts rule


def _long_rows(seed=0):
    """Four rows of 1100-1900 nonzeros among 60 of 0-40: the long rows form
    a bucket of their own, 4 rows of 60 groups of 32 slots, which the
    row-parts rule splits in 8."""
    rng = np.random.default_rng(seed)
    m, k = 64, 4096
    lengths = rng.integers(0, 41, m)
    lengths[[3, 17, 40, 41]] = [1100, 1900, 1500, 1800]
    row_ptr = np.zeros(m + 1, np.int32)
    np.cumsum(lengths, out=row_ptr[1:])
    cols = np.concatenate([np.sort(rng.choice(k, n, replace=False))
                           for n in lengths]).astype(np.int32)
    vals = (rng.standard_normal(cols.shape[0]) * k ** -0.5).astype(
        np.float32)
    return convert.csr_from_numpy(row_ptr, cols, vals, (m, k), device="cpu")


PATTERNS = {
    "irregular": lambda: random_csr(1, 48, 64, nnz_per_row=(0, 24)),
    "regular": lambda: random_csr(2, 40, 96, nnz_per_row=33),
    "short_rows": lambda: random_csr(3, 96, 64, nnz_per_row=(0, 4)),
    "empty_heavy": lambda: random_csr(4, 64, 32, nnz_per_row=(0, 2)),
    "power_law": lambda: power_law_csr(11, 512, 512, 4.0, alpha=1.6),
    "long_rows": _long_rows,
    "zero_nnz": lambda: random_csr(5, 16, 8, nnz_per_row=0),
    "m0": lambda: CSR(torch.zeros(1, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32),
                      torch.zeros(1), (0, 8)),
}


@functools.lru_cache(maxsize=None)
def _pattern(name):
    """(port CSR, reference CSR) on the same arrays."""
    ta = PATTERNS[name]()
    ja = JCSR(*(jnp.asarray(t.numpy()) for t in (ta.row_ptr, ta.col_ind,
                                                 ta.vals)), ta.shape)
    return ta, ja


@pytest.mark.parametrize("tl", [8, 16])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_group_rows_matches_reference(name, tl):
    ta, ja = _pattern(name)
    order, groups = rowgroup_spmm.group_rows(ta.row_ptr, tl)
    jorder, jgroups = jrowgroup.group_rows(ja.row_ptr, tl)
    np.testing.assert_array_equal(order, np.asarray(jorder))
    assert groups == jgroups
    assert sum(m_g for m_g, _ in groups) == ta.m
    # Memoised on the live tensor: a second call returns the same objects.
    assert rowgroup_spmm.group_rows(ta.row_ptr, tl)[0] is order


def test_rows_of_length_0_and_1_share_bucket_0():
    row_ptr = torch.tensor([0, 0, 1, 3, 3, 4], dtype=torch.int32)
    order, groups = rowgroup_spmm.group_rows(row_ptr, 8)
    assert order.tolist() == [0, 1, 3, 4, 2] and groups == ((4, 8), (1, 8))


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_structure_matches_reference(name):
    ta, ja = _pattern(name)
    got = rowgroup_spmm.plan_rowgroup_structure(ta)
    want = jrowgroup.plan_rowgroup_structure(ja)
    np.testing.assert_array_equal(got["inv_pos"].numpy(),
                                  np.asarray(want["inv_pos"]))
    assert got["inv_pos"].dtype == torch.int32
    assert len(got["groups"]) == len(want["groups"])
    for g, w in zip(got["groups"], want["groups"]):
        for key in ("cols", "slot_nz"):
            assert g[key].dtype == torch.int32
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]),
                                          err_msg=key)


EPILOGUES = {
    "none": None,
    "bias": dict(bias=True),
    "bias_gelu_scale_residual": dict(bias=True, activation="gelu",
                                     scale=0.5, residual=True),
    "relu": dict(activation="relu"),
    "residual": dict(residual=True),
}
DTYPES = {"f32": (jnp.float32, torch.float32, F32),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _operands(ta, lead, seed=0):
    rng = np.random.default_rng(seed)
    m, k = ta.shape
    # The bias is not symmetric under the grouping permutation: a bias
    # applied in original row order instead of group order shows.
    return dict(vals=ta.vals.numpy(),
                b=rng.standard_normal(lead + (k, N)).astype(np.float32),
                bias=(np.arange(m, dtype=np.float32) - m / 2) / 7.0,
                res=rng.standard_normal(lead + (m, N)).astype(np.float32))


def _kwargs(spec, x, lib):
    kw = {}
    if spec is None:
        return kw
    kw["epilogue"] = (JEpilogue if lib == "jax" else Epilogue)(**spec)
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    if spec.get("bias"):
        kw["bias"] = conv(x["bias"])
    if spec.get("residual"):
        kw["residual"] = conv(x["res"])
    return kw


@pytest.mark.parametrize("lead", [(), (2,)], ids=["2d", "batched"])
@pytest.mark.parametrize("ep_name", sorted(EPILOGUES))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", ["irregular", "power_law", "long_rows",
                                  "zero_nnz", "m0"])
def test_execute_matches_reference(name, dt, ep_name, lead):
    """The plain rowgroup execution against the reference's impl="xla"."""
    ta, ja = _pattern(name)
    jdt, tdt, tol = DTYPES[dt]
    spec = EPILOGUES[ep_name]
    x = _operands(ta, lead)
    plan = build_plan(ta, PlanPolicy(method="rowgroup",
                                     with_transpose=False))
    jfwd = jrowgroup.plan_rowgroup_structure(ja)
    want = jrowgroup.rowgroup_execute_parts(
        plan.meta.extra, plan.meta.tl, jfwd, jnp.asarray(x["vals"], jdt),
        jnp.asarray(x["b"], jdt), impl="xla", **_kwargs(spec, x, "jax"))
    got = rowgroup_spmm.rowgroup_execute_parts(
        plan.meta.extra, plan.fwd, torch.from_numpy(x["vals"]).to(tdt),
        torch.from_numpy(x["b"]).to(tdt), impl="torch",
        **_kwargs(spec, x, "torch"))
    assert got.dtype == tdt
    assert tuple(got.shape) == tuple(want.shape) == lead + (ta.m, N)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("ep_name", ["none", "bias_gelu_scale_residual"])
@pytest.mark.parametrize("name", ["irregular", "power_law", "long_rows",
                                  "zero_nnz"])
def test_schedule_per_bucket_matches_reference(name, ep_name):
    """Each bucket through ``ref.rowsplit_schedule_ref`` with the parts r
    the card's rule gives it, groups concatenated, rows un-permuted and the
    residual added after, against the reference's rowgroup."""
    ta, ja = _pattern(name)
    spec = EPILOGUES[ep_name]
    x = _operands(ta, ())
    plan = build_plan(ta, PlanPolicy(method="rowgroup",
                                     with_transpose=False))
    b = torch.from_numpy(x["b"])
    kw = _kwargs(spec, x, "torch")
    ep = kw.get("epilogue")
    group_ep = None if ep is None else dataclasses.replace(ep,
                                                           residual=False)
    bias_perm = None
    if ep is not None and ep.bias:
        bias_perm = torch.empty_like(kw["bias"])
        bias_perm[plan.fwd["inv_pos"].long()] = kw["bias"]
        assert torch.equal(bias_perm, kw["bias"][torch.from_numpy(
            rowgroup_spmm.group_rows(ta.row_ptr, plan.meta.tl)[0])])
    outs, parts, start = [], [], 0
    for (m_g, l_g), gs in zip(plan.meta.extra, plan.fwd["groups"]):
        r = rowsplit_spmm.row_parts(m_g, N, l_g, 1, SMS)
        parts.append(r)
        outs.append(ref.rowsplit_schedule_ref(
            gs, torch.from_numpy(x["vals"]), b, m_g, r, epilogue=group_ep,
            bias=None if bias_perm is None
            else bias_perm[start:start + m_g]))
        start += m_g
    got = torch.cat(outs, -2).index_select(-2, plan.fwd["inv_pos"])
    if ep is not None and ep.residual:
        got = got + kw["residual"]
    if name == "long_rows":
        assert 8 in parts, parts          # the long rows' buckets split
    want = jrowgroup.rowgroup_execute_parts(
        plan.meta.extra, plan.meta.tl, jrowgroup.plan_rowgroup_structure(ja),
        jnp.asarray(x["vals"]), jnp.asarray(x["b"]), impl="xla",
        **_kwargs(spec, x, "jax"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_long_rows_bucket_parts():
    """A bucket of few long rows gets the most parts, the short rows'
    bucket none: the structure row parts are for."""
    ta, _ = _pattern("long_rows")
    _, groups = rowgroup_spmm.group_rows(ta.row_ptr, 16)
    rules = {(m_g, l_g): rowsplit_spmm.row_parts(m_g, 128, l_g, 1, SMS)
             for m_g, l_g in groups}
    assert groups[-1] == (4, 1904)        # the four long rows' octave
    assert rules[groups[-1]] == 8 and rules[groups[0]] == 1


INLINE_METHODS = ["auto", "merge", "rowsplit", "rowgroup"]


@pytest.mark.parametrize("ep_name", ["none", "bias_gelu_scale_residual"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("method", INLINE_METHODS)
def test_inline_matches_reference(method, dt, ep_name):
    """``spmm(plan="inline")``: one resolution, the method's plan-per-call
    form, then the epilogue and the dtype contract, against the
    reference's inline path."""
    ta, ja = _pattern("irregular")
    jdt, tdt, tol = DTYPES[dt]
    spec = EPILOGUES[ep_name]
    x = _operands(ta, ())
    # The reference's inline merge under impl="xla" multiplies and sums in
    # the operand dtype (repro/kernels/ref.py spmm_merge_ref), so in bf16 it
    # carries bf16 partial sums; the port, like the reference's kernel,
    # accumulates in f32.  So bf16 merge is held to the reference's Pallas
    # kernel, in interpret mode as its own tests run it.
    pallas = dt == "bf16" and method == "merge"
    want = jspmm(JCSR(ja.row_ptr, ja.col_ind, jnp.asarray(x["vals"], jdt),
                      ja.shape),
                 jnp.asarray(x["b"], jdt),
                 JPlanPolicy(method=method, tunedb=None),
                 JExecutionConfig(impl="pallas" if pallas else "xla",
                                  interpret=True if pallas else None,
                                  epilogue=JEpilogue(**spec)
                                  if spec else None),
                 plan="inline", **{k: v for k, v in _kwargs(
                     spec, x, "jax").items() if k != "epilogue"})
    a = dataclasses.replace(ta, vals=torch.from_numpy(x["vals"]).to(tdt))
    kw = _kwargs(spec, x, "torch")
    ep = kw.pop("epilogue", None)
    got = spmm(a, torch.from_numpy(x["b"]).to(tdt), PlanPolicy(method=method),
               ExecutionConfig(impl="torch", epilogue=ep), plan="inline",
               **kw)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("method", ["merge", "rowsplit", "rowgroup"])
def test_inline_equals_planned(method):
    """On the same device the two regimes pick the same kernel and give the
    same C; the inline path builds no plan in the engine cache."""
    from repro_torch.engine import cache_stats
    ta, _ = _pattern("power_law")
    b = torch.from_numpy(_operands(ta, ())["b"])
    before = cache_stats().misses
    got = spmm(ta, b, PlanPolicy(method=method), plan="inline")
    assert cache_stats().misses == before
    want = spmm(ta, b, PlanPolicy(method=method))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


def test_inline_refusals(monkeypatch):
    ta, _ = _pattern("irregular")
    b3 = torch.zeros(2, ta.k, 4)
    with pytest.raises(ValueError, match="2-D B"):
        spmm(ta, b3, plan="inline")
    with pytest.raises(ValueError, match="plan must be"):
        spmm(ta, b3[0], plan="cached")
    spec = registry.get_method("rowgroup")
    monkeypatch.setitem(registry._REGISTRY, "rowgroup",
                        dataclasses.replace(spec, inline=None))
    with pytest.raises(ValueError, match="no inline"):
        spmm(ta, b3[0], PlanPolicy(method="rowgroup"), plan="inline")
    with pytest.raises(ValueError, match="l_pad"):
        spmm(ta, b3[0], PlanPolicy(method="rowsplit", l_pad=1),
             plan="inline")
    with pytest.raises(ValueError, match="impl='cuda'"):
        spmm(ta, b3[0], PlanPolicy(method="merge"),
             ExecutionConfig(impl="cuda"), plan="inline")


@pytest.mark.parametrize("name", ["irregular", "long_rows"])
def test_gradient_through_a_rowgroup_plan(name):
    """dvals and dB through a rowgroup plan (the transpose merge plan and
    SDDMM, as for any method) against the reference's VJP."""
    ta, ja = _pattern(name)
    rng = np.random.default_rng(9)
    b = 0.25 * rng.standard_normal((ta.k, N)).astype(np.float32)
    bias = rng.standard_normal(ta.m).astype(np.float32)
    ct = rng.standard_normal((ta.m, N)).astype(np.float32)
    ep = dict(bias=True, activation="gelu")
    jp = jbuild_plan(ja, policy=JPlanPolicy(method="rowgroup", tunedb=None))
    jexec = JExecutionConfig(impl="xla", epilogue=JEpilogue(**ep))
    _, vjp = jax.vjp(lambda v, bb, bi: jexecute_plan(jp, v, bb, jexec,
                                                     bias=bi),
                     ja.vals, jnp.asarray(b), jnp.asarray(bias))
    want = vjp(jnp.asarray(ct))
    tp = build_plan(ta, PlanPolicy(method="rowgroup"))
    assert tp.meta.method == "rowgroup" and tp.bwd is not None
    args = [ta.vals.clone().requires_grad_(),
            torch.from_numpy(b).requires_grad_(),
            torch.from_numpy(bias).requires_grad_()]
    out = execute_plan(tp, args[0], args[1],
                       ExecutionConfig(impl="torch",
                                       epilogue=Epilogue(**ep)),
                       bias=args[2])
    got = torch.autograd.grad(out, args, torch.from_numpy(ct))
    for g, w, what in zip(got, want, ("dvals", "db", "dbias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD,
                                   err_msg=what)


def test_registry_lists_three_methods():
    assert registry.method_names() == ("merge", "rowsplit", "rowgroup")
    spec = registry.get_method("rowgroup")
    assert spec.heuristic_rank is None          # opt-in, never "auto"
    assert all(registry.get_method(n).inline is not None
               for n in registry.method_names())
    ta, _ = _pattern("power_law")
    assert PlanPolicy().resolve(ta).method != "rowgroup"


def test_rowgroup_rejects_a_global_l_pad():
    ta, _ = _pattern("irregular")
    with pytest.raises(ValueError, match="l_pad"):
        build_plan(ta, PlanPolicy(method="rowgroup", l_pad=64))


def test_m0_gives_an_empty_result():
    ta, _ = _pattern("m0")
    plan = build_plan(ta, PlanPolicy(method="rowgroup"))
    assert plan.meta.extra == () and plan.fwd["groups"] == ()
    out = execute_plan(plan, ta.vals, torch.ones(2, 8, 5))
    assert tuple(out.shape) == (2, 0, 5) and out.dtype == torch.float32


def test_cpu_runs_count_no_launch_and_cuda_raises():
    ta, _ = _pattern("long_rows")
    plan = build_plan(ta, PlanPolicy(method="rowgroup"))
    b = torch.ones(ta.k, 8)
    before = (rowsplit_spmm.LAUNCHES, dict(rowsplit_spmm.LAUNCHES_BY_BODY))
    execute_plan(plan, ta.vals, b)
    assert (rowsplit_spmm.LAUNCHES,
            rowsplit_spmm.LAUNCHES_BY_BODY) == before
    with pytest.raises(ValueError, match="impl='cuda'"):
        execute_plan(plan, ta.vals, b, ExecutionConfig(impl="cuda"))
