"""The port's differentiable SpMM against the JAX reference's custom VJP.

The same numpy inputs (pattern, values, B, bias, residual and the output
cotangent) go through ``torch.autograd.grad`` over the port's
``execute_plan`` (``impl="torch"``: the plain versions the CPU runs, with
the same backward structure the card runs — the transpose merge plan, its
composed ``slot_nz``, the SDDMM masking) and through ``jax.vjp`` over the
reference's ``execute_plan``: Pallas in interpret mode for one case per
method and epilogue, ``impl="xla"`` for the rest of the grid.

Tolerances: f32 rtol 1e-4 / atol 1e-5 (tests/test_spmm_grad.py), bf16
1e-1 (tests/test_epilogue.py: bf16 operands rounded at other places, and
f32 sums in other orders).
"""
import dataclasses

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
from repro.core.plan import PlanMeta as JPlanMeta  # noqa: E402
from repro.core.plan import SpmmPlan as JSpmmPlan  # noqa: E402
from repro.core.epilogue import activation_fn as jactivation_fn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (Epilogue, ExecutionConfig,  # noqa: E402
                              PlanPolicy, build_plan, execute_plan,
                              random_csr)
from repro_torch.core.epilogue import activation_grad  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

KINDS = {
    "regular_long": (64, 96, 33),
    "irregular": (48, 64, (0, 24)),
    "short_rows": (96, 64, (0, 4)),
    "empty_heavy": (64, 32, (0, 2)),
    "single_row": (1, 128, 64),
    "single_col": (64, 1, 1),
}
EPILOGUES = {
    "none": None,
    "bias_gelu": dict(bias=True, activation="gelu"),
    "relu_scale_residual": dict(activation="relu", scale=0.5,
                                residual=True),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=1e-1, atol=1e-1)}
N = 24
# B at a quarter scale keeps the pre-activations O(1), as after a norm: at
# |C| ≈ 17 (unit B, 24 nonzeros a row) the reference's own f32 gelu
# derivative lands 2e-5 off the float64 answer, past the f32 tolerance.
B_SCALE = 0.25


def _jplan_of(tp):
    """The reference SpmmPlan holding the port plan's arrays.  The two
    planners are array-equal (tests/test_torch_plan.py), so the big grid
    skips the reference planner's per-shape compiles; the Pallas cases
    below plan with the reference's own planner."""
    arrays = lambda d: None if d is None else {
        name: jnp.asarray(t.numpy()) for name, t in d.items()}
    return JSpmmPlan(fwd=arrays(tp.fwd), bwd=arrays(tp.bwd),
                     meta=JPlanMeta(**dataclasses.asdict(tp.meta)))


def _problem(m, k, npr, method, lead, seed=0, pad_to=None,
             ref_planner=False):
    """One problem in both packages: plans and the numpy operands."""
    ta = random_csr(seed, m, k, nnz_per_row=npr, pad_to=pad_to)
    rng = np.random.default_rng(seed + 1)
    x = dict(vals=ta.vals.numpy(),
             b=B_SCALE * rng.standard_normal(lead + (k, N)).astype(
                 np.float32),
             bias=rng.standard_normal(m).astype(np.float32),
             res=rng.standard_normal(lead + (m, N)).astype(np.float32),
             ct=rng.standard_normal(lead + (m, N)).astype(np.float32))
    tp = build_plan(ta, PlanPolicy(method=method))
    if ref_planner:
        ja = JCSR(*(jnp.asarray(t.numpy()) for t in (
            ta.row_ptr, ta.col_ind, ta.vals)), ta.shape)
        jp = jbuild_plan(ja, policy=JPlanPolicy(method=method, tunedb=None))
    else:
        jp = _jplan_of(tp)
    return jp, tp, x, ta.nnz()


def _grads_both(jp, tp, x, dt, ep_name, impl="xla"):
    """(reference, port) cotangents of (vals, b, bias, residual), as f32
    numpy arrays (None where the epilogue has no such operand)."""
    jdt, tdt = DTYPES[dt]
    spec = EPILOGUES[ep_name]
    has_bias = bool(spec and spec.get("bias"))
    has_res = bool(spec and spec.get("residual"))
    jexec = JExecutionConfig(impl=impl, interpret=True if impl == "pallas"
                             else None,
                             epilogue=JEpilogue(**spec) if spec else None)

    @jax.jit
    def jvjp(vals, b, bias, res, ct):
        out, vjp = jax.vjp(lambda *a: jexecute_plan(
            jp, a[0], a[1], jexec, bias=a[2], residual=a[3]),
            vals, b, bias, res)
        return out, vjp(ct.astype(out.dtype))

    jout, jgrads = jvjp(jnp.asarray(x["vals"], jdt),
                        jnp.asarray(x["b"], jdt),
                        jnp.asarray(x["bias"]) if has_bias else None,
                        jnp.asarray(x["res"]) if has_res else None,
                        jnp.asarray(x["ct"]))

    targs = [torch.from_numpy(x["vals"]).to(tdt).requires_grad_(),
             torch.from_numpy(x["b"]).to(tdt).requires_grad_(),
             torch.from_numpy(x["bias"]).requires_grad_()
             if has_bias else None,
             torch.from_numpy(x["res"]).requires_grad_()
             if has_res else None]
    texec = ExecutionConfig(impl="torch",
                            epilogue=Epilogue(**spec) if spec else None)
    tout = execute_plan(tp, targs[0], targs[1], texec, bias=targs[2],
                        residual=targs[3])
    assert tout.dtype == tdt and tuple(tout.shape) == tuple(jout.shape)
    live = [t for t in targs if t is not None]
    tg = iter(torch.autograd.grad(
        tout, live, torch.from_numpy(x["ct"]).to(tout.dtype)))
    tgrads = [None if t is None else next(tg) for t in targs]
    for g, t in zip(tgrads, targs):
        if t is not None:
            assert g.dtype == t.dtype and g.shape == t.shape
    f32 = lambda g: None if g is None else np.asarray(
        g.float() if isinstance(g, torch.Tensor) else g, np.float32)
    return [f32(g) for g in jgrads], [f32(g) for g in tgrads]


def _check(jp, tp, x, dt, ep_name, impl="xla"):
    want, got = _grads_both(jp, tp, x, dt, ep_name, impl)
    for name, w, g in zip(("dvals", "dB", "d_bias", "d_res"), want, got):
        assert (w is None) == (g is None), name
        if w is not None:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL[dt])
    return got


# The epilogue's chain rule does not depend on the pattern, so the six
# kinds run without one and the epilogues run on one kind; each of them on
# 2-D and on batched B.  (Every case is one XLA compile on the reference
# side: the full product would cost the CPU suite a minute.)
LEADS = pytest.mark.parametrize("lead", [(), (2,)], ids=["2d", "batched"])
METHODS = pytest.mark.parametrize("method", ["merge", "rowsplit"])


@LEADS
@METHODS
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_grad_matches_reference_f32(kind, method, lead):
    m, k, npr = KINDS[kind]
    jp, tp, x, nnz = _problem(m, k, npr, method, lead)
    dvals = _check(jp, tp, x, "f32", "none")[0]
    assert not np.any(dvals[nnz:])


@LEADS
@METHODS
@pytest.mark.parametrize("ep_name", ["bias_gelu", "relu_scale_residual"])
def test_grad_epilogues_match_reference_f32(ep_name, method, lead):
    m, k, npr = KINDS["irregular"]
    jp, tp, x, nnz = _problem(m, k, npr, method, lead, seed=1)
    dvals = _check(jp, tp, x, "f32", ep_name)[0]
    assert not np.any(dvals[nnz:])


@pytest.mark.parametrize("ep_name", sorted(EPILOGUES))
@METHODS
def test_grad_matches_reference_pallas(method, ep_name):
    """The reference's Pallas kernels (interpret mode) under its custom
    VJP: merge on the transpose plan and the SDDMM kernel."""
    m, k, npr = KINDS["irregular"]
    jp, tp, x, _ = _problem(m, k, npr, method, (2,), seed=7,
                            ref_planner=True)
    _check(jp, tp, x, "f32", ep_name, impl="pallas")


@pytest.mark.parametrize("ep_name", sorted(EPILOGUES))
@METHODS
def test_grad_matches_reference_bf16(method, ep_name):
    m, k, npr = KINDS["irregular"]
    jp, tp, x, _ = _problem(m, k, npr, method, (2,), seed=3)
    _check(jp, tp, x, "bf16", ep_name)


@pytest.mark.parametrize("case", ["zero_nnz", "zero_rows", "padded",
                                  "empty_rows"])
@METHODS
def test_grad_degenerate_patterns(method, case):
    """Padded slots get a zero cotangent; 0-nnz and m == 0 patterns give
    all-zero dvals and dB without a kernel to run."""
    m, k, npr, pad_to = {"zero_nnz": (12, 8, 0, None),
                         "zero_rows": (0, 8, 0, None),
                         "padded": (16, 12, (0, 3), 64),
                         "empty_rows": (16, 12, (0, 2), None)}[case]
    jp, tp, x, nnz = _problem(m, k, npr, method, (2,), seed=5,
                              pad_to=pad_to)
    dvals, db = _check(jp, tp, x, "f32", "bias_gelu")[:2]
    assert not np.any(dvals[nnz:])
    if nnz == 0:
        assert not np.any(dvals) and not np.any(db)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["2d", "batched"])
@pytest.mark.parametrize("kind", ["irregular", "empty_heavy", "single_col"])
def test_sddmm_matches_reference_kernel(kind, lead):
    """ops.sddmm's plain version against the reference's Pallas SDDMM
    (interpret mode), per batch element, at the forward's 2e-5."""
    m, k, npr = KINDS[kind]
    ta = random_csr(11, m, k, nnz_per_row=npr, pad_to=None)
    fwd = build_plan(ta, PlanPolicy(method="merge")).fwd
    coords = [fwd[n] for n in ("nz_rows", "nz_cols", "nz_valid")]
    rng = np.random.default_rng(12)
    dc = rng.standard_normal(lead + (m, 40)).astype(np.float32)
    b = rng.standard_normal(lead + (k, 40)).astype(np.float32)
    want = jops.sddmm(*(jnp.asarray(c.numpy()) for c in coords),
                      jnp.asarray(dc), jnp.asarray(b), impl="pallas",
                      interpret=True)
    got = ops.sddmm(*coords, torch.from_numpy(dc), torch.from_numpy(b),
                    impl="torch")
    assert tuple(got.shape) == tuple(want.shape) == lead + (ta.nnz_pad,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_activation_grad_matches_jax_vjp(act):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    x[500] = 0.0
    g = np.random.default_rng(0).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(jactivation_fn(act), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = activation_grad(act, torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_forward_only_plan_stays_differentiable_on_plain_version():
    """Without a transpose, impl="torch" is ordinary autograd through the
    plain version and gives the same gradients; impl="cuda" refuses."""
    m, k, npr = KINDS["irregular"]
    ta = random_csr(0, m, k, nnz_per_row=npr)
    fo = build_plan(ta, PlanPolicy(method="merge", with_transpose=False))
    tp = build_plan(ta, PlanPolicy(method="merge"))
    assert fo.bwd is None and tp.bwd is not None
    rng = np.random.default_rng(2)
    b_np = rng.standard_normal((k, N)).astype(np.float32)
    ct = torch.from_numpy(rng.standard_normal((m, N)).astype(np.float32))
    grads = []
    for plan in (fo, tp):
        vals = ta.vals.clone().requires_grad_()
        b = torch.from_numpy(b_np).requires_grad_()
        out = execute_plan(plan, vals, b, ExecutionConfig(impl="torch"))
        grads.append(torch.autograd.grad(out, [vals, b], ct))
    for g0, g1 in zip(*grads):
        torch.testing.assert_close(g0, g1, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="with_transpose"):
        execute_plan(fo, ta.vals.clone().requires_grad_(),
                     torch.from_numpy(b_np), ExecutionConfig(impl="cuda"))


def test_backward_skips_cotangents_no_one_needs(monkeypatch):
    """dB (a merge launch on the transpose plan) runs only when B needs a
    gradient, dvals (an SDDMM launch) only when the values do."""
    m, k, npr = KINDS["irregular"]
    _, tp, x, _ = _problem(m, k, npr, "rowsplit", ())
    calls = {"merge_execute": 0, "sddmm": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    for want_vals, want_b in ((True, False), (False, True), (True, True)):
        before = dict(calls)
        vals = torch.from_numpy(x["vals"]).requires_grad_(want_vals)
        b = torch.from_numpy(x["b"]).requires_grad_(want_b)
        out = execute_plan(tp, vals, b)
        out.backward(torch.from_numpy(x["ct"]))
        assert calls["merge_execute"] - before["merge_execute"] == want_b
        assert calls["sddmm"] - before["sddmm"] == want_vals
        assert (vals.grad is not None) == want_vals
        assert (b.grad is not None) == want_b
