"""Public SpMM API: registry-dispatched, plan-once/execute-many, batched,
and differentiable.

    C = spmm(A, B)                             # auto: the §5.4 rule
    C = spmm(A, B, PlanPolicy(method="merge"))          # force a method
    C = spmm(A, B, exec=ExecutionConfig(impl="torch"))  # plain version

    plan = repro_torch.engine.get_plan(A)      # once per sparsity pattern
    C = spmm(A, B, plan=plan)                  # never replans
    C = execute_plan(plan, A.vals, B)          # the explicit-plan core
    C = execute_plan(plan, A.vals, Bs)         # Bs (batch, k, n): one plan,
                                               # many problems, one launch
    C = spmm(A, B, plan="inline")              # plan per call, no cache

Execution is differentiable in ``vals``, ``B``, ``bias`` and ``residual``
through a ``torch.autograd.Function`` (the reference's custom VJP):
``dB = Aᵀ @ dC`` runs the merge kernel on the plan's transpose (CSC-view)
merge plan, and ``dvals`` the SDDMM kernel over the pattern
(``repro_torch.kernels.sddmm``), for both implementations.  The kernel
gradients need a plan with the transpose (``PlanPolicy(
with_transpose=True)``, the default); a forward-only plan stays
differentiable through ordinary autograd on the plain version only.

While tracing is on (``repro_torch.obs``), every ``execute_plan`` emits a
``dispatch`` event and counts ``plan_execute_total{plan,impl}``, and,
inside a ``torch.profiler`` capture, the kernel call runs in a
``record_function`` range ``spmm_<method>_<impl>``; while it is off, none
of it runs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.obs import registry as _metrics
from repro_torch.obs import trace as _trace

from .config import ExecutionConfig, PlanPolicy, torch_dtype
from .csr import CSR
from .epilogue import Epilogue, activation_grad, apply_epilogue
from .plan import PlanMeta, SpmmPlan

# Per-plan execute counts.  Gated on the tracing flag at the call site:
# execute_plan is the engine's hottest eager entry point and the
# observability contract is zero-cost-when-disabled.
_plan_execute = _metrics.counter(
    "plan_execute_total", "execute_plan dispatches by plan and impl",
    labels=("plan", "impl"))


# (method, shape, nnz_pad, impl) -> its plan_execute_total child, bound
# once: formatting the label and looking the child up on every traced
# dispatch cost more than the increment.  Children outlive a registry reset.
_plan_execute_children: dict = {}


def _plan_label(meta: PlanMeta) -> str:
    m, k = meta.shape
    return f"{meta.method}:{m}x{k}:nnz{meta.nnz_pad}"


def _execute_counter(meta: PlanMeta, impl: str):
    key = (meta.method, meta.shape, meta.nnz_pad, impl)
    child = _plan_execute_children.get(key)
    if child is None:
        child = _plan_execute_children[key] = _plan_execute.labels(
            plan=_plan_label(meta), impl=impl)
    return child


def _record_dispatch(meta: PlanMeta, b, exec: ExecutionConfig) -> None:
    # Callers gate on _trace._enabled.  Every arg is a Python value of the
    # plan's metadata or of shapes: no device read (CUDA graph capture).
    _execute_counter(meta, exec.impl).inc()
    ep = exec.epilogue
    _trace.event(
        "dispatch", cat="dispatch", method=meta.method, impl=exec.impl,
        m=int(meta.shape[0]), k=int(meta.shape[1]),
        nnz_pad=int(meta.nnz_pad), n=int(b.shape[-1]),
        batch=list(b.shape[:-2]), acc_dtype=exec.acc_dtype,
        out_dtype=exec.out_dtype,
        epilogue=(dict(bias=ep.bias, residual=ep.residual,
                       activation=ep.activation,
                       scale=ep.scale is not None)
                  if ep is not None else None))


def _registry():
    # deferred: repro_torch.kernels imports repro_torch.core.csr
    from repro_torch.kernels import registry
    return registry


def _resolve_exec(where: str, m: int, vals, b, exec: ExecutionConfig,
                  bias, residual) -> ExecutionConfig:
    """Normalize the per-call config against the actual operands.

    Resolves ``impl`` by device (no fallback: ``"cuda"`` on a CPU tensor
    raises), the epilogue (auto-derived when ``bias``/``residual`` are
    passed without one; flag/operand mismatches raise), and
    ``acc_dtype``/``out_dtype`` against the operand dtypes, rejecting
    non-floating or precision-losing combinations up front.
    """
    impl = exec.impl
    if impl is None:
        impl = "cuda" if b.is_cuda else "torch"
    elif impl == "cuda" and not b.is_cuda:
        raise ValueError(
            f"{where}(): impl='cuda' runs the CUDA kernels, but the "
            f"operands are on {b.device}. Move them to a CUDA device, or "
            "ask for the plain version with ExecutionConfig(impl='torch').")
    for name, x in (("vals", vals), ("b", b)):
        if not x.dtype.is_floating_point:
            raise TypeError(
                f"{where}() requires floating-point operands; {name} has "
                f"dtype {x.dtype}. Cast explicitly.")
    promoted = torch.promote_types(vals.dtype, b.dtype)
    acc = torch_dtype(exec.acc_dtype) if exec.acc_dtype is not None \
        else torch.promote_types(promoted, torch.float32)
    if torch.promote_types(promoted, acc) != acc:
        raise ValueError(
            f"acc_dtype={acc} cannot hold the promoted operand dtype "
            f"{promoted} (vals {vals.dtype}, b {b.dtype}): accumulating "
            "below the input precision silently loses bits.")
    out = torch_dtype(exec.out_dtype) if exec.out_dtype is not None \
        else promoted
    ep = exec.epilogue
    if ep is None and (bias is not None or residual is not None):
        ep = Epilogue(bias=bias is not None, residual=residual is not None)
    if ep is not None:
        for flag, operand, name in ((ep.bias, bias, "bias"),
                                    (ep.residual, residual, "residual")):
            if flag and operand is None:
                raise ValueError(
                    f"{where}(): the epilogue flags {name} but no {name}= "
                    "operand was passed.")
            if not flag and operand is not None:
                raise ValueError(
                    f"{where}(): a {name}= operand was passed but the "
                    f"explicit epilogue does not flag {name} — it would "
                    f"be silently ignored. Set Epilogue({name}=True) or "
                    "drop the operand.")
        if ep.bias and tuple(bias.shape) != (m,):
            raise ValueError(
                f"{where}(): bias must have shape ({m},) — one entry per "
                f"C row — got {tuple(bias.shape)}.")
        if ep.residual and (residual.dim() < 2 or tuple(
                residual.shape[-2:]) != (m, b.shape[-1])):
            raise ValueError(
                f"{where}(): residual must have shape (..., {m}, "
                f"{b.shape[-1]}) matching C, got {tuple(residual.shape)}.")
        if ep.is_identity():
            ep = None
    return dataclasses.replace(exec, impl=impl, epilogue=ep,
                               acc_dtype=str(acc).removeprefix("torch."),
                               out_dtype=str(out).removeprefix("torch."))


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def _forward(meta, fwd, vals, b, exec: ExecutionConfig, bias, residual):
    execute = _registry().get_method(meta.method).execute
    kw = dict(impl=exec.impl, epilogue=exec.epilogue, bias=bias,
              residual=residual, acc_dtype=torch_dtype(exec.acc_dtype),
              out_dtype=torch_dtype(exec.out_dtype))
    if _trace._enabled and _trace.profiling():
        # Label the kernel's launches in the running torch.profiler
        # capture; the dispatch event was already emitted by the caller.
        with torch.profiler.record_function(
                f"spmm_{meta.method}_{exec.impl}"):
            return execute(meta, fwd, vals, b, **kw)
    return execute(meta, fwd, vals, b, **kw)


class _ExecuteFn(torch.autograd.Function):
    """``execute_plan`` with the reference's backward
    (``repro.core.spmm._execute_vjp``): dB through the transpose merge
    plan, dvals through SDDMM, the epilogue's chain rule around them."""

    @staticmethod
    def forward(ctx, plan, exec, vals, b, bias, residual):
        meta, ep = plan.meta, exec.epilogue
        ctx.plan, ctx.exec = plan, exec
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.res_dtype = None if residual is None else residual.dtype
        if ep is None or ep.activation == "none":
            # Linear tail: fully fused forward; the backward needs no extra
            # saved intermediate (+bias/*scale/+residual are dc-algebra).
            ctx.save_for_backward(vals, b, None)
            return _forward(meta, plan.fwd, vals, b, exec, bias, residual)
        # Nonlinear activation: fuse up to the pre-activation (C + bias, in
        # acc precision) and save it — the backward derives act'(pre) from
        # it.  The act/scale/residual tail runs outside the kernel here;
        # the forward-only path (no grad) keeps the full fusion.
        pre_ep = dataclasses.replace(ep, activation="none", scale=None,
                                     residual=False)
        pre_exec = dataclasses.replace(
            exec, epilogue=None if pre_ep.is_identity() else pre_ep,
            out_dtype=exec.acc_dtype)
        pre = _forward(meta, plan.fwd, vals, b, pre_exec,
                       bias if ep.bias else None, None)
        ctx.save_for_backward(vals, b, pre)
        tail = dataclasses.replace(ep, bias=False)
        out = apply_epilogue(pre, tail, None,
                             residual if ep.residual else None)
        return out.to(torch_dtype(exec.out_dtype))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dc):
        from repro_torch.kernels import ops
        vals, b, pre = ctx.saved_tensors
        plan, exec = ctx.plan, ctx.exec
        meta, ep = plan.meta, exec.epilogue
        need_vals, need_b, need_bias, need_res = ctx.needs_input_grad[2:]
        # Epilogue chain rule, peeled outside-in: out = act(C + bias) *
        # scale + residual  ⇒  d_residual = dc;  g = act'(pre) · (dc ·
        # scale) is the cotangent of C (and of bias, row-summed).
        d_res = dc.to(ctx.res_dtype) if need_res else None
        g = dc.to(torch_dtype(exec.acc_dtype))
        if ep is not None:
            if ep.scale is not None:
                g = g * ep.scale
            if ep.activation != "none":
                g = activation_grad(ep.activation, pre, g)
        # The kernels take row-major operands; dc arrives as a transposed
        # view from SparseLinear's (W @ xᵀ)ᵀ.
        g = g.contiguous()
        d_bias = None
        if need_bias:
            # The bias is shared across n and every leading batch dim.
            d_bias = g.sum(dim=tuple(d for d in range(g.dim())
                                     if d != g.dim() - 2))
            d_bias = d_bias.to(ctx.bias_dtype)
        db = None
        if need_b:
            # dB = Aᵀ @ g through the transpose merge plan: the CSC view
            # gets the forward's equal-nonzero balancing, batched like it.
            db = ops.merge_execute(plan.bwd, vals, g, m=meta.k,
                                   impl=exec.impl, out_dtype=b.dtype)
        dvals = None
        if need_vals:
            # dvals = (g · Bᵀ) sampled at the pattern, reduced over the
            # batch dims — the values are shared across the batch.
            fwd = plan.fwd
            dvals = ops.sddmm(fwd["nz_rows"], fwd["nz_cols"],
                              fwd["nz_valid"], g, b, impl=exec.impl)
            if dvals.dim() > 1:
                dvals = dvals.sum(dim=tuple(range(dvals.dim() - 1)))
            dvals = dvals.to(vals.dtype)
        return None, None, dvals, db, d_bias, d_res


def execute_plan(plan: SpmmPlan, vals: torch.Tensor, b: torch.Tensor,
                 exec: ExecutionConfig | None = None, *,
                 bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """Execute a prebuilt plan: C = A @ B with A's values given per call.

    ``exec`` is the per-call :class:`ExecutionConfig` (implementation,
    fused epilogue, accumulation/output dtypes).  ``b`` may carry leading
    batch dims — ``(..., k, n) → (..., m, n)`` runs the whole stack
    through one kernel launch with shared values.  ``bias (m,)`` /
    ``residual (..., m, n)`` feed the fused epilogue ``act(C + bias) *
    scale + residual``, applied in ``acc_dtype`` (f32 by default, also
    under bf16 inputs) with one cast to ``out_dtype``.  The kernels take a
    row-major (contiguous) ``b`` and raise on anything else.

    Differentiable in ``vals``, ``b``, ``bias`` and ``residual`` when the
    plan carries its transpose (the default policy); the kernel path
    (``impl="cuda"``) raises on a gradient request without one.
    """
    exec = exec if exec is not None else ExecutionConfig()
    if tuple(vals.shape) != (plan.meta.nnz_pad,):
        raise ValueError(
            f"plan expects vals of shape ({plan.meta.nnz_pad},) for pattern "
            f"{plan.meta.shape}, got {tuple(vals.shape)} — was the plan "
            "built for a different sparsity pattern?")
    if b.dim() < 2 or b.shape[-2] != plan.meta.k:
        raise ValueError(
            f"plan expects B of shape (..., {plan.meta.k}, n) for pattern "
            f"{plan.meta.shape}, got {tuple(b.shape)}")
    if b.device != plan.device or vals.device != plan.device:
        raise ValueError(
            f"plan lives on {plan.device}, operands on {b.device} / "
            f"{vals.device}: build the plan on the operands' device")
    grad = _needs_grad(vals, b, bias, residual)
    impl = exec.impl or ("cuda" if b.is_cuda else "torch")
    if grad and plan.bwd is None and impl == "cuda":
        raise ValueError(
            "execute_plan: a gradient through the CUDA kernels runs dB on "
            "the plan's transpose (CSC) merge plan, and this plan was "
            "built without one. Build it with PlanPolicy("
            "with_transpose=True) (the default), run under "
            "torch.no_grad(), or use ExecutionConfig(impl='torch').")
    exec = _resolve_exec("execute_plan", plan.meta.m, vals, b, exec, bias,
                         residual)
    if _trace._enabled:
        _record_dispatch(plan.meta, b, exec)
    if grad and plan.bwd is not None:
        return _ExecuteFn.apply(plan, exec, vals, b, bias, residual)
    # No gradient asked for, or a forward-only plan on the plain version
    # (ordinary autograd, like the reference's impl="xla").
    return _forward(plan.meta, plan.fwd, vals, b, exec, bias, residual)


def _check_plan_overrides(plan: SpmmPlan, policy: PlanPolicy) -> None:
    """Raise on an explicit policy that contradicts the supplied plan."""
    meta = plan.meta
    conflicts = []
    if policy.method != "auto" and policy.method != meta.method:
        conflicts.append(f"method={policy.method!r} (plan: {meta.method!r})")
    for name in ("t", "tl", "l_pad"):
        want = getattr(policy, name)
        if want is not None and want != getattr(meta, name):
            conflicts.append(f"{name}={want} (plan: {getattr(meta, name)})")
    if policy.shards is not None:
        conflicts.append(f"shards={policy.shards} (plan: unsharded — build "
                         "a sharded plan via engine.get_plan or "
                         "SparseMatrix.shard)")
    if conflicts:
        raise ValueError(
            "spmm() overrides conflict with the supplied plan's static "
            "decisions: " + "; ".join(conflicts) + ". Rebuild the plan with "
            "these parameters or drop the overrides.")


def _check_sharded_overrides(plan, policy: PlanPolicy) -> None:
    """Raise on an explicit policy contradicting a sharded plan's statics."""
    meta = plan.meta
    conflicts = []
    if policy.shards is not None:
        spec = policy.shards
        if spec.resolved_n() != meta.n_shards:
            conflicts.append(f"shards n={spec.resolved_n()} "
                             f"(plan: {meta.n_shards})")
        if spec.dim != meta.dim:
            conflicts.append(f"shards dim={spec.dim!r} (plan: {meta.dim!r})")
    if policy.method != "auto":
        mismatched = sorted({lm.method for lm in meta.local_metas
                             if lm.method != policy.method})
        if mismatched:
            conflicts.append(f"method={policy.method!r} (plan shards use "
                             f"{mismatched})")
    for name in ("t", "tl", "l_pad"):
        want = getattr(policy, name)
        if want is None:
            continue
        got = sorted({getattr(lm, name) for lm in meta.local_metas},
                     key=lambda x: (x is None, x))
        if got != [want]:
            conflicts.append(f"{name}={want} (plan shards: {got})")
    if conflicts:
        raise ValueError(
            "spmm() overrides conflict with the supplied sharded plan's "
            "static decisions: " + "; ".join(conflicts) + ". Rebuild the "
            "sharded plan with these parameters (engine.get_plan with a "
            "shards= policy) or drop the overrides.")


def spmm(a: CSR, b: torch.Tensor, policy: PlanPolicy | None = None,
         exec: ExecutionConfig | None = None, *,
         plan: SpmmPlan | str | None = None,
         bias: torch.Tensor | None = None,
         residual: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse(CSR) × dense = dense.  ``b`` is (..., k, n); returns
    (..., m, n).

    ``policy`` holds every pattern-static decision and ``exec`` the
    per-call backend knobs.  Dispatch on ``plan``:

    * an ``SpmmPlan`` or a ``ShardedSpmmPlan`` -- execute it (an
      explicit ``policy`` must agree with it);
    * ``None`` (default) -- the pattern's plan from the engine cache, then
      execute it, so repeated calls with the same pattern never replan;
    * ``"inline"`` -- the paper's per-call regime: the method's ``inline``
      form builds its structure and executes it with no cache, every
      call.  B must be 2-D.  The method and its parameters resolve through
      the same ``PlanPolicy.resolve`` as the planned path, so the two
      regimes pick the same kernel for a matrix.  The epilogue and the
      dtype contract are applied after the call: the same math as the
      fused paths, none of the fusion.
    """
    policy = policy if policy is not None else PlanPolicy()
    if isinstance(plan, SpmmPlan):
        _check_plan_overrides(plan, policy)
    elif plan is None:
        from repro_torch.engine import get_plan
        plan = get_plan(a, policy)
    elif isinstance(plan, str) and plan == "inline":
        return _spmm_inline(a, b, policy, exec, bias, residual)
    elif hasattr(plan, "shards"):              # a ShardedSpmmPlan
        _check_sharded_overrides(plan, policy)
    else:
        raise ValueError(f"plan must be an SpmmPlan, a ShardedSpmmPlan, "
                         f"None or 'inline'; got {plan!r}")
    if not isinstance(plan, SpmmPlan):
        return plan.execute(a.vals, b, exec, bias=bias, residual=residual)
    return execute_plan(plan, a.vals, b, exec, bias=bias, residual=residual)


def _spmm_inline(a: CSR, b, policy: PlanPolicy, exec, bias, residual):
    """``spmm(plan="inline")``: resolve, plan and execute in one call."""
    if policy.shards is not None:
        raise ValueError(
            "the inline (plan-per-call) spmm path cannot shard: sharding "
            "is a host-side plan decision. Build the sharded plan first "
            "(repro_torch.engine.get_plan with a shards= policy, or "
            "SparseMatrix.shard) and pass it as plan=.")
    if b.dim() != 2:
        raise ValueError(
            "the inline (plan-per-call) spmm path takes a 2-D B; batched "
            f"B {tuple(b.shape)} needs a prebuilt plan -- "
            "repro_torch.engine.get_plan(a) -- whose execution folds the "
            "batch into the kernel launch.")
    r = policy.resolve(a)
    spec = _registry().get_method(r.method)
    if spec.inline is None:
        raise ValueError(
            f"SpMM method {r.method!r} has no inline (plan-per-call) form; "
            "build a plan instead: repro_torch.engine.get_plan(a, policy)")
    exec = _resolve_exec("spmm", a.m, a.vals, b,
                         exec if exec is not None else ExecutionConfig(),
                         bias, residual)
    if _trace._enabled:
        _trace.event("dispatch", cat="dispatch", method=r.method,
                     impl=exec.impl, inline=True, n=int(b.shape[-1]),
                     acc_dtype=exec.acc_dtype, out_dtype=exec.out_dtype)
    out = spec.inline(a, b, t=r.t, tl=r.tl, l_pad=r.l_pad, extra=r.extra,
                      impl=exec.impl)
    ep = exec.epilogue
    if ep is not None:
        acc = torch_dtype(exec.acc_dtype)
        out = apply_epilogue(out.to(acc), ep,
                             bias.to(acc)[:, None] if ep.bias else None,
                             residual if ep.residual else None)
    return out.to(torch_dtype(exec.out_dtype))
