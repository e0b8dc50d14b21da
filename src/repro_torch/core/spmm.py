"""Public SpMM API: registry-dispatched, plan-once/execute-many, batched.

    C = spmm(A, B)                             # auto: the §5.4 rule
    C = spmm(A, B, PlanPolicy(method="merge"))          # force a method
    C = spmm(A, B, exec=ExecutionConfig(impl="torch"))  # plain version

    plan = repro_torch.engine.get_plan(A)      # once per sparsity pattern
    C = spmm(A, B, plan=plan)                  # never replans
    C = execute_plan(plan, A.vals, B)          # the explicit-plan core
    C = execute_plan(plan, A.vals, Bs)         # Bs (batch, k, n): one plan,
                                               # many problems, one launch

This slice ports the forward.  Gradients (the reference's custom VJP:
``dB`` through the transpose merge plan, ``dvals`` through SDDMM) come
with the training slice; until then a kernel execution that autograd
would need to differentiate raises instead of returning a result with no
gradient.
"""
from __future__ import annotations

import dataclasses

import torch

from .config import ExecutionConfig, PlanPolicy, torch_dtype
from .csr import CSR
from .epilogue import Epilogue
from .plan import SpmmPlan


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
    exec = _resolve_exec("execute_plan", plan.meta.m, vals, b, exec, bias,
                         residual)
    if exec.impl == "cuda" and _needs_grad(vals, b, bias, residual):
        raise NotImplementedError(
            "execute_plan: the CUDA kernels have no backward yet — the "
            "gradient path (dB through the transpose merge plan, dvals "
            "through the SDDMM kernel) comes with the port's training "
            "slice. Run under torch.no_grad(), or use "
            "ExecutionConfig(impl='torch') for a differentiable plain "
            "version.")
    spec = _registry().get_method(plan.meta.method)
    return spec.execute(plan.meta, plan.fwd, vals, b, impl=exec.impl,
                        epilogue=exec.epilogue, bias=bias,
                        residual=residual,
                        acc_dtype=torch_dtype(exec.acc_dtype),
                        out_dtype=torch_dtype(exec.out_dtype))


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
    if conflicts:
        raise ValueError(
            "spmm() overrides conflict with the supplied plan's static "
            "decisions: " + "; ".join(conflicts) + ". Rebuild the plan with "
            "these parameters or drop the overrides.")


def spmm(a: CSR, b: torch.Tensor, policy: PlanPolicy | None = None,
         exec: ExecutionConfig | None = None, *,
         plan: SpmmPlan | None = None, bias: torch.Tensor | None = None,
         residual: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse(CSR) × dense = dense.  ``b`` is (..., k, n); returns
    (..., m, n).

    ``policy`` holds every pattern-static decision and ``exec`` the
    per-call backend knobs.  With ``plan`` given it is executed (an
    explicit ``policy`` must agree with it); otherwise the pattern's plan
    comes from the engine cache, so repeated calls with the same pattern
    never replan.  (The reference's plan-per-call ``plan="inline"`` regime
    is not ported yet.)
    """
    policy = policy if policy is not None else PlanPolicy()
    if plan is None:
        from repro_torch.engine import get_plan
        plan = get_plan(a, policy)
    elif isinstance(plan, SpmmPlan):
        _check_plan_overrides(plan, policy)
    else:
        raise ValueError(f"plan must be an SpmmPlan or None; got {plan!r}")
    return execute_plan(plan, a.vals, b, exec, bias=bias, residual=residual)
