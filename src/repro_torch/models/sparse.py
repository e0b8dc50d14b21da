"""Pruned-FFN layers via SpMM — the paper's motivating use case (§1, [1]).

``SparseLinear`` stores a magnitude-pruned weight in CSR and runs the
matmul through the plan-once/execute-many engine: ``y = (W_csr @ x.T).T``
where the activation matrix ``x.T (d_in, tokens)`` is the tall-skinny
dense B — at serving batch sizes the paper's n ≤ 128 regime.  The
layer's ``SpmmPlan`` (kernel choice, row-split ``l_pad``, chunk layout,
transpose plan) is built once per pattern through ``repro_torch.engine``.
The layer is differentiable: gradients flow to the activations and to the
CSR values, which :func:`mlp_vals` / :func:`mlp_with_vals` expose for sparse
fine-tuning (``repro_torch.runtime.steps``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import (CSR, Epilogue, ExecutionConfig, PlanPolicy,
                              SparseMatrix, SpmmPlan)

# Below this many tokens per call, flattening the leading axes packs the
# tokens into one wide B; from here up each batch element already fills a
# wide B, so the batched path — B (..., d_in, tokens) folded into the
# kernel's batch axis — skips the flatten and runs the stack in one launch.
BATCHED_MIN_TOKENS = 128


@dataclasses.dataclass(frozen=True, eq=False)
class SparseLinear:
    weight: CSR                    # (d_out, d_in)
    plan: SpmmPlan | None          # pattern plan (None = plan on first use;
                                   # or a ShardedSpmmPlan, ``shard``)

    @classmethod
    def from_dense(cls, w: torch.Tensor, keep_fraction: float, *,
                   policy: PlanPolicy | None = None) -> SparseLinear:
        """Prune w (d_in, d_out) on its device — stored transposed as
        (d_out, d_in) — and attach the engine-cached plan."""
        mtx = SparseMatrix.prune(w.T, keep_fraction, policy or PlanPolicy())
        return cls(mtx.data, mtx.spmm_plan)

    @property
    def matrix(self) -> SparseMatrix:
        return SparseMatrix(self.weight, self.plan)

    @property
    def method(self) -> str:
        return self.plan.meta.method if self.plan is not None else "auto"

    def with_plan(self, policy: PlanPolicy | None = None) -> SparseLinear:
        """(Re)attach the engine-cached plan for this weight's pattern.

        With no ``policy``, an attached plan's full statics are replayed
        (``SparseMatrix.plan_like``); a cache hit when the plan exists.
        """
        if policy is None and self.plan is not None:
            mtx = SparseMatrix(self.weight).plan_like(self.plan.meta)
        else:
            mtx = SparseMatrix(self.weight).plan(policy or PlanPolicy())
        return dataclasses.replace(self, plan=mtx.spmm_plan)

    def shard(self, mesh=None, *, n: int | None = None, dim: str = "rows",
              axis: str | None = None,
              policy: PlanPolicy | None = None) -> SparseLinear:
        """Re-plan this layer's weight with a device-sharded plan:
        nnz-balanced shards, one local plan a shard (see
        ``SparseMatrix.shard`` / ``repro_torch.distributed.spmm``)."""
        mtx = SparseMatrix(self.weight).shard(mesh, n=n, dim=dim, axis=axis,
                                              policy=policy)
        return dataclasses.replace(self, plan=mtx.spmm_plan)

    def __call__(self, x: torch.Tensor,
                 exec: ExecutionConfig | None = None, *,
                 bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
        """x (..., d_in) → (..., d_out), computed in the weight's dtype and
        cast back to x's dtype (or ``exec.out_dtype``).  Differentiable in
        ``x`` and the CSR values.

        ``bias (d_out,)`` / ``residual (..., d_out)`` and any
        ``exec.epilogue`` activation fuse into the SpMM's output write: the
        layer runs as ``y = (W @ xᵀ)ᵀ``, so the per-``d_out`` bias is the
        kernel's per-C-row bias and the residual rides transposed.
        """
        mtx = self.matrix              # plans on first use if unplanned
        w = self.weight
        out_dtype = x.dtype if exec is None or exec.out_dtype is None \
            else getattr(torch, exec.out_dtype)
        if x.dim() >= 3 and x.shape[-2] >= BATCHED_MIN_TOKENS:
            xt = x.transpose(-1, -2).to(w.dtype).contiguous()
            res = None if residual is None else \
                residual.transpose(-1, -2).contiguous()
            y = mtx.matmul(xt, exec, bias=bias, residual=res)
            return y.transpose(-1, -2).to(out_dtype)
        lead = x.shape[:-1]
        # B = xᵀ is a transposed view; the kernels take row-major B only.
        xt = x.reshape(-1, x.shape[-1]).T.to(w.dtype).contiguous()
        res = None if residual is None else \
            residual.reshape(-1, w.m).T.contiguous()
        y = mtx.matmul(xt, exec, bias=bias, residual=res)
        return y.T.reshape(*lead, w.m).to(out_dtype)


def prune_mlp(mlp_params: dict, keep_fraction: float,
              policy: PlanPolicy | None = None) -> dict:
    """Convert a dense MLP param dict (w1/w2[/w3]) to SparseLinear layers;
    ``policy`` pins every layer's plan request (e.g. a forced method)."""
    return {name: SparseLinear.from_dense(w, keep_fraction, policy=policy)
            for name, w in mlp_params.items()}


def sparse_mlp_apply(sparse_p: dict, x: torch.Tensor, cfg,
                     exec: ExecutionConfig | None = None) -> torch.Tensor:
    """Apply a pruned MLP block (gelu or swiglu, by the param dict's keys).

    The gelu variant fuses the activation into w1's SpMM epilogue; swiglu
    stays unfused (silu and the w3 gate are not epilogue shapes).
    """
    base = exec if exec is not None else ExecutionConfig()
    if "w3" in sparse_p:
        h = F.silu(sparse_p["w1"](x, base)) * sparse_p["w3"](x, base)
    else:
        fused = dataclasses.replace(base,
                                    epilogue=Epilogue(activation="gelu"))
        h = sparse_p["w1"](x, fused)
    return sparse_p["w2"](h, base)


def mlp_vals(sparse_p: dict) -> dict:
    """The trainable CSR values of a SparseLinear dict."""
    return {name: sl.weight.vals for name, sl in sparse_p.items()}


def mlp_with_vals(sparse_p: dict, vals: dict) -> dict:
    """Rebind CSR values onto the (frozen-pattern) layers — the sparse
    fine-tuning parameterization: patterns and plans stay put, values are
    the optimizer's degrees of freedom."""
    return {name: dataclasses.replace(
        sl, weight=dataclasses.replace(sl.weight, vals=vals[name]))
        for name, sl in sparse_p.items()}
