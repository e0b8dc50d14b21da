"""``SparseMatrix``: the user-facing sparse-matrix frontend.

A thin wrapper pairing a CSR pattern+values with its lazily attached
execution plan:

    A = SparseMatrix.from_dense(w)            # or .prune(w, keep)
    C = A @ B                                 # plans via the engine cache
    A = A.plan(PlanPolicy(method="merge"))    # pin the plan explicitly
    A = A.shard(n=4, dim="rows")              # nnz-balanced shards
"""
from __future__ import annotations

import dataclasses

import torch

from .config import ExecutionConfig, PlanPolicy
from .csr import CSR, prune_to_csr
from .csr import from_dense as _csr_from_dense
from .plan import SpmmPlan
from .spmm import execute_plan


@dataclasses.dataclass(frozen=True, eq=False)
class SparseMatrix:
    """CSR pattern + values + (lazily attached) execution plan."""

    data: CSR
    spmm_plan: SpmmPlan | None = None   # or a ShardedSpmmPlan

    def __post_init__(self):
        p = self.spmm_plan
        if p is not None and (p.meta.shape != self.data.shape or
                              p.meta.nnz_pad != self.data.nnz_pad):
            raise ValueError(
                f"plan was built for pattern {p.meta.shape} "
                f"(nnz_pad={p.meta.nnz_pad}) but the matrix is "
                f"{self.data.shape} (nnz_pad={self.data.nnz_pad})")

    # ------------------------------------------------------ constructors ---

    @classmethod
    def from_csr(cls, csr: CSR,
                 policy: PlanPolicy | None = None) -> SparseMatrix:
        """Wrap a CSR; with ``policy`` given, attach its plan eagerly."""
        mtx = cls(csr)
        return mtx.plan(policy) if policy is not None else mtx

    @classmethod
    def from_dense(cls, dense, nnz_pad: int | None = None,
                   policy: PlanPolicy | None = None) -> SparseMatrix:
        return cls.from_csr(_csr_from_dense(dense, nnz_pad), policy)

    @classmethod
    def prune(cls, w: torch.Tensor, keep_fraction: float,
              policy: PlanPolicy | None = None) -> SparseMatrix:
        """Magnitude-prune a dense weight (top ``keep_fraction`` per row)."""
        return cls.from_csr(prune_to_csr(w, keep_fraction), policy)

    # ----------------------------------------------------------- pattern ---

    @property
    def shape(self):
        return self.data.shape

    @property
    def vals(self) -> torch.Tensor:
        return self.data.vals

    @property
    def method(self) -> str | None:
        """The planned kernel method, or None while un-planned."""
        return self.spmm_plan.meta.method if self.spmm_plan else None

    # ------------------------------------------------------------- plans ---

    def plan(self, policy: PlanPolicy | None = None) -> SparseMatrix:
        """Attach the engine-cached plan for this pattern (host-side)."""
        from repro_torch.engine import get_plan
        return dataclasses.replace(
            self, spmm_plan=get_plan(self.data, policy or PlanPolicy()))

    def plan_like(self, meta) -> SparseMatrix:
        """Re-plan replaying an existing plan's full statics; if a
        pattern-derived parameter no longer fits this pattern (a row grew
        past the old pad), keep the method alone and re-derive the rest.
        A sharded plan's meta replays its layout (count, dim, axis, mesh)
        and, when uniform, its shards' method and statics."""
        if hasattr(meta, "local_metas"):   # sharded plan: replay the layout
            from .config import ShardSpec
            spec = ShardSpec(n=meta.n_shards, dim=meta.dim, axis=meta.axis,
                             mesh=meta.mesh)
            if meta.uniform:
                lm = meta.local_metas[0]
                try:
                    return self.plan(PlanPolicy(
                        method=lm.method, t=lm.t, tl=lm.tl, l_pad=lm.l_pad,
                        with_transpose=lm.has_transpose, shards=spec))
                except ValueError:
                    pass
            return self.plan(PlanPolicy(
                shards=spec, with_transpose=meta.has_transpose))
        try:
            return self.plan(PlanPolicy.from_meta(meta))
        except ValueError:
            return self.plan(PlanPolicy(
                method=meta.method, with_transpose=meta.has_transpose))

    def shard(self, mesh=None, *, n: int | None = None, dim: str = "rows",
              axis: str | None = None,
              policy: PlanPolicy | None = None) -> SparseMatrix:
        """Attach a device-sharded plan: nnz-balanced shards, one local
        plan a shard (``repro_torch.distributed.spmm``).

        ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh``) lets a
        uniform plan run one shard a rank over ``axis`` (``"data"`` for
        row shards, ``"model"`` for the tensor-parallel column shards)
        once a process group is up; without one, ``n`` logical shards run
        as a per-shard loop, numerically identical.  ``policy`` pins the
        per-shard plan requests (method, params, TuneDB); each shard still
        resolves "auto" on its own local stats.
        """
        from .config import ShardSpec
        spec = ShardSpec(n=n, dim=dim, axis=axis, mesh=mesh)
        base = policy if policy is not None else PlanPolicy()
        if base.shards is not None:
            raise ValueError(
                "SparseMatrix.shard: pass the shard layout via "
                "mesh/n/dim/axis, not inside policy.shards — the two "
                "spellings cannot be mixed")
        return self.plan(dataclasses.replace(base, shards=spec))

    # --------------------------------------------------------- execution ---

    def matmul(self, b: torch.Tensor, exec: ExecutionConfig | None = None,
               *, bias: torch.Tensor | None = None,
               residual: torch.Tensor | None = None) -> torch.Tensor:
        """C = A @ B (``b`` (..., k, n) → (..., m, n)).  ``bias``/
        ``residual`` feed the fused epilogue; differentiable in ``b`` and
        the values (see ``execute_plan``)."""
        plan = self.spmm_plan
        if plan is None:
            from repro_torch.engine import get_plan
            plan = get_plan(self.data)
        if not isinstance(plan, SpmmPlan):     # device-sharded plan
            from repro_torch.distributed.spmm import execute_sharded
            return execute_sharded(plan, self.data.vals, b, exec, bias=bias,
                                   residual=residual)
        return execute_plan(plan, self.data.vals, b, exec, bias=bias,
                            residual=residual)

    def __matmul__(self, b) -> torch.Tensor:
        return self.matmul(b)
