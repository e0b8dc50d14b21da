"""Device-sharded SpMM: nnz-balanced row/column shards with per-shard plans.

The paper's core design principle — give every processor an equal number
of *nonzeroes*, not an equal number of rows (§4, ``core/partition.py``) —
lifted from the kernel grid to the device.  A sparse matrix is cut into
contiguous row ranges (or, for the tensor-parallel variant, column
ranges) holding ~equal nonzero counts by the same ``searchsorted``-on-
``row_ptr`` rule as ``partition_spmm``; each shard gets its *own*
:class:`~repro_torch.core.plan.SpmmPlan`, resolved through the method
registry and TuneDB ladder on its own local stats — a shard of a few
dense rows and a shard of many sparse rows can pick different kernels.
The reference is ``repro.distributed.spmm``; every host-side array here
(bounds, each shard's ``row_ptr``/``col_ind``, ``vals_slots``,
``b_rows``) equals its.

Execution (:func:`execute_sharded`):

* ``dim="rows"`` (data parallel): each shard runs its planned kernel on
  its row block against the whole B; C is the row concatenation of the
  blocks' live rows.
* ``dim="cols"`` (tensor parallel): each shard multiplies its column
  slice of A against its row block of B; the rank-``m`` partial sums add
  up to C.

Two paths compute the same values:

* **the loop path**: every shard's ``execute_plan`` in turn, on whatever
  device holds the tensors (one card runs every shard's kernels); rows
  concatenated, cols partials added in shard order.  Correct for any
  shard mix and any device count.
* **the SPMD path**: taken when the plan is uniform (every shard the same
  method and statics), its ``ShardSpec`` carries a ``DeviceMesh`` whose
  ``axis`` size is the shard count, and a process group is initialised.
  Every rank builds the whole plan (host-side and deterministic, so the
  same plan, cache key and planlint result on every rank) and executes
  only the shard of its coordinate on the mesh axis.  Rows: each rank
  writes its live rows into a zero ``(..., m, n)`` buffer and the buffers
  are all-reduced (adding zeros keeps every value; gloo's collectives on
  CUDA tensors are broadcast and all-reduce alone).  Cols: the partials
  are all-reduced with SUM.  Collectives run on the
  mesh dim's group (``mesh.get_group(axis)``); one that fails raises.

Gradients on the SPMD path.  The rule: every rank computes the same loss
on the assembled C (C is replicated), and after ``backward()`` the
gradients of ``vals``, ``b``, ``bias`` and ``residual`` on every rank
equal the loop path's.  An autograd all-gather's or all-reduce's backward
sums the replicated cotangent over the ranks, which would scale each
shard's cotangent by the world size; here the assembly's backward instead
takes this rank's part of dC with no communication (rows: its slice of
dC's rows; cols: dC itself).  Each rank's shard then gives only its own
part of dvals (nonzero at its ``vals_slots`` alone) and of dB (rows: its
block's ``Aᵢᵀ dCᵢ``; cols: its ``b_rows``), so ``vals`` and ``b`` enter
through :class:`_Replicated`, the identity forward whose backward
all-reduces the partial gradients with SUM — making them whole, once,
with no world-size factor.  ``bias`` and ``residual`` apply after the
assembly on the replicated C, so every rank computes their whole
gradients itself.

Plans are built through ``repro_torch.engine``'s cache: each shard's
local pattern lands as its own entry (keyed on the shard's fingerprint),
and the :class:`ShardedSpmmPlan` itself is cached under the global pattern
+ shard spec, so re-sharding with another count or mesh can never poison
either level.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis import _flags as _verify_flags
from repro_torch.core.config import (ExecutionConfig, PlanPolicy, mesh_axes,
                                     mesh_axis_size, torch_dtype)
from repro_torch.core.csr import CSR
from repro_torch.core.epilogue import apply_epilogue
from repro_torch.core.plan import SpmmPlan, build_plan
from repro_torch.core.spmm import _resolve_exec, execute_plan
from repro_torch.obs import registry as _metrics
from repro_torch.obs import trace as _trace

# Shard-balance gauges are plan-time (amortized) and stay always-on; the
# per-execute counter below is gated on the tracing flag like the core
# dispatch path.
_shard_imbalance = _metrics.gauge(
    "shard_nnz_imbalance", "max/mean nnz ratio of the last sharded build",
    labels=("dim",))
_sharded_execute = _metrics.counter(
    "sharded_execute_total", "execute_sharded dispatches by path",
    labels=("path",))


def _nnz_cuts(ptr: np.ndarray, n_shards: int) -> np.ndarray:
    """Cut positions splitting ``ptr``'s span into ~equal-nnz ranges.

    ``ptr`` is any monotone prefix-sum array (``row_ptr`` for row shards,
    the CSC column pointer for column shards).  Returns ``n_shards + 1``
    monotone boundaries with ``bounds[0] == 0`` and ``bounds[-1] ==
    len(ptr) - 1``; each boundary is the row containing the ideal cut
    nonzero — the same ``searchsorted`` rule as ``partition_spmm``, so
    every range's nonzero count is within one max-row-length of the ideal
    ``nnz / n_shards``.
    """
    m = ptr.shape[0] - 1
    nnz = int(ptr[-1])
    targets = (np.arange(1, n_shards, dtype=np.int64) * nnz) // n_shards
    cuts = np.searchsorted(ptr, targets, side="right").astype(np.int64) - 1
    bounds = np.concatenate([[0], np.minimum(cuts, m), [m]])
    return np.maximum.accumulate(bounds)


@dataclasses.dataclass(frozen=True)
class CsrShards:
    """Host-side result of :func:`shard_csr_by_nnz`.

    ``csrs`` are the per-shard local patterns (on the input's device),
    padded to uniform shapes (rows to the max shard row count, nonzeroes
    to the max shard nnz) so that same-method plans share their statics.
    ``vals_slots[i]`` gathers shard ``i``'s local values out of the
    *global* value vector (sentinel ``nnz_pad`` → an appended zero), which
    keeps the sharded execution differentiable in the shared values.  For
    ``dim="cols"``, ``b_rows[i]`` gathers shard ``i``'s row block of ``B``
    (sentinel ``k`` → an appended zero row).  Index arrays are int32.
    """

    dim: str                        # "rows" | "cols"
    shape: tuple[int, int]          # global (m, k)
    nnz_pad: int                    # global static nonzero capacity
    bounds: tuple[int, ...]         # n_shards+1 cuts over rows (or cols)
    csrs: tuple[CSR, ...]           # padded local patterns, uniform shapes
    vals_slots: tuple[torch.Tensor, ...]
    b_rows: tuple[torch.Tensor, ...] | None   # cols-dim only
    nnz: tuple[int, ...]            # true nonzeroes per shard

    @property
    def n_shards(self) -> int:
        return len(self.csrs)

    def sizes(self) -> tuple[int, ...]:
        """True (unpadded) rows/cols per shard."""
        return tuple(self.bounds[i + 1] - self.bounds[i]
                     for i in range(self.n_shards))

    def unpadded(self, i: int) -> CSR:
        """Shard ``i`` without the uniform-shape padding.

        This is the view method resolution must see: the padded ``csrs``
        carry empty filler rows that dilute a shard's local stats (a
        3-dense-row shard padded to 500 rows looks sparse to ``d =
        nnz/m``), which would defeat per-shard method selection.
        """
        c = self.csrs[i]
        if self.dim == "cols":          # columns padded: d is unaffected
            return c
        rows = self.bounds[i + 1] - self.bounds[i]
        return CSR(c.row_ptr[:rows + 1], c.col_ind, c.vals,
                   (rows, c.shape[1]))

    def nnz_per_shard(self) -> tuple[int, ...]:
        return self.nnz


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu").numpy()


def shard_csr_by_nnz(a: CSR, n_shards: int, *, dim: str = "rows") -> CsrShards:
    """Cut ``a`` into ``n_shards`` contiguous ranges of ~equal nonzeroes.

    ``dim="rows"``: contiguous row ranges (each shard a ``(max_rows, k)``
    CSR — trailing empty rows pad shards to a common height).
    ``dim="cols"``: contiguous column ranges of the CSC view (each shard a
    ``(m, max_cols)`` CSR with columns remapped to shard-local ids).
    Host-side (one copy of the pattern to the host); the shards land on
    ``a``'s device.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if dim not in ("rows", "cols"):
        raise ValueError(f"shard dim must be 'rows' or 'cols', got {dim!r}")
    m, k = a.shape
    dev, dt = a.device, a.vals.dtype
    rp = _host(a.row_ptr).astype(np.int64)
    ci = _host(a.col_ind)
    nnz = int(rp[-1])

    def local_csr(lrp, lci, loc_pad, shape):
        return CSR(torch.from_numpy(lrp).to(dev),
                   torch.from_numpy(lci).to(dev),
                   torch.zeros(loc_pad, dtype=dt, device=dev), shape)

    if dim == "rows":
        bounds = _nnz_cuts(rp, n_shards)
        max_rows = int(np.max(np.diff(bounds)))
        loc_nnz = [int(rp[bounds[i + 1]] - rp[bounds[i]])
                   for i in range(n_shards)]
        loc_pad = max(max(loc_nnz), 1)
        csrs, slots = [], []
        for i in range(n_shards):
            r0, r1 = int(bounds[i]), int(bounds[i + 1])
            lrp = np.zeros(max_rows + 1, np.int32)
            lrp[:r1 - r0 + 1] = rp[r0:r1 + 1] - rp[r0]
            lrp[r1 - r0 + 1:] = lrp[r1 - r0]      # padded rows are empty
            lci = np.zeros(loc_pad, np.int32)
            lci[:loc_nnz[i]] = ci[rp[r0]:rp[r1]]
            csrs.append(local_csr(lrp, lci, loc_pad, (max_rows, k)))
            slot = np.full(loc_pad, a.nnz_pad, np.int32)
            slot[:loc_nnz[i]] = np.arange(rp[r0], rp[r1], dtype=np.int32)
            slots.append(torch.from_numpy(slot).to(dev))
        return CsrShards(dim="rows", shape=a.shape, nnz_pad=a.nnz_pad,
                         bounds=tuple(int(b) for b in bounds),
                         csrs=tuple(csrs), vals_slots=tuple(slots),
                         b_rows=None, nnz=tuple(loc_nnz))

    # dim == "cols": balance over the CSC view's column nonzero counts.
    rows_all = np.repeat(np.arange(m, dtype=np.int32), np.diff(rp))
    cols_all = ci[:nnz]
    col_ptr = np.zeros(k + 1, np.int64)
    np.cumsum(np.bincount(cols_all, minlength=k), out=col_ptr[1:])
    bounds = _nnz_cuts(col_ptr, n_shards)
    max_cols = max(int(np.max(np.diff(bounds))), 1)
    sels = [(cols_all >= bounds[i]) & (cols_all < bounds[i + 1])
            for i in range(n_shards)]
    loc_nnz = [int(s.sum()) for s in sels]
    loc_pad = max(max(loc_nnz), 1)
    csrs, slots, b_rows = [], [], []
    for i in range(n_shards):
        c0, c1 = int(bounds[i]), int(bounds[i + 1])
        sel = sels[i]
        pos = np.nonzero(sel)[0].astype(np.int32)  # row-major order kept
        lrp = np.zeros(m + 1, np.int32)
        np.cumsum(np.bincount(rows_all[sel], minlength=m), out=lrp[1:])
        lci = np.zeros(loc_pad, np.int32)
        lci[:pos.shape[0]] = cols_all[sel] - c0
        csrs.append(local_csr(lrp, lci, loc_pad, (m, max_cols)))
        slot = np.full(loc_pad, a.nnz_pad, np.int32)
        slot[:pos.shape[0]] = pos
        slots.append(torch.from_numpy(slot).to(dev))
        rows_idx = np.full(max_cols, k, np.int32)   # sentinel: zero row of B
        rows_idx[:c1 - c0] = np.arange(c0, c1, dtype=np.int32)
        b_rows.append(torch.from_numpy(rows_idx).to(dev))
    return CsrShards(dim="cols", shape=a.shape, nnz_pad=a.nnz_pad,
                     bounds=tuple(int(b) for b in bounds),
                     csrs=tuple(csrs), vals_slots=tuple(slots),
                     b_rows=tuple(b_rows), nnz=tuple(loc_nnz))


# ------------------------------------------------------------------ plans ---


@dataclasses.dataclass(frozen=True)
class ShardedMeta:
    """Static (hashable) metadata of a ShardedSpmmPlan."""

    shape: tuple[int, int]          # global (m, k)
    nnz_pad: int                    # global static nonzero capacity
    dim: str                        # "rows" | "cols"
    bounds: tuple[int, ...]
    axis: str                       # mesh axis name
    mesh: object                    # DeviceMesh | None
    uniform: bool                   # all shards share method + statics
    local_metas: tuple              # one PlanMeta per shard

    def __post_init__(self):
        # Like PlanMeta: a static, compared and hashed by the cache and the
        # linter — an unhashable field must fail loudly at assembly.
        try:
            hash((self.bounds, self.local_metas))
        except TypeError:
            raise TypeError(
                "ShardedMeta must be hashable (it is a plan-static "
                f"constant): bounds={self.bounds!r} and every local "
                "PlanMeta must be built from tuples, not lists/arrays."
            ) from None

    @property
    def n_shards(self) -> int:
        return len(self.local_metas)

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    @property
    def method(self) -> str:
        methods = {lm.method for lm in self.local_metas}
        return methods.pop() if len(methods) == 1 else "mixed"

    @property
    def l_pad(self) -> int | None:
        pads = {lm.l_pad for lm in self.local_metas}
        return pads.pop() if len(pads) == 1 else None

    @property
    def has_transpose(self) -> bool:
        return all(lm.has_transpose for lm in self.local_metas)

    def spmd_mesh(self):
        """The mesh to run one shard a rank over, or None (per-shard
        loop): a uniform plan, a mesh whose ``axis`` size is the shard
        count, and an initialised process group."""
        mesh = self.mesh
        if (not self.uniform or mesh is None
                or self.axis not in mesh_axes(mesh)
                or mesh_axis_size(mesh, self.axis) != self.n_shards
                or not torch.distributed.is_available()
                or not torch.distributed.is_initialized()):
            return None
        return mesh


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedSpmmPlan:
    """Per-shard SpmmPlans + the value/B gathers that stitch them together.

    Execute with :func:`execute_sharded` (or ``A @ B`` on a sharded
    ``SparseMatrix``).
    """

    shards: tuple[SpmmPlan, ...]
    vals_slots: tuple[torch.Tensor, ...]
    b_rows: tuple[torch.Tensor, ...] | None
    meta: ShardedMeta

    @property
    def method(self) -> str:
        return self.meta.method

    def execute(self, vals: torch.Tensor, b: torch.Tensor,
                exec: ExecutionConfig | None = None, *,
                bias: torch.Tensor | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        return execute_sharded(self, vals, b, exec, bias=bias,
                               residual=residual)


def _unify_params(rs) -> tuple:
    """Static params every shard can run: the per-shard maxima.

    A larger ``l_pad`` is valid for every rowsplit-style shard (its rows
    pad further) and any ``t``/``tl`` is valid everywhere, so the maxima
    are the cheapest params that make same-method shards share statics.
    """
    t = max(r.t for r in rs)
    tl = max(r.tl for r in rs)
    pads = [r.l_pad for r in rs if r.l_pad is not None]
    return t, tl, (max(pads) if pads else None)


def build_sharded_plan(a: CSR, policy: PlanPolicy,
                       cache=None) -> ShardedSpmmPlan:
    """Shard ``a`` by nnz and plan each shard independently.

    Each shard's method resolves through the full ladder (TuneDB exact →
    class → calibrated threshold → registry cost hooks) *on its own local
    stats*, so an imbalanced matrix can mix kernels across shards.  When
    the shards agree on a method, their static parameters are unified to
    the per-shard maxima (``meta.uniform``: the SPMD path may run them);
    otherwise each shard plans its true local pattern and execution takes
    the per-shard loop.  ``cache`` (a ``repro_torch.engine.PlanCache``)
    makes every local plan a distinct cache entry keyed on the shard's own
    pattern fingerprint.
    """
    spec = policy.shards
    if spec is None:
        raise ValueError("build_sharded_plan needs a policy with shards= "
                         "set (a repro_torch.core.ShardSpec)")
    from repro_torch.kernels import registry

    n = spec.resolved_n()
    local_policy = dataclasses.replace(policy, shards=None)
    with _trace.span("plan.build_sharded", cat="plan", n_shards=n,
                     dim=spec.dim, m=int(a.shape[0]),
                     k=int(a.shape[1])) as sp:
        shards = shard_csr_by_nnz(a, n, dim=spec.dim)
        nnz_per = shards.nnz_per_shard()
        mean_nnz = sum(nnz_per) / max(len(nnz_per), 1)
        imbalance = (max(nnz_per) / mean_nnz) if mean_nnz > 0 else 1.0
        _shard_imbalance.labels(dim=spec.dim).set(imbalance)
        # Resolve on the *unpadded* local patterns: a shard's method must
        # come from its true local stats, not stats diluted by padding.
        resolved = [local_policy.resolve(shards.unpadded(i))
                    for i in range(n)]
        sp.set(methods=[r.method for r in resolved],
               nnz_per_shard=list(nnz_per),
               nnz_imbalance=round(imbalance, 4))
    methods = {r.method for r in resolved}
    stackable = False
    if len(methods) == 1:
        # One method everywhere: unify the static params and check that
        # the method derives identical method-specific statics on the
        # shape-padded locals.
        t, tl, l_pad = _unify_params(resolved)
        mspec = registry.get_method(resolved[0].method)
        extras = [mspec.resolve_params(c, t=t, tl=tl, l_pad=l_pad)[3]
                  for c in shards.csrs]
        stackable = all(e == extras[0] for e in extras)
    if stackable:
        pinned = [PlanPolicy(method=resolved[0].method, t=t, tl=tl,
                             l_pad=l_pad, tunedb=None,
                             with_transpose=policy.with_transpose)] * n
        build_csrs = shards.csrs
    else:
        # Heterogeneous shards run the per-shard loop, where shape padding
        # buys nothing and can cost plenty (a rowsplit shard would ELL-pad
        # every filler row) — plan the true local patterns.
        pinned = [PlanPolicy(method=r.method, t=r.t, tl=r.tl, l_pad=r.l_pad,
                             tunedb=None,
                             with_transpose=policy.with_transpose)
                  for r in resolved]
        build_csrs = [shards.unpadded(i) for i in range(n)]
    if cache is not None:
        plans = tuple(cache.get(c, p) for c, p in zip(build_csrs, pinned))
    else:
        plans = tuple(build_plan(c, p) for c, p in zip(build_csrs, pinned))
    uniform = stackable and all(p.meta == plans[0].meta for p in plans)
    if _trace._enabled:
        _trace.event("plan.sharded_assembled", cat="plan", n_shards=n,
                     dim=spec.dim, uniform=uniform,
                     methods=[p.meta.method for p in plans])
    meta = ShardedMeta(shape=a.shape, nnz_pad=a.nnz_pad, dim=spec.dim,
                       bounds=shards.bounds, axis=spec.axis, mesh=spec.mesh,
                       uniform=uniform,
                       local_metas=tuple(p.meta for p in plans))
    plan = ShardedSpmmPlan(shards=plans, vals_slots=shards.vals_slots,
                           b_rows=shards.b_rows, meta=meta)
    if _verify_flags.verify_plans:
        # REPRO_VERIFY_PLANS debug hook: the per-shard plans were each
        # verified by build_plan; this checks the assembly against ``a``
        # (repro_torch.analysis.planlint.verify_sharded_plan).
        from repro_torch.analysis.planlint import check_plan
        check_plan(plan, a)
    return plan


# -------------------------------------------------------------- execution ---


def _with_zero(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with one zero slice appended along ``dim``: what the gathers'
    sentinels (``nnz_pad`` in ``vals_slots``, ``k`` in ``b_rows``) read."""
    shape = list(x.shape)
    shape[dim] = 1
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _concat_rows(outs, bounds):
    """Row-concatenate per-shard outputs, dropping each shard's pad rows."""
    sizes = [bounds[i + 1] - bounds[i] for i in range(len(outs))]
    return torch.cat([o[..., :sz, :] for o, sz in zip(outs, sizes)], dim=-2)


def execute_sharded(plan: ShardedSpmmPlan, vals: torch.Tensor,
                    b: torch.Tensor, exec: ExecutionConfig | None = None, *,
                    bias: torch.Tensor | None = None,
                    residual: torch.Tensor | None = None) -> torch.Tensor:
    """C = A @ B through a sharded plan, with A's *global* values per call.

    Mirrors ``core.spmm.execute_plan``: differentiable in ``vals``, ``b``,
    ``bias`` and ``residual``, batched ``b (..., k, n) → (..., m, n)``.
    With a uniform plan, a matching mesh and an initialised process group
    every rank runs its own shard (the SPMD path); otherwise a per-shard
    loop computes the same values on the tensors' device.

    The epilogue applies *after* shard assembly — a row shard holds only a
    row slice of C, and a column shard a rank-``m`` *partial sum*, through
    which a nonlinear activation does not commute — so the shards run
    epilogue-free in ``acc_dtype`` and the single tail lands on the
    assembled C, then the one cast to ``out_dtype``.
    """
    exec = exec if exec is not None else ExecutionConfig()
    meta = plan.meta
    if tuple(vals.shape) != (meta.nnz_pad,):
        raise ValueError(
            f"sharded plan expects the global vals of shape "
            f"({meta.nnz_pad},) for pattern {meta.shape}, got "
            f"{tuple(vals.shape)}")
    if b.dim() < 2 or b.shape[-2] != meta.k:
        raise ValueError(
            f"sharded plan expects B of shape (..., {meta.k}, n) for "
            f"pattern {meta.shape}, got {tuple(b.shape)}")
    exec = _resolve_exec("execute_sharded", meta.m, vals, b, exec, bias,
                         residual)
    ep = exec.epilogue
    # Shards emit acc-precision blocks/partials (a cols-dim sum must not
    # add down-cast partials); the out_dtype cast waits for the tail.
    inner = dataclasses.replace(exec, epilogue=None,
                                out_dtype=exec.acc_dtype)
    mesh = meta.spmd_mesh()
    if _trace._enabled:
        path = "spmd" if mesh is not None else "loop"
        _sharded_execute.labels(path=path).inc()
        _trace.event("dispatch.sharded", cat="dispatch", path=path,
                     n_shards=meta.n_shards, dim=meta.dim,
                     uniform=meta.uniform, impl=exec.impl,
                     method=meta.method, n=int(b.shape[-1]),
                     acc_dtype=exec.acc_dtype, out_dtype=exec.out_dtype)
    out = _execute_spmd(plan, vals, b, inner, mesh) if mesh is not None \
        else _execute_loop(plan, vals, b, inner)
    if ep is not None:
        acc = torch_dtype(exec.acc_dtype)
        out = apply_epilogue(out, ep,
                             bias.to(acc)[:, None] if ep.bias else None,
                             residual if ep.residual else None)
    return out.to(torch_dtype(exec.out_dtype))


def _execute_loop(plan, vals, b, exec):
    """Per-shard execution: correct for any shard mix, any device count."""
    meta = plan.meta
    cols = meta.dim == "cols"
    # The sentinels' zeros appended once a call, not once a shard.
    vals_ext = _with_zero(vals, 0)
    b_ext = _with_zero(b, b.dim() - 2) if cols else None
    outs = []
    for i, (p, slot) in enumerate(zip(plan.shards, plan.vals_slots)):
        lb = b_ext.index_select(b.dim() - 2, plan.b_rows[i]) if cols else b
        outs.append(execute_plan(p, vals_ext.index_select(0, slot), lb,
                                 exec))
    if meta.dim == "rows":
        return _concat_rows(outs, meta.bounds)
    return sum(outs[1:], outs[0])


class _Replicated(torch.autograd.Function):
    """``vals`` and ``b`` entering the SPMD body: the identity forward;
    the backward all-reduces (SUM) each rank's partial gradient over the
    group, so every rank ends with the whole gradient, once."""

    @staticmethod
    def forward(ctx, group, vals, b):
        ctx.group = group
        return vals.view_as(vals), b.view_as(b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_vals, d_b):
        # Both in one fixed order on every rank (zeros where a cotangent
        # is absent), so the ranks' collectives always pair up.
        out = []
        for need, g in zip(ctx.needs_input_grad[1:], (d_vals, d_b)):
            if need:
                g = g.contiguous().clone()
                torch.distributed.all_reduce(g, group=ctx.group)
            out.append(g if need else None)
        return (None, *out)


class _AssembleRows(torch.autograd.Function):
    """This rank's row block → the whole C on every rank.  The backward
    takes this rank's rows of the replicated dC, with no communication."""

    @staticmethod
    def forward(ctx, local, group, rank, bounds):
        ctx.rank, ctx.bounds = rank, bounds
        ctx.local_shape = local.shape
        r0, r1 = bounds[rank], bounds[rank + 1]
        buf = local.new_zeros(local.shape[:-2] + (bounds[-1],
                                                  local.shape[-1]))
        buf[..., r0:r1, :] = local[..., :r1 - r0, :]
        torch.distributed.all_reduce(buf, group=group)
        return buf

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dc):
        r0, r1 = ctx.bounds[ctx.rank], ctx.bounds[ctx.rank + 1]
        d = dc.new_zeros(ctx.local_shape)
        d[..., :r1 - r0, :] = dc[..., r0:r1, :]
        return d, None, None, None


class _SumPartials(torch.autograd.Function):
    """This rank's rank-``m`` partial → their SUM on every rank.  The
    backward hands the replicated dC to the partial as it is."""

    @staticmethod
    def forward(ctx, partial, group):
        out = partial.contiguous().clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, dc):
        return dc, None


def _execute_spmd(plan, vals, b, exec, mesh):
    """One shard a rank: this rank's planned kernel, then the assembly."""
    meta = plan.meta
    group = mesh.get_group(meta.axis)
    rank = mesh.get_local_rank(meta.axis)
    vals, b = _Replicated.apply(group, vals, b)
    lb = _with_zero(b, b.dim() - 2).index_select(
        b.dim() - 2, plan.b_rows[rank]) if meta.dim == "cols" else b
    local = execute_plan(plan.shards[rank], _with_zero(vals, 0).index_select(
        0, plan.vals_slots[rank]), lb, exec)
    if meta.dim == "rows":
        return _AssembleRows.apply(local, group, rank, meta.bounds)
    return _SumPartials.apply(local, group)
