"""Plan policy vs. execution config (the reference's API v1 split).

* :class:`PlanPolicy` — decided once per sparsity pattern, host-side:
  which method (``"auto"`` resolves through the TuneDB ladder, then the
  method registry's heuristic cost hooks, the paper's §5.4 rule), static
  kernel parameters (``t``, ``tl``, ``l_pad``), and whether to build the
  transpose plan.  :meth:`PlanPolicy.resolve` is the single choke point
  every plan request funnels through.
  ``shards`` (a :class:`ShardSpec`) asks for a device-sharded plan
  instead (``repro_torch.distributed.spmm``).
* :class:`ExecutionConfig` — per call: which implementation runs
  (``"cuda"``: the hand-written kernels; ``"torch"``: their plain
  versions; ``None``: by the operands' device), the fused
  :class:`~repro_torch.core.epilogue.Epilogue`, and the accumulator /
  output dtype overrides.  Changing it never invalidates a plan.

The reference's Pallas knobs ``interpret`` and ``tk`` (interpret mode and
the VMEM K-tile cap) have no GPU meaning and are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

from .epilogue import Epilogue
from .heuristic import Heuristic

IMPLS = ("cuda", "torch")
_FLOAT_NAMES = ("float32", "bfloat16", "float16", "float64")


def _canon_dtype(x) -> str | None:
    """Normalize a dtype-ish (``torch.bfloat16``, ``"bfloat16"``) to its
    canonical name string, so ExecutionConfig stays hashable."""
    if x is None:
        return None
    if isinstance(x, str):
        name = x.removeprefix("torch.")
    elif isinstance(x, torch.dtype):
        name = str(x).removeprefix("torch.")
    else:
        raise TypeError(f"not a dtype: {x!r}")
    if name not in _FLOAT_NAMES:
        raise ValueError(
            f"ExecutionConfig dtypes must be floating, got {name!r}")
    return name


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# Ladder-rung outcomes of PlanPolicy.resolve: explicit | exact | class |
# calibrated | analytic.  Always on (plan time, not per execute).
_resolve_total = _metrics.registry.counter(
    "plan_resolve_total", "PlanPolicy.resolve outcomes by ladder rung",
    labels=("rung", "method"))


class _DefaultTuneDB:
    """Sentinel: 'use the process-default TuneDB' (``engine.set_tunedb``).

    Distinct from ``None``, which opts out of measured resolution and
    falls back to the analytic heuristic.
    """

    _instance: _DefaultTuneDB | None = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "DEFAULT_TUNEDB"


DEFAULT_TUNEDB = _DefaultTuneDB()


def mesh_axes(mesh) -> tuple[str, ...]:
    """The dim names of a ``torch.distributed.device_mesh.DeviceMesh``."""
    return tuple(mesh.mesh_dim_names or ())


def mesh_axis_size(mesh, axis: str) -> int:
    """The size of ``mesh``'s dim named ``axis``."""
    return mesh.size(mesh_axes(mesh).index(axis))


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How to shard an SpMM over devices (``PlanPolicy.shards``).

    ``n`` is the shard count (the mesh dim's size when a mesh is given);
    ``dim`` picks the nnz-balanced cut direction: ``"rows"`` (data
    parallel: a row block a shard, C the row concatenation) or ``"cols"``
    (tensor parallel: a column slice of A against a row block of B a
    shard, partial sums all-reduced).  ``axis`` defaults to ``"data"``
    for rows and ``"model"`` for cols.  ``mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh`` with named dims) is
    optional: without one, execution runs the per-shard loop on whatever
    device holds the data; with one whose ``axis`` size is ``n`` and an
    initialised process group, a uniform plan runs one shard a rank.
    Hashable (``DeviceMesh`` hashes by its layout, device type and dim
    names): a ShardSpec is part of the engine's plan-cache key.
    """

    n: int | None = None
    dim: str = "rows"
    axis: str | None = None        # default: "data" (rows) / "model"
    mesh: Any = None               # DeviceMesh | None

    def __post_init__(self):
        if self.dim not in ("rows", "cols"):
            raise ValueError(
                f"ShardSpec.dim must be 'rows' or 'cols', got {self.dim!r}")
        if self.n is None and self.mesh is None:
            raise ValueError("ShardSpec needs n= (shard count) or mesh=")
        if self.n is not None and self.n < 1:
            raise ValueError(f"ShardSpec.n must be >= 1, got {self.n}")
        if self.axis is None:
            object.__setattr__(
                self, "axis", "model" if self.dim == "cols" else "data")
        if self.mesh is not None:
            if self.axis not in mesh_axes(self.mesh):
                raise ValueError(
                    f"ShardSpec axis {self.axis!r} is not an axis of the "
                    f"mesh (axes: {mesh_axes(self.mesh)})")
            axis_size = mesh_axis_size(self.mesh, self.axis)
            if self.n is not None and self.n != axis_size:
                raise ValueError(
                    f"ShardSpec n={self.n} conflicts with mesh axis "
                    f"{self.axis!r} of size {axis_size}; drop n= to take "
                    "the axis size, or pass a matching mesh")

    def resolved_n(self) -> int:
        return self.n if self.n is not None else \
            mesh_axis_size(self.mesh, self.axis)


def _as_shard_spec(shards) -> ShardSpec | None:
    if shards is None or isinstance(shards, ShardSpec):
        return shards
    if isinstance(shards, int):
        return ShardSpec(n=shards)
    raise TypeError(
        f"PlanPolicy.shards must be a ShardSpec, an int shard count, or "
        f"None; got {type(shards).__name__}")


class ResolvedPlan(NamedTuple):
    """A fully pinned-down plan request (every static decision made)."""

    method: str
    t: int
    tl: int
    l_pad: int | None
    extra: tuple                  # hashable method-specific statics


@dataclasses.dataclass(frozen=True)
class PlanPolicy:
    """How to *plan*: method selection + pattern-static parameters.

    All fields are host-side decisions captured at plan-build time.
    ``method="auto"`` resolves through the TuneDB ladder (exact pattern →
    binned class → DB-calibrated threshold) and then the registry's
    heuristic cost hooks; explicit methods name a registered
    ``MethodSpec`` (``repro_torch.kernels.registry``).  ``tunedb``: a
    ``repro_torch.tune.TuneDB``, ``None`` (no measured resolution), or
    :data:`DEFAULT_TUNEDB` (the process default, ``engine.set_tunedb``).
    """

    method: str = "auto"
    t: int | None = None            # merge: nonzeroes per chunk
    tl: int | None = None           # rowsplit: row batch size
    l_pad: int | None = None        # rowsplit: static max row length
    heuristic: Heuristic | None = None
    tunedb: Any = DEFAULT_TUNEDB    # TuneDB | None (opt out) | default
    with_transpose: bool = True     # build the backward (CSC) plan
    shards: ShardSpec | None = None  # device sharding (int = n shards)

    def __post_init__(self):
        object.__setattr__(self, "shards", _as_shard_spec(self.shards))

    @classmethod
    def from_meta(cls, meta) -> PlanPolicy:
        """The policy that replays an existing plan's full statics."""
        return cls(method=meta.method, t=meta.t, tl=meta.tl,
                   l_pad=meta.l_pad, with_transpose=meta.has_transpose)

    def resolved_tunedb(self):
        """The TuneDB this policy actually consults (may be None)."""
        if self.tunedb is DEFAULT_TUNEDB:
            from repro_torch.engine import current_tunedb
            return current_tunedb()
        return self.tunedb

    def resolve(self, a) -> ResolvedPlan:
        """Pin down every pattern-static decision for a CSR (host-side).

        The single source of truth for ``build_plan`` and the engine cache
        key, so the two can never disagree.
        """
        from repro_torch.kernels import registry

        if self.shards is not None:
            raise ValueError(
                "PlanPolicy.resolve() pins down the statics of ONE "
                "pattern; a sharded policy resolves per shard — each "
                "shard's local stats pick its own method — inside "
                "repro_torch.distributed.spmm.build_sharded_plan (or via "
                "engine.get_plan, which dispatches on shards=).")
        method, t, l_pad = self.method, self.t, self.l_pad
        heuristic = self.heuristic
        tunedb = self.resolved_tunedb()
        # Which ladder rung decides the method: explicit requests skip the
        # ladder; "analytic" covers both the no-TuneDB heuristic and a
        # caller's Heuristic.
        rung = "explicit" if method != "auto" else "analytic"
        fallback = False
        if method == "auto" and tunedb is not None:
            picked, db_rung, rec = tunedb.pick(
                a, registered=registry.method_names())
            if db_rung == "exact":
                # Exact hit: replay the measured winner and tuned params.
                method = picked
                t = rec.t if t is None else t
                l_pad = rec.l_pad if l_pad is None else l_pad
                rung = "exact"
            elif db_rung == "class":
                method = picked
                rung = "class"
            elif heuristic is None:
                heuristic = tunedb.heuristic()   # calibrated threshold
                rung = "calibrated"
        auto_resolved = method != self.method     # the ladder picked it
        if method == "auto":
            method = registry.choose_auto(a, heuristic or Heuristic())
            auto_resolved = True
        spec = registry.get_method(method)
        try:
            t, tl, l_pad, extra = spec.resolve_params(a, t=t, tl=self.tl,
                                                      l_pad=l_pad)
        except ValueError:
            if not auto_resolved:
                raise                             # the caller asked for it
            # The ladder's winner rejects the caller's explicit params
            # (an exact record replays "rowgroup", but the caller passed a
            # global l_pad): an "auto" request falls back to the analytic
            # choice among the core methods.
            method = registry.choose_auto(a, heuristic or Heuristic())
            spec = registry.get_method(method)
            t, tl, l_pad, extra = spec.resolve_params(
                a, t=self.t, tl=self.tl, l_pad=self.l_pad)
            rung, fallback = "analytic", True
        _resolve_total.labels(rung=rung, method=method).inc()
        if _trace._enabled:
            m_, k_ = a.shape
            _trace.event("plan.resolve", cat="plan", rung=rung,
                         method=method, m=int(m_), k=int(k_),
                         nnz_pad=int(a.nnz_pad), t=t, tl=tl,
                         l_pad=l_pad, fallback=fallback)
        return ResolvedPlan(method=method, t=t, tl=tl, l_pad=l_pad,
                            extra=extra)


def resolve_counts(since: dict | None = None) -> dict[tuple[str, str], int]:
    """``plan_resolve_total`` as ``{(rung, method): count}``: so far, or
    the increments since an earlier ``resolve_counts()`` snapshot."""
    since = since or {}
    now = {(c.labels["rung"], c.labels["method"]): c.value
           for c in _resolve_total.children()}
    return {key: n - since.get(key, 0) for key, n in sorted(now.items())
            if n > since.get(key, 0)}


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How to *execute*: per-call backend knobs.

    ``impl``: ``"cuda"`` (the hand-written kernels; CUDA tensors only),
    ``"torch"`` (the plain PyTorch versions, any device), or ``None``
    (``"cuda"`` for CUDA tensors, ``"torch"`` for CPU tensors).  There is
    no fallback: ``"cuda"`` on a CPU tensor raises, and a kernel that fails
    to build or launch raises.

    ``epilogue``: a fused :class:`Epilogue` — ``y = act(C + bias) * scale
    + residual`` applied at the kernels' output write; the tensors travel
    as ``execute_plan``/``spmm`` arguments.  ``acc_dtype``: accumulator
    precision (None → float32, the only one the kernels take);
    ``out_dtype``: C's dtype (None → the promotion of the input dtypes).
    """

    impl: str | None = None
    epilogue: Epilogue | None = None
    acc_dtype: str | None = None
    out_dtype: str | None = None

    def __post_init__(self):
        if self.impl is not None and self.impl not in IMPLS:
            raise ValueError(
                f"ExecutionConfig.impl must be one of {IMPLS} or None, "
                f"got {self.impl!r}")
        object.__setattr__(self, "acc_dtype", _canon_dtype(self.acc_dtype))
        object.__setattr__(self, "out_dtype", _canon_dtype(self.out_dtype))
        if self.epilogue is not None and \
                not isinstance(self.epilogue, Epilogue):
            raise TypeError(
                "ExecutionConfig.epilogue must be a repro_torch Epilogue "
                f"(got {type(self.epilogue).__name__})")

