"""Pluggable SpMM method registry — adding a method is a registration.

The paper frames SpMM as a dispatch decision over a shared CSR input
(merge vs. row-split, §5.4).  Each method registers one
:class:`MethodSpec` bundling what plan building, the policy resolver
and the executor need; ``core.config.PlanPolicy.resolve``,
``core.plan.build_plan`` and ``core.spmm.execute_plan`` all dispatch
through this table.

The spec keeps the reference's nine hooks.  This port fills the ones the
planned forward path uses; ``inline`` (the plan-per-call form),
``tune_candidates`` (the autotuner) and ``traffic`` (the static launch
model) are None until the slices that port those consumers.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

from . import merge_spmm as _merge
from . import ops as _ops
from . import rowsplit_spmm as _rowsplit


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """Everything the engine needs to plan and execute one method.

    * ``build_structure(a, meta) -> dict`` of int32 tensors on ``a``'s
      device (pattern-only; values re-applied per call via ``slot_nz``).
    * ``execute(meta, fwd, vals, b, *, impl, epilogue=None, bias=None,
      residual=None, acc_dtype=None, out_dtype=None) -> C`` with
      ``b (..., k, n) -> (..., m, n)``.
    * ``resolve_params(a, *, t, tl, l_pad) -> (t, tl, l_pad, extra)``:
      fill defaults, validate, and compute hashable method statics.
    * ``heuristic_rank(a, heuristic) -> float``: analytic cost; the
      lowest-ranked method wins ``method="auto"`` (ties go to the
      later-registered spec, so the built-in pair reproduces the paper's
      rule ``d >= threshold -> rowsplit``).
    * ``inline``, ``tune_candidates``, ``traffic``: the reference's
      plan-per-call, autotuner and launch-model hooks.
    """

    name: str
    description: str
    build_structure: Callable
    execute: Callable
    inline: Callable | None
    resolve_params: Callable
    tune_candidates: Callable | None
    heuristic_rank: Callable | None
    traffic: Callable | None = None


_REGISTRY: dict[str, MethodSpec] = {}


def register_method(spec: MethodSpec) -> None:
    """Register an SpMM method. Raises on duplicate names."""
    if spec.name in _REGISTRY:
        raise ValueError(f"SpMM method {spec.name!r} is already registered")
    _REGISTRY[spec.name] = spec


def method_names() -> tuple[str, ...]:
    """Registered method names, in registration order."""
    return tuple(_REGISTRY)


def get_method(name: str) -> MethodSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"unknown SpMM method: {name!r}; registered methods: "
            + ", ".join(sorted(_REGISTRY)))
    return spec


def choose_auto(a, heuristic) -> str:
    """Resolve ``method="auto"`` through the registered cost hooks (ties
    go to the later-registered spec)."""
    best = None
    for name, spec in _REGISTRY.items():
        if spec.heuristic_rank is None:
            continue
        rank = spec.heuristic_rank(a, heuristic)
        if best is None or rank <= best[0]:
            best = (rank, name)
    if best is None:
        raise ValueError("no registered SpMM method is heuristic-eligible")
    return best[1]


# ------------------------------------------------------ built-in methods ---


def _max_row_len(a) -> int:
    if a.m == 0:
        return 0
    return int(a.row_lengths().max())


def _merge_resolve(a, *, t, tl, l_pad):
    t = _merge.DEFAULT_T if t is None else t
    tl = _rowsplit.DEFAULT_TL if tl is None else tl
    return t, tl, None, ()          # merge has no row pad


def _merge_execute(meta, fwd, vals, b, *, impl, epilogue=None, bias=None,
                   residual=None, acc_dtype=None, out_dtype=None):
    return _ops.merge_execute(fwd, vals, b, m=meta.m, impl=impl,
                              epilogue=epilogue, bias=bias,
                              residual=residual, acc_dtype=acc_dtype,
                              out_dtype=out_dtype)


def _rowsplit_resolve(a, *, t, tl, l_pad):
    t = _merge.DEFAULT_T if t is None else t
    tl = _rowsplit.DEFAULT_TL if tl is None else tl
    max_len = _max_row_len(a)
    if l_pad is None:
        l_pad = max(max_len, 1)
    elif l_pad < max_len:
        # An undersized pad would make the ELL mask silently truncate long
        # rows — a wrong C with no error.
        raise ValueError(
            f"l_pad={l_pad} is smaller than the pattern's longest row "
            f"({max_len} nonzeroes): the row-split ELL layout would "
            "silently drop nonzeroes and return a wrong C. Pass "
            f"l_pad >= {max_len}, or omit l_pad to derive it from the "
            "pattern.")
    return t, tl, l_pad, ()


def _rowsplit_execute(meta, fwd, vals, b, *, impl, epilogue=None,
                      bias=None, residual=None, acc_dtype=None,
                      out_dtype=None):
    return _ops.rowsplit_execute(fwd, vals, b, m=meta.m, impl=impl,
                                 epilogue=epilogue, bias=bias,
                                 residual=residual, acc_dtype=acc_dtype,
                                 out_dtype=out_dtype)


register_method(MethodSpec(
    name="merge",
    description="merge-based nonzero splitting (paper §4.2): equal "
                "nonzeroes per chunk, broken at output row tiles",
    build_structure=lambda a, meta: _merge.plan_merge_structure(a, t=meta.t),
    execute=_merge_execute,
    inline=None,
    resolve_params=_merge_resolve,
    tune_candidates=None,
    # The paper's §5.4 rule as a cost: d below the threshold prefers merge.
    heuristic_rank=lambda a, h: h.mean_row_length(a) - h.threshold,
    traffic=None,
))

register_method(MethodSpec(
    name="rowsplit",
    description="row splitting (paper §4.1): one warp per ELL-padded row",
    build_structure=lambda a, meta: _rowsplit.plan_rowsplit_structure(
        a, l_pad=meta.l_pad, tl=meta.tl),
    execute=_rowsplit_execute,
    inline=None,
    resolve_params=_rowsplit_resolve,
    tune_candidates=None,
    heuristic_rank=lambda a, h: h.threshold - h.mean_row_length(a),
    traffic=None,
))
