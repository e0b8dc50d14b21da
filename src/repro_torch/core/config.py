"""Plan policy vs. execution config (the reference's API v1 split).

* :class:`PlanPolicy` — decided once per sparsity pattern, host-side:
  which method (``"auto"`` resolves through the method registry's
  heuristic cost hooks, the paper's §5.4 rule), static kernel parameters
  (``t``, ``tl``, ``l_pad``), and whether to build the transpose plan.
  :meth:`PlanPolicy.resolve` is the single choke point every plan request
  funnels through.
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
from typing import NamedTuple

import torch

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

    All fields are host-side decisions captured at plan-build time and
    hashed into the engine cache key.  ``method="auto"`` resolves through
    the registry's heuristic cost hooks; explicit methods name a
    registered ``MethodSpec`` (``repro_torch.kernels.registry``).
    """

    method: str = "auto"
    t: int | None = None            # merge: nonzeroes per chunk
    tl: int | None = None           # rowsplit: row batch size
    l_pad: int | None = None        # rowsplit: static max row length
    heuristic: Heuristic | None = None
    with_transpose: bool = True     # build the backward (CSC) plan

    @classmethod
    def from_meta(cls, meta) -> PlanPolicy:
        """The policy that replays an existing plan's full statics."""
        return cls(method=meta.method, t=meta.t, tl=meta.tl,
                   l_pad=meta.l_pad, with_transpose=meta.has_transpose)

    def resolve(self, a) -> ResolvedPlan:
        """Pin down every pattern-static decision for a CSR (host-side).

        The single source of truth for ``build_plan`` and the engine cache
        key, so the two can never disagree.
        """
        from repro_torch.kernels import registry

        method = self.method
        if method == "auto":
            method = registry.choose_auto(a, self.heuristic or Heuristic())
        spec = registry.get_method(method)
        t, tl, l_pad, extra = spec.resolve_params(a, t=self.t, tl=self.tl,
                                                  l_pad=self.l_pad)
        return ResolvedPlan(method=method, t=t, tl=tl, l_pad=l_pad,
                            extra=extra)


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

