"""Static verification of the port (the reference's ``repro.analysis``).

* :mod:`repro_torch.analysis.planlint` -- host-side structural
  verification of built ``SpmmPlan`` objects (exactly-once nonzero
  coverage, merge-path tiling, sentinel hygiene, ...).  Also available as
  an opt-in hook on every plan build and plan-cache hit:
  ``REPRO_VERIFY_PLANS=1`` (or :func:`set_verify_plans`).
* :mod:`repro_torch.analysis.kernel_audit` -- the CUDA launch models
  (``repro_torch.kernels.introspect``) held to the card's resources, the
  gathers in bounds and a single writer over real plans (K001-K050).
* :mod:`repro_torch.analysis.access` -- coalescing proved per warp
  instruction, forward nonzero streams, the rowgroup permutation, kernel
  coverage (T101-T131).
* :mod:`repro_torch.analysis.traffic` -- bytes moved by every method x
  impl x variant x pass against the compulsory floor and the committed
  baseline (T010-T022).
* :mod:`repro_torch.analysis.lint` -- the port's AST rules (RL001-RL003).
* ``python -m repro_torch.analysis {planlint,audit,lint,traffic,all}``.

This package is imported at load time by ``repro_torch.core.plan`` (for
the ``_flags`` gate), so the top level stays import-light: import each leg
as ``repro_torch.analysis.<leg>``.
"""
from __future__ import annotations

from ._flags import set_verify_plans
from .diagnostics import Diagnostic, format_diagnostics

__all__ = ["Diagnostic", "format_diagnostics", "set_verify_plans"]
