"""Static verification of the port: the plan linter (the reference's
``repro.analysis``, its ``planlint`` leg).

* :mod:`repro_torch.analysis.planlint` -- host-side structural
  verification of built ``SpmmPlan`` objects (exactly-once nonzero
  coverage, merge-path tiling, sentinel hygiene, ...).  Also available as
  an opt-in hook on every plan build and plan-cache hit:
  ``REPRO_VERIFY_PLANS=1`` (or :func:`set_verify_plans`).
* ``python -m repro_torch.analysis planlint --suite mini`` verifies a plan
  of every registered method for every matrix of a suite.

This package is imported at load time by ``repro_torch.core.plan`` (for
the ``_flags`` gate), so the top level stays import-light: import the
linter as ``repro_torch.analysis.planlint``.
"""
from __future__ import annotations

from ._flags import set_verify_plans
from .diagnostics import Diagnostic, format_diagnostics

__all__ = ["Diagnostic", "format_diagnostics", "set_verify_plans"]
