"""Debug-verification flag of the plan linter hook (the reference's
``repro.analysis._flags``, under the same environment variable).

Deliberately tiny: ``repro_torch.core.plan`` and
``repro_torch.engine.cache`` import this module at load time to gate the
``REPRO_VERIFY_PLANS`` hook, so it imports nothing heavier than ``os``
(one module-level attribute read when the hook is off, zero other cost).
"""
from __future__ import annotations

import os

# True: every plan built through build_plan, and every plan PlanCache.get
# serves from its cache, is verified host-side (repro_torch.analysis.
# planlint) against the CSR presented.  Off by default; enable with
# REPRO_VERIFY_PLANS=1 or set_verify_plans(True).
verify_plans: bool = os.environ.get("REPRO_VERIFY_PLANS", "") not in (
    "", "0", "false", "no")


def set_verify_plans(on: bool) -> bool:
    """Flip the plan-verification hook; returns the previous value."""
    global verify_plans
    prev, verify_plans = verify_plans, bool(on)
    return prev
