"""Engine-wide observability of the port: tracing, metrics, roofline
accounting (the reference's ``repro.obs``).

Three legs, all zero-cost when disabled:

* :mod:`repro_torch.obs.trace` -- scoped spans/instant events in a ring
  buffer, exportable as Chrome trace-event JSON (Perfetto-viewable), each
  span also a ``torch.profiler.record_function`` range inside a running
  ``torch.profiler`` capture.  Enable via
  ``REPRO_TRACE=1``, :func:`enable`, or ``with obs.tracing(): ...``.
* :mod:`repro_torch.obs.metrics` -- typed counter/gauge/histogram families
  with labels on the process-global :data:`registry`; :func:`report` /
  :func:`dump_metrics` expose them.
* :mod:`repro_torch.obs.roofline` -- bytes/flops models + the global
  :data:`accountant` relating measured device time to modeled minimum
  traffic, as a fraction of a measured streaming roof.

``python -m repro_torch.obs.validate`` checks an exported trace and a
``--metrics-out`` dump.
"""
from __future__ import annotations

from . import trace as trace
from .metrics import (Counter, Gauge, Histogram, MetricFamily,
                      MetricsRegistry, registry)
from .roofline import (Roof, RooflineAccountant, fused_epilogue_ceiling,
                       measure_roof, plan_bwd_min_bytes, plan_min_bytes,
                       sddmm_min_bytes, spmm_flops, spmm_min_bytes)
from .trace import (Tracer, complete, disable, enable, event, get_tracer,
                    is_enabled, span, tracing)

# Process-global accountant: sites that own a device time for a known
# program share it without import-order coupling.
accountant = RooflineAccountant()

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "Roof", "RooflineAccountant", "Tracer", "accountant", "complete",
    "disable", "dump_metrics", "enable", "event", "fused_epilogue_ceiling",
    "get_tracer", "is_enabled", "measure_roof", "plan_bwd_min_bytes",
    "plan_min_bytes", "registry", "report", "reset", "sddmm_min_bytes",
    "span", "spmm_flops", "spmm_min_bytes", "trace", "tracing",
]


def dump_metrics(path: str, *, extra: dict | None = None) -> str:
    """Write the global registry snapshot as JSON; returns the path."""
    return registry.dump(path, extra=extra)


def _rung_rates() -> dict[str, float]:
    """Ladder-rung hit rates from ``plan_resolve_total``, as fractions."""
    fam = registry.get("plan_resolve_total")
    if fam is None:
        return {}
    by_rung: dict[str, int] = {}
    for c in fam.children():
        rung = c.labels.get("rung", "?")
        by_rung[rung] = by_rung.get(rung, 0) + c.value
    total = sum(by_rung.values())
    if total == 0:
        return {}
    return {r: n / total for r, n in sorted(by_rung.items())}


def report(*, roof: Roof | None = None) -> str:
    """Text snapshot of the whole subsystem: ladder-rung hit rates,
    metrics exposition, the roofline accountant's verdicts and the trace
    ring's fill.

    Pass a :class:`Roof` (from :func:`measure_roof`) to get
    percent-of-roof numbers; omitted, achieved bandwidth still prints.
    """
    parts = []
    rates = _rung_rates()
    if rates:
        parts.append("== resolution ladder ==")
        parts.append("  ".join(f"{r}={v * 100:.1f}%"
                               for r, v in rates.items()))
    m = registry.report()
    if m:
        parts.append("== metrics ==")
        parts.append(m)
    parts.append("== roofline ==")
    parts.append(accountant.report(roof))
    tr = get_tracer()
    if tr is not None:
        parts.append(f"== trace == {len(tr)} events buffered"
                     + (f" ({tr.dropped} dropped)" if tr.dropped else ""))
    return "\n".join(parts)


def reset() -> None:
    """Zero metrics + roofline entries; clear the tracer ring (tests)."""
    registry.reset()
    accountant.reset()
    tr = get_tracer()
    if tr is not None:
        tr.clear()
