"""Observability of the port: the metrics registry (counters, gauges,
histograms with labels).  Tracing spans are not ported yet."""
from .metrics import (Counter, Gauge, Histogram, MetricFamily,
                      MetricsRegistry, dump, registry, report)

__all__ = ["Counter", "Gauge", "Histogram", "MetricFamily",
           "MetricsRegistry", "dump", "registry", "report"]
