"""Typed metrics: counters, gauges, histograms with labels.

A small in-process registry in the Prometheus shape -- metric *families*
declared once with a label schema, label-bound children created on
demand -- backing the engine's counters (plan-cache events, ladder rung
rates, dispatch counts), the program cache's, and the launchers' and the
online server's counters and latency histograms (a copy of the
reference's ``repro.obs.metrics``).

Every child guards its state with its own lock, so concurrent executors
(the server's batcher thread and its submitters) never lose increments.

``MetricsRegistry.snapshot()`` returns a JSON-serializable dict (the
``--metrics-out`` dump), ``report()`` a text exposition for terminals;
:data:`registry` is the process-global instance every site shares.
"""
from __future__ import annotations

import json
import math
import os
import threading
from collections import deque
from collections.abc import Iterable, Sequence

DEFAULT_RESERVOIR = 1024


class _Child:
    __slots__ = ("_lock", "labels")

    def __init__(self, labels: dict):
        self._lock = threading.Lock()
        self.labels = labels


class Counter(_Child):
    """Monotone counter. ``inc`` is atomic under the child's lock."""

    __slots__ = ("_value",)

    def __init__(self, labels: dict):
        super().__init__(labels)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def snapshot(self) -> dict:
        return {"value": self.value}


class Gauge(_Child):
    """Set-to-current-value metric (cache size, shard imbalance, ...)."""

    __slots__ = ("_value",)

    def __init__(self, labels: dict):
        super().__init__(labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def snapshot(self) -> dict:
        return {"value": self.value}


class Histogram(_Child):
    """Latency-style histogram: count/sum/min/max plus a bounded sample
    reservoir (most recent ``reservoir`` observations) for p50/p95."""

    __slots__ = ("_count", "_sum", "_min", "_max", "_samples")

    def __init__(self, labels: dict, reservoir: int = DEFAULT_RESERVOIR):
        super().__init__(labels)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._samples: deque = deque(maxlen=reservoir)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            self._samples.append(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """p in [0, 100], over the retained reservoir. NaN when empty."""
        with self._lock:
            xs = sorted(self._samples)
        if not xs:
            return math.nan
        if len(xs) == 1:
            return xs[0]
        # linear interpolation between closest ranks
        rank = (p / 100.0) * (len(xs) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] * (1 - frac) + xs[hi] * frac

    def reset(self) -> None:
        with self._lock:
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf
            self._samples.clear()

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
        if count == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": count, "sum": total, "min": mn, "max": mx,
                "mean": total / count, "p50": self.percentile(50),
                "p95": self.percentile(95)}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric + label schema; children per label-value tuple."""

    def __init__(self, name: str, kind: str, help: str,
                 label_names: Sequence[str], **child_kw):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self._child_kw = child_kw
        self._children: dict[tuple, _Child] = {}
        self._lock = threading.Lock()

    def labels(self, **kv) -> _Child:
        """The child bound to these label values (created on demand)."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = _KINDS[self.kind](
                        dict(zip(self.label_names, key)), **self._child_kw)
                    self._children[key] = child
        return child

    # Unlabeled convenience: family acts as its single () child.
    def _default(self) -> _Child:
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} has labels {self.label_names}; "
                "bind them with .labels(...)")
        return self.labels()

    def inc(self, n=1) -> None:
        self._default().inc(n)

    def set(self, v) -> None:
        self._default().set(v)

    def dec(self, n=1) -> None:
        self._default().dec(n)

    def observe(self, v) -> None:
        self._default().observe(v)

    @property
    def value(self):
        return self._default().value

    def children(self) -> Iterable[_Child]:
        with self._lock:
            return list(self._children.values())

    def reset(self) -> None:
        for c in self.children():
            c.reset()

    def snapshot(self) -> dict:
        return {
            "type": self.kind,
            "help": self.help,
            "labels": list(self.label_names),
            "values": [dict(labels=c.labels, **c.snapshot())
                       for c in self.children()],
        }


class MetricsRegistry:
    """Declare-once metric families; snapshot/report/dump the lot.

    Re-declaring a name with the same (kind, labels) returns the existing
    family — instrumentation sites in different modules can share a
    metric without import-order coupling; a conflicting re-declaration
    raises.
    """

    def __init__(self):
        self._families: dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _declare(self, name: str, kind: str, help: str,
                 labels: Sequence[str], **child_kw) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already declared as {fam.kind} "
                        f"with labels {fam.label_names}; cannot re-declare "
                        f"as {kind} with labels {tuple(labels)}")
                return fam
            fam = MetricFamily(name, kind, help, labels, **child_kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._declare(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._declare(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  reservoir: int = DEFAULT_RESERVOIR) -> MetricFamily:
        return self._declare(name, "histogram", help, labels,
                             reservoir=reservoir)

    def get(self, name: str) -> MetricFamily | None:
        with self._lock:
            return self._families.get(name)

    def families(self) -> list[MetricFamily]:
        with self._lock:
            return list(self._families.values())

    def snapshot(self) -> dict:
        return {f.name: f.snapshot() for f in self.families()}

    def report(self) -> str:
        """Text exposition: one ``name{labels} value`` line per child."""
        lines = []
        for fam in sorted(self.families(), key=lambda f: f.name):
            children = [c for c in fam.children()]
            if not children:
                continue
            if fam.help:
                lines.append(f"# {fam.name}: {fam.help}")
            for c in sorted(children,
                            key=lambda c: tuple(c.labels.values())):
                lab = ",".join(f"{k}={v}" for k, v in c.labels.items())
                lab = "{" + lab + "}" if lab else ""
                if fam.kind == "histogram":
                    s = c.snapshot()
                    if s["count"] == 0:
                        lines.append(f"{fam.name}{lab} count=0")
                    else:
                        lines.append(
                            f"{fam.name}{lab} count={s['count']} "
                            f"mean={s['mean']:.1f} p50={s['p50']:.1f} "
                            f"p95={s['p95']:.1f} min={s['min']:.1f} "
                            f"max={s['max']:.1f}")
                else:
                    v = c.value
                    vs = f"{v:g}" if isinstance(v, float) else str(v)
                    lines.append(f"{fam.name}{lab} {vs}")
        return "\n".join(lines)

    def dump(self, path: str, *, extra: dict | None = None) -> str:
        """Write a JSON snapshot (``--metrics-out``); returns the path."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        payload = {"schema": 1, "metrics": self.snapshot()}
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return path

    def reset(self) -> None:
        """Zero every child (tests / between bench sections)."""
        for fam in self.families():
            fam.reset()


# The process-global registry: instrumentation sites across the port share
# it without import-order coupling.
registry = MetricsRegistry()
