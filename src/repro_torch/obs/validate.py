"""Validate observability artifacts: Chrome traces and metrics dumps (a
copy of the reference's ``repro.obs.validate``, with its problem strings).

A traced serve or train run is followed by this module on the emitted
files, so a malformed trace or an empty span set fails instead of leaving
a useless artifact behind.

CLI::

    python -m repro_torch.obs.validate --trace artifacts/serve_trace.json \
        --require-cats plan,cache,dispatch,serve \
        --metrics artifacts/serve_metrics.json \
        --require-metrics plan_resolve_total,plan_cache_events_total

Exit code 0 on success, 1 with a diagnostic on the first failure.
"""
from __future__ import annotations

import argparse
import json
import sys

_SPAN_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def validate_trace(path: str, *, require_cats: tuple[str, ...] = (),
                   min_events: int = 1) -> list[str]:
    """Schema-check a Chrome trace-event JSON file.

    Returns a list of problems (empty = valid): top-level shape,
    per-event required fields, ``ph=X`` events carrying a numeric
    ``dur``, at least ``min_events`` events, and at least one event in
    every category named in ``require_cats``.
    """
    problems: list[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable or not JSON: {e}"]
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return [f"{path}: missing top-level 'traceEvents'"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return [f"{path}: 'traceEvents' is not a list"]
    if len(evs) < min_events:
        problems.append(
            f"{path}: only {len(evs)} events (< {min_events} required)")
    cats = set()
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"{path}: event[{i}] is not an object")
            continue
        for k in _SPAN_REQUIRED:
            if k not in ev:
                problems.append(f"{path}: event[{i}] missing {k!r}")
        if ev.get("ph") == "X" and not isinstance(
                ev.get("dur"), (int, float)):
            problems.append(
                f"{path}: event[{i}] ph=X without numeric 'dur'")
        cats.add(ev.get("cat", ""))
    for c in require_cats:
        if c not in cats:
            problems.append(
                f"{path}: no events in required category {c!r} "
                f"(saw: {sorted(cats)})")
    return problems


def validate_metrics(path: str, *, require_names: tuple[str, ...] = ()
                     ) -> list[str]:
    """Schema-check a ``--metrics-out`` JSON dump."""
    problems: list[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable or not JSON: {e}"]
    if not isinstance(doc, dict) or doc.get("schema") != 1:
        return [f"{path}: missing or unexpected 'schema' (want 1)"]
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict) or not metrics:
        return [f"{path}: 'metrics' missing or empty"]
    for name, fam in metrics.items():
        if not isinstance(fam, dict) or "type" not in fam \
                or "values" not in fam:
            problems.append(f"{path}: family {name!r} malformed")
    for name in require_names:
        if name not in metrics:
            problems.append(f"{path}: required metric {name!r} absent "
                            f"(saw: {sorted(metrics)})")
    return problems


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="validate Chrome trace / metrics-dump artifacts")
    p.add_argument("--trace", action="append", default=[],
                   help="Chrome trace JSON to validate (repeatable)")
    p.add_argument("--metrics", action="append", default=[],
                   help="metrics dump JSON to validate (repeatable)")
    p.add_argument("--require-cats", default="",
                   help="comma-separated categories every trace must have")
    p.add_argument("--require-metrics", default="",
                   help="comma-separated metric names every dump must have")
    p.add_argument("--min-events", type=int, default=1)
    args = p.parse_args(argv)
    if not args.trace and not args.metrics:
        p.error("nothing to validate: pass --trace and/or --metrics")
    cats = tuple(c for c in args.require_cats.split(",") if c)
    names = tuple(n for n in args.require_metrics.split(",") if n)
    problems: list[str] = []
    for t in args.trace:
        problems += validate_trace(t, require_cats=cats,
                                   min_events=args.min_events)
    for m in args.metrics:
        problems += validate_metrics(m, require_names=names)
    if problems:
        for pr in problems:
            print(f"validate: FAIL {pr}", file=sys.stderr)
        return 1
    for t in args.trace:
        print(f"validate: OK trace {t}")
    for m in args.metrics:
        print(f"validate: OK metrics {m}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
