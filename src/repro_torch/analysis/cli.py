"""``python -m repro_torch.analysis {planlint,all}``.

    # every registered method's plan of every `mini` matrix, on the card
    python -m repro_torch.analysis planlint --suite mini
    python -m repro_torch.analysis planlint --suite mini --device cpu \
        --json /tmp/planlint.json

* ``planlint`` -- build a plan per registered method for every matrix in
  a suite (``repro_torch.matrices``), on the device, and run the full
  structural linter over each; a corrupt planner fails here before any
  kernel would read the structure.
* ``all`` -- every leg the port has; for now the plan linter alone.

The reference's sharded-plan legs wait for the port's sharding slice.
``--json PATH`` writes the reference's machine-readable report
(``{"command", "exit", "suite", "plans_checked", "diagnostics": [{code,
where, message}]}``); ``all --json`` nests the per-leg payloads.  Exit
status is non-zero iff a leg found anything.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from .diagnostics import format_diagnostics


def _diag_dicts(diags):
    return [{"code": d.code, "where": d.where, "message": d.message}
            for d in diags]


def _write_json(path, payload) -> None:
    if not path:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")


def run_planlint(suite: str = "mini", out=None, *, device="cuda",
                 json_path=None, payload=None) -> int:
    """Self-check: verify every (suite matrix x registered method) plan."""
    from repro_torch.analysis import planlint
    from repro_torch.core.config import PlanPolicy
    from repro_torch.core.plan import build_plan
    from repro_torch.kernels import registry
    from repro_torch.matrices.suites import get_suite

    all_diags = []
    checked = 0
    for spec in get_suite(suite):
        a = spec.build().to(device)
        for method in registry.method_names():
            plan = build_plan(a, PlanPolicy(method=method))
            diags = planlint.verify_plan(plan, a)
            checked += 1
            if diags:
                all_diags.extend(diags)
                print(format_diagnostics(
                    diags, header=f"{spec.name} × {method}:"), file=out)
    print(f"planlint: {checked} plan(s) verified on suite {suite!r} "
          f"({device}), {len(all_diags)} finding(s)", file=out)
    rc = 1 if all_diags else 0
    rec = {"command": "planlint", "exit": rc, "suite": suite,
           "plans_checked": checked, "diagnostics": _diag_dicts(all_diags)}
    if payload is not None:
        payload["planlint"] = rec
    _write_json(json_path, rec)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static verification of the port: the plan linter")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, helptext in (("planlint", "verify plans over a suite"),
                           ("all", "every leg (for now: planlint)")):
        sp = sub.add_parser(name, help=helptext)
        sp.add_argument("--suite", default="mini")
        sp.add_argument("--device", default="cuda",
                        help="torch device the plans are built on (default "
                        "cuda; 'cpu' without a card)")
        sp.add_argument("--json", default=None, dest="json_path",
                        help="write a machine-readable report to this path")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda, but torch sees no CUDA device; pass "
                "--device cpu")
    if args.cmd == "planlint":
        return run_planlint(args.suite, device=device,
                            json_path=args.json_path)
    payload: dict = {}
    rc = run_planlint(args.suite, device=device, payload=payload)
    _write_json(args.json_path,
                {"command": "all", "exit": rc, "legs": payload})
    return rc
