"""``python -m repro_torch.analysis {planlint,audit,lint,traffic,all}``.

    # every leg, cheapest first, on the card (--device cpu without one)
    python -m repro_torch.analysis all
    python -m repro_torch.analysis all --device cpu --json /tmp/all.json
    # regenerate the committed traffic baseline after an intended change
    python -m repro_torch.analysis traffic --update --device cpu

* ``planlint`` -- build a plan per registered method, and a two-shard
  plan by rows and by cols (``verify_sharded_plan``), for every matrix in
  a suite (``repro_torch.matrices``), on the device, and run the full
  structural linter over each; a corrupt planner fails here before any
  kernel would read the structure.
* ``audit`` -- the kernel audit (``kernel_audit``: the launch models
  against the card's resources, gathers in bounds over real plans, a
  single writer); ``--out`` writes the report table.
* ``lint`` -- the port's AST rules (RL001-RL003) over ``src/repro_torch``,
  ``chip_smoke.py`` and ``tests/test_torch_*.py``, or the given paths.
* ``traffic`` -- the bytes-moved analyzer and the coalescing proof
  (``traffic``, ``access``); ``--check`` also diffs against the committed
  baseline, ``--update`` rewrites it.
* ``all`` -- lint, planlint, audit and ``traffic --check``, cheapest
  first.

Every leg takes ``--device`` (default ``cuda``: plans are built and the
card's limits read there; ``cpu`` uses the committed H100 SXM table) and
``--json PATH``, the reference's machine-readable report (``{"command",
"exit", "diagnostics": [{code, where, message}], ...}``); ``all --json``
nests the per-leg payloads.  Exit status is non-zero iff a leg found
anything.
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


def _repo_root() -> str:
    """The checkout's root (``src/repro_torch/analysis/cli.py`` three
    levels down), else the working directory."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    if os.path.isfile(os.path.join(root, "chip_smoke.py")):
        return root
    return os.getcwd()


def run_planlint(suite: str = "mini", out=None, *, device="cuda",
                 json_path=None, payload=None) -> int:
    """Self-check: verify every (suite matrix x registered method) plan,
    and each matrix's two-shard plans by rows and by cols."""
    from repro_torch.analysis import planlint
    from repro_torch.core.config import PlanPolicy, ShardSpec
    from repro_torch.core.plan import build_plan
    from repro_torch.distributed.spmm import build_sharded_plan
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
        for dim in ("rows", "cols"):
            plan = build_sharded_plan(
                a, PlanPolicy(shards=ShardSpec(n=2, dim=dim)))
            diags = planlint.verify_sharded_plan(plan, a)
            checked += 1
            if diags:
                all_diags.extend(diags)
                print(format_diagnostics(
                    diags, header=f"{spec.name} × sharded/{dim}:"),
                    file=out)
    print(f"planlint: {checked} plan(s) verified on suite {suite!r} "
          f"({device}), {len(all_diags)} finding(s)", file=out)
    rc = 1 if all_diags else 0
    rec = {"command": "planlint", "exit": rc, "suite": suite,
           "plans_checked": checked, "diagnostics": _diag_dicts(all_diags)}
    if payload is not None:
        payload["planlint"] = rec
    _write_json(json_path, rec)
    return rc


def run_audit(report_path=None, out=None, *, device="cuda", json_path=None,
              payload=None) -> int:
    """The kernel audit over every method and extra kernel."""
    from repro_torch.analysis import kernel_audit

    rows, diags = kernel_audit.audit_all(device=device)
    report = kernel_audit.format_report(rows, diags)
    print(report, file=out)
    if report_path:
        os.makedirs(os.path.dirname(report_path) or ".", exist_ok=True)
        with open(report_path, "w", encoding="utf-8") as f:
            f.write(report + "\n")
        print(f"audit: report written to {report_path}", file=out)
    rc = 1 if diags else 0
    rec = {"command": "audit", "exit": rc,
           "rows": [{"method": r.method, "impl": r.impl,
                     "variant": r.variant, "smem_bytes": r.smem_bytes}
                    for r in rows],
           "diagnostics": _diag_dicts(diags)}
    if payload is not None:
        payload["audit"] = rec
    _write_json(json_path, rec)
    return rc


def run_repo_lint(paths=None, out=None, *, json_path=None,
                  payload=None) -> int:
    """The port's AST rules over ``paths`` (default: the port's files)."""
    from repro_torch.analysis import lint

    diags = lint.run_lint(paths or None, repo_root=_repo_root())
    if diags:
        print(format_diagnostics(diags), file=out)
    print(f"lint: {len(diags)} finding(s)", file=out)
    rc = 1 if diags else 0
    rec = {"command": "lint", "exit": rc,
           "diagnostics": _diag_dicts(diags)}
    if payload is not None:
        payload["lint"] = rec
    _write_json(json_path, rec)
    return rc


def run_traffic(*, check: bool = False, update: bool = False,
                baseline_path=None, out=None, device="cuda",
                json_path=None, payload=None) -> int:
    """Bytes moved, the coalescing proof, and the baseline gate."""
    from repro_torch.analysis import access, traffic

    baseline_path = baseline_path or traffic.BASELINE_PATH
    rows, diags = traffic.analyze_all(device=device)
    diags = list(diags) + access.check_all(device=device)
    if update:
        traffic.update_baseline(rows, baseline_path)
        print(f"traffic: baseline written to {baseline_path}", file=out)
    elif check:
        diags += traffic.check_baseline(
            rows, traffic.load_baseline(baseline_path))
    print(traffic.format_report(rows, diags), file=out)
    rc = 1 if diags else 0
    rec = {"command": "traffic", "exit": rc,
           "baseline": os.path.relpath(baseline_path, _repo_root()),
           "checked_baseline": bool(check and not update),
           "rows": [r.to_dict() for r in rows],
           "diagnostics": _diag_dicts(diags)}
    if payload is not None:
        payload["traffic"] = rec
    _write_json(json_path, rec)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static verification of the port: plan linter, kernel "
                    "audit, repo lint, traffic analyzer")
    sub = p.add_subparsers(dest="cmd", required=True)
    legs = {
        "planlint": "verify plans over a suite",
        "audit": "static audit of the CUDA launch models",
        "lint": "AST lint of the port's files",
        "traffic": "bytes moved and coalescing, against the baseline",
        "all": "lint, planlint, audit, traffic --check (the gate)",
    }
    sps = {}
    for name, helptext in legs.items():
        sp = sps[name] = sub.add_parser(name, help=helptext)
        sp.add_argument("--device", default="cuda",
                        help="torch device the plans are built on and whose "
                        "limits the models take (default cuda; 'cpu' "
                        "without a card)")
        sp.add_argument("--json", default=None, dest="json_path",
                        help="write a machine-readable report to this path")
    for name in ("planlint", "all"):
        sps[name].add_argument("--suite", default="mini")
    sps["audit"].add_argument("--out", default=None,
                              help="write the report table to this path")
    sps["all"].add_argument("--audit-out", default=None)
    sps["lint"].add_argument("paths", nargs="*", help="files/dirs (default: "
                             "src/repro_torch, chip_smoke.py, "
                             "tests/test_torch_*.py)")
    tr = sps["traffic"]
    tr.add_argument("--check", action="store_true",
                    help="also diff against the committed baseline (exit 1 "
                    "on unexplained growth)")
    tr.add_argument("--update", action="store_true",
                    help="rewrite the baseline from the current tree")
    tr.add_argument("--baseline", default=None,
                    help="baseline path (default: the package's "
                    "analysis/traffic_baseline.json)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda, but torch sees no CUDA device; pass "
                "--device cpu")
    if args.cmd == "planlint":
        return run_planlint(args.suite, device=device,
                            json_path=args.json_path)
    if args.cmd == "audit":
        return run_audit(args.out, device=device, json_path=args.json_path)
    if args.cmd == "lint":
        return run_repo_lint(args.paths, json_path=args.json_path)
    if args.cmd == "traffic":
        return run_traffic(check=args.check, update=args.update,
                           baseline_path=args.baseline, device=device,
                           json_path=args.json_path)
    payload: dict = {}
    rcs = [run_repo_lint(None, payload=payload),        # cheapest first
           run_planlint(args.suite, device=device, payload=payload),
           run_audit(args.audit_out, device=device, payload=payload),
           run_traffic(check=True, device=device, payload=payload)]
    rc = max(rcs)
    _write_json(args.json_path,
                {"command": "all", "exit": rc, "legs": payload})
    return rc
