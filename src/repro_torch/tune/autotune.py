"""Empirical autotuner: measure every registered method, record the winner.

What gets timed is the steady state the engine runs: a plan is built once
per (method, candidate) outside the timed region, then the eager
``execute_plan`` is timed — the plan-once/execute-many regime.  On a CUDA
tensor that is the hand-written kernels (``impl`` None picks by device),
so a DB built on the card records the card's kernels, not their plain
versions or a library's.

The method list and each method's static-parameter candidates (row-split
``l_pad`` pads, merge chunk sizes ``t``) come from the method registry
(``repro_torch.kernels.registry``), as in the reference's
``repro.tune.autotune``.  The winner's method and parameters are recorded
so exact-pattern TuneDB hits replay them at plan build; per-method best
timings land in ``TuneRecord.timings``.

The winner is the faster of the core merge/row-split pair unless another
method beats it by more than the noise (:func:`pick_winner`).  The timing
is the device's (``timing.timeit``); a method outside the pair costs more
host dispatch a call (rowgroup: a launch a length bucket and a gather),
which an eager caller pays and the timing does not see, so a win within
the noise would be no win there.
"""
from __future__ import annotations

import math
from collections.abc import Callable, Iterable

import numpy as np
import torch

from repro_torch.core.config import ExecutionConfig, PlanPolicy
from repro_torch.core.csr import CSR
from repro_torch.core.plan import build_plan, pattern_fingerprint
from repro_torch.core.spmm import execute_plan
from repro_torch.matrices.stats import compute_stats
from repro_torch.matrices.suites import MatrixSpec

from .db import TuneDB, TuneRecord
from .timing import TimingResult, timeit

CORE = ("merge", "rowsplit")


def _time_plan(a: CSR, b: torch.Tensor, *, method: str, impl: str | None,
               warmup: int, repeat: int, **cand) -> float:
    plan = build_plan(a, PlanPolicy(method=method, with_transpose=False,
                                    **cand))
    run = ExecutionConfig(impl=impl)
    return timeit(lambda vals, bb: execute_plan(plan, vals, bb, run),
                  a.vals, b, warmup=warmup, repeat=repeat)


def pick_winner(results: dict[str, TimingResult]) -> str:
    """The faster of the core pair (:data:`CORE`), or the fastest other
    method whose median beats it by more than the larger of the two
    timings' cv (relative to the core pair's best median)."""
    core = min(CORE, key=results.get)
    best = results[core]
    others = [m for m, us in results.items() if m not in CORE
              and us < best * (1.0 - max(us.cv, best.cv))]
    return min(others, key=results.get) if others else core


def tune_pattern(a: CSR, *, n: int = 64, impl: str | None = None,
                 warmup: int = 2, repeat: int = 5, wide: bool = False,
                 name: str = "", seed: int = 0,
                 log: Callable[[str], None] = lambda s: None) -> TuneRecord:
    """Time every registered method (over its candidates) on a pattern,
    on ``a``'s device; ``log`` gets one line a timed candidate."""
    from repro_torch.kernels import registry

    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.standard_normal((a.k, n)), device=a.device) \
        .to(a.dtype)

    results: dict[str, TimingResult] = {}
    best_kw: dict[str, dict] = {}
    for mname in registry.method_names():
        spec = registry.get_method(mname)
        best, bkw = math.inf, {}
        for cand in spec.tune_candidates(a, wide):
            us = _time_plan(a, b, method=mname, impl=impl, warmup=warmup,
                            repeat=repeat, **cand)
            params = "".join(f" {k}={v}" for k, v in cand.items())
            log(f"  {mname}{params}: {float(us):.3f}us (cv {us.cv:.3f})")
            if us < best:
                best, bkw = us, dict(cand)
        results[mname] = best
        best_kw[mname] = bkw

    s = compute_stats(a)
    timings = {m: float(us) for m, us in results.items()}
    method = pick_winner(results)
    return TuneRecord(method=method, merge_us=timings["merge"],
                      rowsplit_us=timings["rowsplit"], m=s.m, k=s.k,
                      d=s.d, cv=s.cv, n=n,
                      l_pad=best_kw[method].get("l_pad"),
                      t=best_kw[method].get("t"), name=name,
                      timings=timings)


def tune_suite(specs: Iterable[MatrixSpec], db: TuneDB, *, n: int = 64,
               impl: str | None = None, warmup: int = 2, repeat: int = 5,
               wide: bool = False, refresh: bool = False, device="cuda",
               log: Callable[[str], None] = lambda s: None) -> TuneDB:
    """Tune every spec, its matrix placed on ``device``, into ``db``
    (skipping patterns already recorded unless ``refresh``), then
    recalibrate the DB's fallback threshold from all its timings."""
    for spec in specs:
        a = spec().to(device)
        fp = pattern_fingerprint(a)
        if not refresh and db.lookup_exact(fp) is not None:
            log(f"{spec.name}: cached")
            continue
        rec = tune_pattern(a, n=n, impl=impl, warmup=warmup, repeat=repeat,
                           wide=wide, name=spec.name, log=log)
        db.record(fp, rec)
        others = "; ".join(f"{m} {us:.1f}us"
                           for m, us in sorted((rec.timings or {}).items()))
        log(f"{spec.name}: d={rec.d:.1f} cv={rec.cv:.2f} -> {rec.method} "
            f"({others})")
    if len(db):
        thr, acc = db.calibrate_threshold()
        log(f"calibrated threshold={thr:.2f} "
            f"(oracle agreement {acc * 100:.1f}%)")
    return db

