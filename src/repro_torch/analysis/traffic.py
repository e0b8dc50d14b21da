"""Bytes-moved analyzer and its baseline gate.

The counterpart of the reference's ``repro.analysis.traffic``.  The
paper's verdict criterion is distance to the memory roof, so the
quantity to protect in review is bytes moved.  This module computes the
traffic of every registered method x impl x dtype/epilogue variant x
{fwd, bwd} on the audit's representative problem (``kernel_audit``'s
``irregular`` pattern, n 256, batch 2) and holds it against the
compulsory floor of ``repro_torch.obs.roofline``:

* ``impl="cuda"`` -- the bytes the launch models request from global
  memory (``MethodSpec.traffic`` -> ``repro_torch.kernels.introspect``),
  launched or not: no card is needed.  The backward adds the dB launches
  (merge on the plan's transpose, the float32 cotangent as B, dB in B's
  dtype) and the SDDMM launch.  The wrappers' casts of a bias or residual
  to float32 are outside the models.
* ``impl="torch"`` -- the plain twins (``kernels/ref.py``), the
  counterpart of the reference's HLO parse: ``execute_plan`` runs on the
  CPU under a ``TorchDispatchMode`` that sums each aten operation's input
  and output bytes (views move none), counts materialised transposes (a
  copy of a tensor whose strides are permuted) and the output bytes of
  widening ``_to_copy``\\ s.  The backward is the forward plus the
  gradients of every differentiable operand.

Diagnostics:

* **T010** -- bytes above the compulsory floor by more than the
  (method, impl, pass) tolerance calibrated at this tree;
* **T011** -- more materialised transposes than the allowance (0);
* **T012** -- more widening-copy bytes than the allowance;
* **T020/T021/T022** -- the baseline gate: bytes (or transposes, or
  widening bytes) grew beyond the committed baseline (+2 % slack), a row
  is missing from it (or there is no baseline), or it holds a stale row.

The baseline (:data:`BASELINE_PATH`) is committed inside the package;
``python -m repro_torch.analysis traffic --check`` runs the gate and
``traffic --update`` rewrites it after an intended traffic change.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import introspect as I

from .diagnostics import Diagnostic

SCHEMA_VERSION = 1
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "traffic_baseline.json")
IMPLS = ("cuda", "torch")
PASSES = ("fwd", "bwd")
#: baseline growth slack (T020)
BASELINE_SLACK = 0.02
N, BATCH, PATTERN = 256, 2, "irregular"


def _variants():
    """The full dtype x epilogue grid (a superset of the audit's two)."""
    from repro_torch.core.epilogue import Epilogue

    from .kernel_audit import Variant
    epi = Epilogue(bias=True, activation="gelu", residual=True)
    return (
        Variant("f32", "float32", "float32", "float32", None, None),
        Variant("f32+epi", "float32", "float32", "float32", None, epi),
        Variant("bf16_acc32", "bfloat16", "bfloat16", "float32",
                "bfloat16", None),
        Variant("bf16_acc32+epi", "bfloat16", "bfloat16", "float32",
                "bfloat16", epi),
    )


@dataclasses.dataclass(frozen=True)
class TrafficRow:
    """One analyzed program: method x impl x variant x pass."""

    method: str
    impl: str
    variant: str
    pass_: str                  # "fwd" | "bwd"
    bytes: int
    min_bytes: int
    transposes: int
    widen_bytes: int

    @property
    def key(self) -> str:
        return f"{self.method}/{self.impl}/{self.variant}/{self.pass_}"

    @property
    def ratio(self) -> float:
        return self.bytes / self.min_bytes if self.min_bytes else 0.0

    def to_dict(self) -> dict:
        return {"method": self.method, "impl": self.impl,
                "variant": self.variant, "pass": self.pass_,
                "bytes": self.bytes, "min_bytes": self.min_bytes,
                "transposes": self.transposes,
                "widen_bytes": self.widen_bytes}


# ------------------------------------------------------------ calibration ---

# Ceilings on bytes / min_bytes per (method, impl, pass), calibrated at
# this tree on the representative problem: the worst variant's ratio
# with ~25 % headroom.  The kernels gather one B row a nonzero (the
# compulsory floor counts B once), so their requested bytes sit far above
# the floor by design; the plain twins materialise every gathered row and
# the epilogue's intermediates.  The tolerance pins today's factor so
# that any further growth fires; the 2 %-slack baseline (T020) is the
# precise instrument on top.
_TOLERANCE = {
    ("merge", "cuda", "fwd"): 15.0,
    ("merge", "cuda", "bwd"): 16.0,
    ("merge", "torch", "fwd"): 121.0,
    ("merge", "torch", "bwd"): 114.0,
    ("rowsplit", "cuda", "fwd"): 15.0,
    ("rowsplit", "cuda", "bwd"): 16.0,
    ("rowsplit", "torch", "fwd"): 109.0,
    ("rowsplit", "torch", "bwd"): 111.0,
    ("rowgroup", "cuda", "fwd"): 16.0,
    ("rowgroup", "cuda", "bwd"): 16.0,
    ("rowgroup", "torch", "fwd"): 108.0,
    ("rowgroup", "torch", "bwd"): 111.0,
}
_DEFAULT_TOLERANCE = 6.0

# Materialised transposes allowed per (method, impl, pass): none at this
# tree, so any is T011.
_TRANSPOSE_ALLOW: dict = {}
_DEFAULT_TRANSPOSE = 0

# Widening-copy bytes per (method, impl, pass): the exact maxima over the
# variants at this tree (deterministic, so no headroom).
_WIDEN_ALLOW = {
    ("merge", "torch", "fwd"): 3_220_160,
    ("merge", "torch", "bwd"): 6_442_368,
    ("rowsplit", "torch", "fwd"): 3_278_848,
    ("rowsplit", "torch", "bwd"): 6_501_056,
    ("rowgroup", "torch", "fwd"): 15_826_944,
    ("rowgroup", "torch", "bwd"): 19_049_152,
}
_DEFAULT_WIDEN = 0


# --------------------------------------------------- the plain twins' ops ---


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _permuted(t) -> bool:
    """A tensor whose strides are not row-major order (a transposed or
    permuted view)."""
    if not isinstance(t, torch.Tensor) or t.dim() < 2 or t.is_contiguous():
        return False
    st = [s for s, n in zip(t.stride(), t.shape) if n > 1]
    return st != sorted(st, reverse=True)


_NO_BYTES = ("empty", "empty_like", "empty_strided", "detach", "alias",
             "lift_fresh", "_local_scalar_dense")
_COPIES = ("clone", "_to_copy", "copy_", "contiguous")


class OpCounter(TorchDispatchMode):
    """Sums each aten operation's input and output bytes (views and
    allocations move none), the materialised transposes and the output
    bytes of widening ``_to_copy``\\ s."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transposes = 0
        self.widen_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if getattr(func, "is_view", False) or name in _NO_BYTES:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.bytes += sum(map(_tensor_bytes, ins)) + \
            sum(map(_tensor_bytes, outs))
        if name in _COPIES and ins and _permuted(ins[-1] if name == "copy_"
                                                 else ins[0]):
            self.transposes += 1
        if name == "_to_copy" and ins and outs:
            src, dst = ins[0], outs[0]
            if src.is_floating_point() and dst.is_floating_point() and \
                    dst.element_size() > src.element_size():
                self.widen_bytes += _tensor_bytes(dst)
        return out


def _operands(plan, var, n, batch, requires_grad=False):
    """Seeded operands of one call on the CPU: vals, B (batch, k, n), a
    bias and a residual where the epilogue flags them."""
    g = torch.Generator().manual_seed(0)
    meta, ep = plan.meta, var.epilogue

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g).to(getattr(torch, dtype)) \
            .requires_grad_(requires_grad)

    vals = rnd(meta.nnz_pad, dtype=var.vals_dtype)
    b = rnd(batch, meta.k, n, dtype=var.b_dtype)
    bias = rnd(meta.m, dtype=var.b_dtype) if ep is not None and ep.bias \
        else None
    res = rnd(batch, meta.m, n, dtype=var.b_dtype) \
        if ep is not None and ep.residual else None
    return vals, b, bias, res


def torch_counts(plan, var, pass_, n: int = N, batch: int = BATCH):
    """The plain twin of one row run under :class:`OpCounter`: ``(bytes,
    transposes, widen_bytes)``."""
    from repro_torch.core.config import ExecutionConfig
    from repro_torch.core.spmm import execute_plan

    cfg = ExecutionConfig(impl="torch", epilogue=var.epilogue,
                          acc_dtype=var.acc_dtype, out_dtype=var.out_dtype)
    grad = pass_ == "bwd"
    vals, b, bias, res = _operands(plan, var, n, batch, requires_grad=grad)
    inputs = [t for t in (vals, b, bias, res) if t is not None]
    with OpCounter() as counter:
        with torch.set_grad_enabled(grad):
            out = execute_plan(plan, vals, b, cfg, bias=bias, residual=res)
            if grad:
                torch.autograd.grad(out, inputs, torch.ones_like(out))
    return counter.bytes, counter.transposes, counter.widen_bytes


# ------------------------------------------------------------ bytes models ---


def cuda_bytes(spec, plan, var, pass_, n: int = N, batch: int = BATCH,
               card=None) -> int:
    """The launch models' requested bytes; the backward adds dB (merge
    on the transpose plan) and the SDDMM."""
    from repro_torch.kernels import merge_spmm as _merge
    from repro_torch.kernels import sddmm as _sddmm

    card = card or I.card_of(plan.device)
    total = sum(m.requested_bytes()
                for m in spec.traffic(plan, n, batch, var, card))
    if pass_ == "fwd":
        return total
    m, k = plan.meta.shape
    total += sum(x.requested_bytes() for x in _merge.merge_launches(
        plan.bwd, m=k, k=m, nnz_pad=plan.meta.nnz_pad, n=n, batch=batch,
        vals_dtype=var.vals_dtype, b_dtype=var.acc_dtype,
        out_dtype=var.b_dtype, bias=False, residual=False, label="dB"))
    fwd = plan.fwd
    total += sum(x.requested_bytes() for x in _sddmm.launch_models(
        fwd["nz_rows"], fwd["nz_cols"], fwd["nz_valid"], m=m, k=k, n=n,
        batch=batch, dc_dtype=var.acc_dtype, b_dtype=var.b_dtype))
    return total


def min_bytes(meta, var, pass_, n: int = N, batch: int = BATCH) -> int:
    """The compulsory floor (``obs.roofline``): the forward's, plus the
    backward's extra (dB and the SDDMM)."""
    from repro_torch.obs.roofline import plan_bwd_min_bytes, plan_min_bytes
    total = plan_min_bytes(meta, n, val_dtype=var.vals_dtype,
                           out_dtype=var.out_dtype, batch=batch,
                           epilogue=var.epilogue, b_dtype=var.b_dtype)
    if pass_ == "bwd":
        total += plan_bwd_min_bytes(meta, n, val_dtype=var.vals_dtype,
                                    b_dtype=var.b_dtype, batch=batch)
    return total


# --------------------------------------------------------------- analysis ---


def analyze_variant(spec, plan, var, impl, pass_, *, n: int = N,
                    batch: int = BATCH, card=None) -> TrafficRow:
    """One row: the models' bytes (``cuda``) or the twin's counted ops
    (``torch``, a plan on the CPU), beside the floor."""
    if impl == "cuda":
        nbytes, tr, widen = cuda_bytes(spec, plan, var, pass_, n, batch,
                                       card), 0, 0
    else:
        nbytes, tr, widen = torch_counts(plan, var, pass_, n, batch)
    return TrafficRow(method=spec.name, impl=impl, variant=var.name,
                      pass_=pass_, bytes=int(nbytes),
                      min_bytes=int(min_bytes(plan.meta, var, pass_, n,
                                              batch)),
                      transposes=tr, widen_bytes=widen)


def check_row(row: TrafficRow) -> list[Diagnostic]:
    diags = []
    k = (row.method, row.impl, row.pass_)
    tol = _TOLERANCE.get(k, _DEFAULT_TOLERANCE)
    if row.min_bytes and row.bytes > row.min_bytes * tol:
        diags.append(Diagnostic(
            "T010", row.key,
            f"bytes {row.bytes:,} exceed the compulsory floor "
            f"{row.min_bytes:,} by {row.ratio:.1f}x (tolerance {tol}x) -- "
            "hidden copy, widened materialization, or a gather regression"))
    allow_t = _TRANSPOSE_ALLOW.get(k, _DEFAULT_TRANSPOSE)
    if row.transposes > allow_t:
        diags.append(Diagnostic(
            "T011", row.key,
            f"{row.transposes} materialised transpose(s) (allowance "
            f"{allow_t}) -- unexpected layout flip"))
    allow_w = _WIDEN_ALLOW.get(k, _DEFAULT_WIDEN)
    if row.widen_bytes > allow_w:
        diags.append(Diagnostic(
            "T012", row.key,
            f"{row.widen_bytes:,} widening-copy bytes (allowance "
            f"{allow_w:,}) -- a low-precision operand materialized wide"))
    return diags


def analyze_all(*, n: int = N, batch: int = BATCH, device="cpu",
                card=None):
    """Every method x impl x variant x pass on the representative
    problem; ``(rows, diagnostics)``.  Methods without a ``traffic`` hook
    are skipped here: ``access.check_coverage`` reports them (T101)."""
    from repro_torch.core import PlanPolicy, build_plan
    from repro_torch.kernels import registry

    from .kernel_audit import representative

    card = card or I.card_of(device)
    rows, diags = [], []
    a = representative(PATTERN, device)
    a_cpu = a if a.device.type == "cpu" else a.to("cpu")
    for name in registry.method_names():
        spec = registry.get_method(name)
        if spec.traffic is None:
            continue
        plans = {"cuda": build_plan(a, PlanPolicy(method=name,
                                                  with_transpose=True)),
                 "torch": build_plan(a_cpu, PlanPolicy(
                     method=name, with_transpose=True))}
        for var in _variants():
            for impl in IMPLS:
                for pass_ in PASSES:
                    row = analyze_variant(spec, plans[impl], var, impl,
                                          pass_, n=n, batch=batch,
                                          card=card)
                    rows.append(row)
                    diags.extend(check_row(row))
    return rows, diags


# ---------------------------------------------------------------- baseline ---


def load_baseline(path: str = BASELINE_PATH) -> dict:
    if not os.path.exists(path):
        return {"schema": SCHEMA_VERSION, "rows": None}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"traffic baseline {path} has schema {data.get('schema')!r}, "
            f"expected {SCHEMA_VERSION} -- regenerate with "
            "`python -m repro_torch.analysis traffic --update`")
    return data


def update_baseline(rows, path: str = BASELINE_PATH) -> dict:
    """Write the current rows as the baseline."""
    data = {"schema": SCHEMA_VERSION, "problem": {
        "pattern": PATTERN, "n": N, "batch": BATCH},
        "rows": {r.key: {"bytes": r.bytes, "min_bytes": r.min_bytes,
                         "transposes": r.transposes,
                         "widen_bytes": r.widen_bytes}
                 for r in sorted(rows, key=lambda r: r.key)}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    return data


def check_baseline(rows, data: dict) -> list[Diagnostic]:
    """Diff the rows against the baseline: growth is T020, a row missing
    from it (or no baseline) T021, a stale entry T022."""
    base = data.get("rows")
    if base is None:
        return [Diagnostic(
            "T021", "baseline",
            "no committed traffic baseline -- run `python -m "
            "repro_torch.analysis traffic --update` and commit the result")]
    diags, seen = [], set()
    for r in rows:
        seen.add(r.key)
        b = base.get(r.key)
        if b is None:
            diags.append(Diagnostic(
                "T021", r.key,
                "row missing from the committed baseline -- run `traffic "
                "--update` and commit the diff"))
            continue
        if r.bytes > b["bytes"] * (1.0 + BASELINE_SLACK):
            diags.append(Diagnostic(
                "T020", r.key,
                f"bytes grew {b['bytes']:,} -> {r.bytes:,} "
                f"(>{BASELINE_SLACK * 100:.0f}% slack) -- if intended, "
                "regenerate the baseline in the same commit"))
        if r.transposes > b.get("transposes", 0):
            diags.append(Diagnostic(
                "T020", r.key, f"materialised transposes grew "
                f"{b.get('transposes', 0)} -> {r.transposes}"))
        if r.widen_bytes > b.get("widen_bytes", 0):
            diags.append(Diagnostic(
                "T020", r.key, f"widening-copy bytes grew "
                f"{b.get('widen_bytes', 0):,} -> {r.widen_bytes:,}"))
    for key in sorted(set(base) - seen):
        diags.append(Diagnostic(
            "T022", key,
            "baseline entry no longer produced by the analyzer (stale "
            "row?) -- regenerate the baseline"))
    return diags


# ------------------------------------------------------------------ report ---


def format_report(rows, diags) -> str:
    header = (f"{'method':<10} {'impl':<6} {'variant':<16} {'pass':<4} "
              f"{'bytes':>13} {'min':>12} {'x':>7} {'tr':>3} "
              f"{'widen':>11}")
    lines = ["traffic report", header, "-" * len(header)]
    for r in rows:
        lines.append(
            f"{r.method:<10} {r.impl:<6} {r.variant:<16} {r.pass_:<4} "
            f"{r.bytes:>13,} {r.min_bytes:>12,} {r.ratio:>7.1f} "
            f"{r.transposes:>3} {r.widen_bytes:>11,}")
    if diags:
        lines.append("")
        lines.append(f"{len(diags)} finding(s):")
        lines.extend(f"  {d}" for d in diags)
    else:
        lines.append("no findings")
    return "\n".join(lines)
