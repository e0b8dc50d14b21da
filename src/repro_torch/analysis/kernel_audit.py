"""Registry-driven static audit of the port's CUDA kernels.

The counterpart of the reference's ``repro.analysis.kernel_audit``.  For
every registered ``MethodSpec`` and representative dtype/epilogue
variant, and for the kernels outside the registry
(``access.EXTRA_KERNELS``: the SDDMM, the grouped GEMM, flash attention),
it builds the launch models (``repro_torch.kernels.introspect``) over
real plans of representative patterns and checks, without launching
anything:

* **K001** -- a registered method with no launch model (neither a
  ``MethodSpec.traffic`` hook nor a :func:`register_audit` override): a
  hard failure, never a silent skip;
* **K002** -- a stale override naming a method that is not registered;
* **K020** -- the card's resources in place of the TPU's VMEM budget:
  dynamic plus static shared memory against the opt-in limit of a block
  (static alone against 48 KB); the ``__launch_bounds__`` minimum blocks
  an SM times that (plus the runtime's reserve a block) against the SM's
  shared memory, and times the block's threads against the SM's; threads
  <= 1024; grid.x <= 2^31 - 1, grid.y/z <= 65,535; at least one block
  resident; a 0-block launch only where the C entry returns early;
* **K030** -- every gather index in bounds over the real plan arrays
  (``KernelLaunch.indices``): columns below k, values through ``slot_nz``
  below ``nnz_pad``, row-split's live slots before their row's first
  sentinel (past it the walk has ended), merge's tile, row and split-row
  streams inside m;
* **K040** -- single writer: every (batch, row, 128-column slice) of C
  stored exactly once (``KernelLaunch.writers``): in merge by the range
  that holds the row whole or by the fix-up, never both; in row-split by
  part 0;
* **K050** -- the accumulator never narrower than the promotion of the
  inputs.

The reference's K010-K012 trace the jitted program and count its
``pallas_call`` launches and output dtype in the jaxpr; the port runs
eagerly and has no jaxpr, so they have no counterpart (the launch counts
are held on the card by ``chip_smoke.py``).

:func:`audit_all` returns ``(rows, diagnostics)``; ``rows`` is the
per-launch report table (``python -m repro_torch.analysis audit --out``).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.kernels import introspect as I

from .diagnostics import Diagnostic

#: static shared memory a block may declare (above it only dynamic)
STATIC_SMEM_LIMIT = 48 * 1024
#: the representative patterns every method plans against: rows of 1-63
#: nonzeros (rowgroup gets six buckets, merge about 16 ranges, row-split
#: full and partial groups of 32), and 16 long rows of 600-1000 on a wide
#: matrix (row-split splits each row in 8 parts, merge's rows cross
#: ranges); numpy-seeded, the same on every machine.
PATTERNS = {"irregular": (512, 1024, (1, 63)),
            "long_rows": (16, 4096, (600, 1000))}


@dataclasses.dataclass(frozen=True)
class Variant:
    """One representative dtype/epilogue corner audited per method."""

    name: str
    vals_dtype: str
    b_dtype: str
    acc_dtype: str
    out_dtype: str | None
    epilogue: object            # repro_torch.core.Epilogue | None


def _variants():
    from repro_torch.core.epilogue import Epilogue
    return (
        Variant("f32", "float32", "float32", "float32", None, None),
        Variant("bf16_acc32+epi", "bfloat16", "bfloat16", "float32",
                "bfloat16",
                Epilogue(bias=True, activation="gelu", residual=True)),
    )


#: method name -> builder(plan, n, batch, variant, card) -> [KernelLaunch]:
#: *overrides* for the registry's ``MethodSpec.traffic`` hook (tests,
#: out-of-tree methods).
_AUDITS: dict[str, Callable] = {}


def register_audit(name: str, models: Callable) -> None:
    """Override the launch models of a registered method (takes
    precedence over its ``MethodSpec.traffic`` hook); a name given twice
    raises."""
    if name in _AUDITS:
        raise ValueError(f"audit for method {name!r} already registered")
    _AUDITS[name] = models


def representative(pattern: str = "irregular", device="cpu"):
    """The pattern's CSR (``PATTERNS``), numpy seed 0, on ``device``."""
    from repro_torch.core import csr
    m, k, npr = PATTERNS[pattern]
    return csr.random_csr(0, m, k, nnz_per_row=npr, device=device)


# ----------------------------------------------------------- static checks ---


def check_resources(model: I.KernelLaunch, card: I.Card) -> list[str]:
    """K020: the launch against the card's limits (a PyTorch operation,
    ``symbol`` None, has none to hold)."""
    if model.symbol is None:
        return []
    bad = []
    x, y, z = model.grid
    if model.launched and model.blocks == 0:
        bad.append("a launch of 0 blocks where the C entry does not return "
                   "early")
    if model.block > card.threads_block or model.block <= 0:
        bad.append(f"{model.block} threads a block (limit "
                   f"{card.threads_block})")
    if x > card.grid_x or y > card.grid_yz or z > card.grid_yz:
        bad.append(f"grid {model.grid} past ({card.grid_x}, {card.grid_yz}, "
                   f"{card.grid_yz})")
    if model.static_smem > STATIC_SMEM_LIMIT:
        bad.append(f"static shared memory {model.static_smem} B above "
                   f"{STATIC_SMEM_LIMIT} B")
    if model.smem > card.smem_block_optin:
        bad.append(f"shared memory {model.smem} B (dynamic "
                   f"{model.dynamic_smem} + static {model.static_smem}) "
                   f"above the block's opt-in {card.smem_block_optin} B")
    if model.min_blocks:
        need = model.min_blocks * (model.smem + card.smem_reserved_block)
        if model.smem and need > card.smem_sm:
            bad.append(f"__launch_bounds__ asks {model.min_blocks} blocks an "
                       f"SM: {need} B of shared memory, the SM has "
                       f"{card.smem_sm} B")
        if model.min_blocks * model.block > card.threads_sm:
            bad.append(f"__launch_bounds__ asks {model.min_blocks} blocks of "
                       f"{model.block} threads an SM, the SM runs "
                       f"{card.threads_sm}")
    if card.resident(model.block, model.smem) < 1:
        bad.append("no block fits an SM")
    return bad


def check_in_bounds(model: I.KernelLaunch) -> list[str]:
    """K030: every gather index of the launch in ``[0, bound)``."""
    if model.indices is None:
        return []
    bad = []
    for s in model.indices():
        v = np.asarray(s.values)
        bound = np.asarray(s.bound)
        out = (v < 0) | (v >= bound)
        if out.any():
            i = int(np.flatnonzero(out.reshape(-1))[0])
            b = int(np.broadcast_to(bound, v.shape).reshape(-1)[i])
            bad.append(f"{s.name}: {int(out.sum())} index(es) out of "
                       f"bounds, first {int(v.reshape(-1)[i])} at {i} "
                       f"(bound {b})")
    return bad


def check_single_writer(model: I.KernelLaunch) -> list[str]:
    """K040: every output group stored exactly once."""
    if model.writers is None:
        return []
    stores = np.asarray(model.writers())
    bad = []
    multi = np.argwhere(stores > 1)
    if multi.size:
        bad.append(f"{len(multi)} output group(s) stored more than once, "
                   f"first at {tuple(multi[0].tolist())}")
    never = np.argwhere(stores < 1)
    if never.size:
        bad.append(f"{len(never)} output group(s) never stored, first at "
                   f"{tuple(never[0].tolist())}")
    return bad


def promotes_ok(in_dtypes, acc_dtype: str) -> bool:
    """K050: the accumulator holds the promotion of the inputs."""
    acc = getattr(torch, acc_dtype)
    promoted = acc
    for d in in_dtypes:
        promoted = torch.promote_types(promoted, getattr(torch, d))
    return promoted == acc


# -------------------------------------------------------------- the audit ---


@dataclasses.dataclass(frozen=True)
class AuditRow:
    """One line of the report table (per method x variant x pattern)."""

    method: str
    impl: str
    variant: str
    launches: int
    blocks: int
    smem_bytes: int             # the largest of the launches
    smem_frac: float            # of the block's opt-in limit
    ok: bool
    notes: str = ""


def audit_models(where: str, models, card: I.Card) -> tuple[list, bool]:
    """K020/K030/K040/K050 over ``models``; ``(diagnostics, ok)``."""
    diags = []
    for model in models:
        at = f"{where}:{model.label}"
        for code, probs in (("K020", check_resources(model, card)),
                            ("K030", check_in_bounds(model)),
                            ("K040", check_single_writer(model))):
            diags.extend(Diagnostic(code, at, p) for p in probs)
        if model.in_dtypes and not promotes_ok(model.in_dtypes,
                                               model.acc_dtype):
            diags.append(Diagnostic(
                "K050", at, f"acc_dtype {model.acc_dtype} is narrower than "
                f"the promotion of {model.in_dtypes}"))
    return diags, not diags


def _row(method, variant, models, diags, card, note="") -> AuditRow:
    kernels = [m for m in models if m.symbol is not None]
    smem = max((m.smem for m in kernels), default=0)
    return AuditRow(method, "cuda", variant, len(kernels),
                    sum(m.blocks for m in kernels), smem,
                    round(smem / card.smem_block_optin, 4), not diags,
                    note)


def audit_method(name: str, *, n: int = 256, batch: int = 2,
                 device="cpu", card: I.Card | None = None):
    """Audit one registered method over every pattern and variant;
    returns ``(rows, diagnostics)``."""
    from repro_torch.core import PlanPolicy, build_plan
    from repro_torch.kernels import registry

    card = card or I.card_of(device)
    spec = registry.get_method(name)
    models_fn = _AUDITS.get(name, spec.traffic)
    rows, diags = [], []
    if models_fn is None:
        diags.append(Diagnostic(
            "K001", name,
            "registered method has no launch model -- set the "
            "MethodSpec.traffic hook or override via "
            "repro_torch.analysis.kernel_audit.register_audit (the audit "
            "never skips silently)"))
        return rows, diags
    for pattern in PATTERNS:
        plan = build_plan(representative(pattern, device),
                          PlanPolicy(method=name))
        for var in _variants():
            where = f"{name}/cuda/{var.name}/{pattern}"
            if not promotes_ok((var.vals_dtype, var.b_dtype),
                               var.acc_dtype):
                diags.append(Diagnostic(
                    "K050", where, f"acc_dtype {var.acc_dtype} is narrower "
                    f"than the promotion of ({var.vals_dtype}, "
                    f"{var.b_dtype})"))
            models = models_fn(plan, n, batch, var, card)
            d, _ = audit_models(where, models, card)
            diags.extend(d)
            rows.append(_row(name, f"{var.name}/{pattern}", models, d, card,
                             "; ".join(m.body for m in models
                                       if m.symbol is not None)))
    return rows, diags


def audit_all(*, n: int = 256, batch: int = 2, device="cpu",
              card: I.Card | None = None):
    """Audit every registered method and every kernel of
    ``access.EXTRA_KERNELS``; returns ``(rows, diagnostics)``.

    Coverage is loud both ways: a registered method with neither a
    ``MethodSpec.traffic`` hook nor an ``_AUDITS`` override is K001; a
    stale ``_AUDITS`` override naming an unregistered method is K002.
    """
    from repro_torch.core import PlanPolicy, build_plan
    from repro_torch.kernels import registry

    from . import access

    card = card or I.card_of(device)
    rows, diags = [], []
    for name in registry.method_names():
        r, d = audit_method(name, n=n, batch=batch, device=device, card=card)
        rows.extend(r)
        diags.extend(d)
    for name in _AUDITS:
        if name not in registry.method_names():
            diags.append(Diagnostic(
                "K002", name,
                "kernel-audit entry for a method that is not registered "
                "(stale model?)"))
    plan = build_plan(representative("irregular", device),
                      PlanPolicy(method="merge"))
    for kname, builder in access.EXTRA_KERNELS.items():
        for var in _variants():
            models = builder(plan, n, batch, var, card)
            d, _ = audit_models(f"extra/{kname}/{var.name}", models, card)
            diags.extend(d)
            rows.append(_row(kname, var.name, models, d, card, "; ".join(
                m.body for m in models)))
    return rows, diags


def format_report(rows, diags) -> str:
    """The per-method report table (``audit --out``)."""
    header = (f"{'method':<16} {'impl':<5} {'variant':<26} "
              f"{'launches':>8} {'blocks':>7} {'smem_kib':>9} "
              f"{'smem%':>6} {'ok':>4}")
    lines = ["kernel audit report", header, "-" * len(header)]
    for r in rows:
        lines.append(
            f"{r.method:<16} {r.impl:<5} {r.variant:<26} "
            f"{r.launches:>8} {r.blocks:>7} "
            f"{r.smem_bytes / 1024:>9.1f} {r.smem_frac * 100:>5.1f}% "
            f"{'ok' if r.ok else 'FAIL':>4}"
            + (f"  {r.notes}" if r.notes else ""))
    if diags:
        lines.append("")
        lines.append(f"{len(diags)} finding(s):")
        lines.extend(f"  {d}" for d in diags)
    else:
        lines.append("no findings")
    return "\n".join(lines)
