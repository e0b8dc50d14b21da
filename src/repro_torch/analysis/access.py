"""Machine-checked coalescing: the paper's principle (ii) on the GPU's terms.

The paper's second design principle is row-major, coalesced access: the
lanes of a warp read neighbouring addresses, and a warp walks its
nonzeros forward.  The reference proves it over Pallas BlockSpec index
maps; here every registered launch model (``MethodSpec.traffic`` and
:data:`EXTRA_KERNELS`, ``repro_torch.kernels.introspect``) gives one
warp's lane addresses of each load and store instruction, and its nonzero
streams over a real plan:

* **T110** -- an instruction whose 32 lanes touch more 32-byte sectors
  than the fewest that could hold the same bytes (each run of lanes --
  a B row, or two in the bf16x8 body's two half-warps -- laid out
  contiguously), beyond :data:`SECTOR_ALLOW`: a strided or scattered
  access, for every body (f32x4, bf16x8, scalar).
* **T120** -- a nonzero stream that moves backward within a warp:
  merge's range (nonzero ids and rows), row-split's slots of a row, the
  SDDMM's nonzeros of a worker.
* **T130/T131** -- the rowgroup permutation invariants, as the
  reference states them: ``inv_pos`` a permutation of the rows, and the
  source rows of each length bucket in ascending original order.
* **T101/T102** -- coverage both ways: a ``__global__`` kernel of
  ``csrc/*.cu`` that no hook or :data:`EXTRA_KERNELS` entry models, or a
  registered method without a hook, is T101; an :data:`EXTRA_KERNELS`
  entry for a kernel module that does not exist, or a model of a kernel
  no source defines, is T102.

``EXTRA_KERNELS`` covers the launches outside the per-method registry:
the backward's SDDMM, the grouped GEMM (all three bodies) and flash
attention (all three bodies).
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch.kernels import introspect as I

from .diagnostics import Diagnostic

#: Sectors an instruction may touch per sector of the bytes it moves, by
#: (body, operand); 1 elsewhere.  The bf16x8 body gives a lane 8 columns,
#: and the epilogue reaches them in 4-value steps (``store_vec``'s 8-byte
#: bf16 or 16-byte f32 stores, ``apply_epilogue_vec``'s float4 residual
#: reads): each step of the half-warp covers every other 8 or 16 bytes,
#: so it touches twice the sectors of its bytes, and the two steps
#: together the row's.  Pinned at this tree, so that any other strided
#: access is a finding.
SECTOR_ALLOW = {("bf16x8", "out"): 2.0, ("bf16x8", "residual"): 2.0,
                ("bf16x8", "carry"): 2.0}
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")


def _sddmm_models(plan, n, batch, var, card):
    from repro_torch.kernels import sddmm as _sddmm
    m, k = plan.meta.shape
    fwd = plan.fwd
    # The backward's call: dc is the float32 cotangent, b the operand.
    return _sddmm.launch_models(fwd["nz_rows"], fwd["nz_cols"],
                                fwd["nz_valid"], m=m, k=k, n=n, batch=batch,
                                dc_dtype=var.acc_dtype,
                                b_dtype=var.b_dtype)


def _flash_models(plan, n, batch, var, card):
    from repro_torch.kernels import flash_attention as _fa
    # Every body at a small causal GQA shape: wgmma at dh 64 and 128,
    # mma.sync at dh 32 (bf16), the f32 body at dh 64.
    out = []
    for dt, dh in (("bfloat16", 64), ("bfloat16", 128), ("bfloat16", 32),
                   ("float32", 64)):
        out += _fa.launch_models(b=batch, s=320, h=4, kvh=2, dh=dh,
                                 dtype=dt)
    return out


def _moe_models(plan, n, batch, var, card):
    from repro_torch.kernels import moe_gemm as _moe
    # 4 experts and a block past the last group: the wgmma body (bf16, tt
    # 64), the WMMA body (bf16, tt 32) and the SIMT body (f32).
    out = []
    for dt, tt in (("bfloat16", 64), ("bfloat16", 32), ("float32", 64)):
        be = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32)
        out += _moe.launch_models(be, tokens=5 * tt, d_in=1024, d_out=320,
                                  n_experts=4, dtype=dt, tt=tt, card=card)
    return out


#: kernels with no MethodSpec of their own: name of the port's kernel
#: module -> builder(plan, n, batch, var, card) -> [KernelLaunch].
EXTRA_KERNELS = {
    "sddmm": _sddmm_models,
    "flash_attention": _flash_models,
    "moe_gemm": _moe_models,
}


def check_launch(model: I.KernelLaunch, *, where: str = "") -> \
        list[Diagnostic]:
    """T110 over every instruction of every operand, T120 over the
    launch's nonzero streams: one diagnostic a (operand, instruction) or
    stream."""
    diags = []
    label = f"{where}:{model.label}" if where else model.label
    for op in model.operands:
        allow = SECTOR_ALLOW.get((model.body, op.name), 1.0)
        for acc in op.warp:
            got, fewest = acc.sectors(), acc.min_sectors()
            if got > allow * fewest:
                diags.append(Diagnostic(
                    "T110", f"{label}:{op.name}",
                    f"{acc.label}: one warp touches {got} 32-byte sectors "
                    f"for bytes that {fewest} could hold (allowed "
                    f"{allow:g}x) -- lanes must read neighbouring "
                    "addresses"))
    for walk in (model.walks() if model.walks else ()):
        w, p = np.asarray(walk.warps), np.asarray(walk.positions)
        same = w[1:] == w[:-1]
        step = p[1:] - p[:-1]
        back = same & ((step <= 0) if walk.strict else (step < 0))
        if back.any():
            i = int(np.flatnonzero(back)[0])
            diags.append(Diagnostic(
                "T120", f"{label}:{walk.name}",
                f"warp {int(w[i])} steps from {int(p[i])} to "
                f"{int(p[i + 1])} -- its nonzero stream must move forward"))
    return diags


def check_rowgroup_plan(plan, *, where: str = "rowgroup") -> \
        list[Diagnostic]:
    """T130/T131: the un-grouping gather must be a permutation and the
    per-group gathers must read source rows in ascending order."""
    diags = []
    inv = I.host(plan.fwd["inv_pos"])
    m = inv.shape[0]
    if not np.array_equal(np.sort(inv), np.arange(m)):
        diags.append(Diagnostic(
            "T130", f"{where}:inv_pos",
            "inv_pos is not a permutation of the rows -- the un-grouping "
            "gather would drop or duplicate output rows"))
        return diags
    order = np.argsort(inv)
    start = 0
    for g, (m_g, _) in enumerate(plan.meta.extra):
        rows = order[start:start + m_g]
        start += m_g
        if rows.size > 1 and np.any(np.diff(rows) <= 0):
            diags.append(Diagnostic(
                "T131", f"{where}[g{g}]",
                "source rows within the length bucket are not in "
                "ascending original order -- the stable-sort guarantee "
                "behind streaming per-group gathers is broken"))
    return diags


_GLOBAL_RE = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")


def defined_kernels() -> dict[str, str]:
    """Every ``__global__`` kernel of ``csrc/*.cu``: name -> source."""
    out = {}
    for fname in sorted(os.listdir(CSRC)):
        if fname.endswith(".cu"):
            with open(os.path.join(CSRC, fname), encoding="utf-8") as f:
                for name in _GLOBAL_RE.findall(f.read()):
                    out[name] = fname
    return out


def kernel_name(symbol: str) -> str:
    """``rowsplit_kernel`` of ``repro::rowsplit_kernel<1, float, ...>``."""
    return symbol.split("<")[0].rsplit("::", 1)[-1]


def check_coverage(modeled: set[str] | None = None) -> list[Diagnostic]:
    """T101/T102.  ``modeled``: the kernel names the hooks' models name
    (default: every hook evaluated at the representative)."""
    from repro_torch.kernels import registry
    if modeled is None:
        modeled = {kernel_name(m.symbol) for _, m in _all_models()
                   if isinstance(m, I.KernelLaunch) and m.symbol is not None}
    diags = []
    for name in registry.method_names():
        if registry.get_method(name).traffic is None:
            diags.append(Diagnostic(
                "T101", name,
                "registered method has no MethodSpec.traffic launch model "
                "-- its access patterns are unverifiable (the checker "
                "never skips silently)"))
    defined = defined_kernels()
    for kname, src in sorted(defined.items()):
        if kname not in modeled:
            diags.append(Diagnostic(
                "T101", f"csrc/{src}:{kname}",
                "__global__ kernel that no MethodSpec.traffic hook or "
                "access.EXTRA_KERNELS entry models"))
    kdir = os.path.dirname(CSRC) + os.sep + "kernels"
    for mod in sorted(EXTRA_KERNELS):
        if not os.path.exists(os.path.join(kdir, f"{mod}.py")):
            diags.append(Diagnostic(
                "T102", f"repro_torch.kernels.{mod}",
                "EXTRA_KERNELS entry for a module that defines no kernel "
                "(stale entry?)"))
    for kname in sorted(modeled - set(defined)):
        diags.append(Diagnostic(
            "T102", kname,
            "launch model of a kernel that no csrc source defines (stale "
            "model?)"))
    return diags


def _all_models(*, n: int = 256, batch: int = 2, device="cpu", card=None):
    """``(where, model)`` of every registered method's hook and every
    :data:`EXTRA_KERNELS` builder, at the audit's patterns and
    variants."""
    from repro_torch.core import PlanPolicy, build_plan
    from repro_torch.kernels import registry

    from .kernel_audit import PATTERNS, _variants, representative

    card = card or I.card_of(device)
    for pattern in PATTERNS:
        a = representative(pattern, device)
        for name in registry.method_names():
            spec = registry.get_method(name)
            if spec.traffic is None:
                continue                 # T101 via check_coverage
            plan = build_plan(a, PlanPolicy(method=name))
            for var in _variants():
                for model in spec.traffic(plan, n, batch, var, card):
                    yield f"{name}/{var.name}/{pattern}", model
            if name == "rowgroup":
                yield f"rowgroup/{pattern}", plan
    plan = build_plan(representative("irregular", device),
                      PlanPolicy(method="merge"))
    for kname, builder in EXTRA_KERNELS.items():
        for var in _variants():
            for model in builder(plan, n, batch, var, card):
                yield f"extra/{kname}/{var.name}", model


def check_all(*, n: int = 256, batch: int = 2, device="cpu",
              card=None) -> list[Diagnostic]:
    """The coalescing and stream checks over every model, the rowgroup
    plans' invariants, and coverage."""
    diags, modeled = [], set()
    for where, item in _all_models(n=n, batch=batch, device=device,
                                   card=card):
        if isinstance(item, I.KernelLaunch):
            if item.symbol is not None:
                modeled.add(kernel_name(item.symbol))
            diags.extend(check_launch(item, where=where))
        else:
            diags.extend(check_rowgroup_plan(item, where=where))
    return check_coverage(modeled) + diags
