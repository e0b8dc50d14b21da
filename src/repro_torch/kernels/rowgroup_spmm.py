"""Row-grouped SpMM: one ELL block per row-length bucket.

The row-grouped-CSR line of work (Oberhuber et al., arXiv:1012.2270;
Heller & Oberhuber, arXiv:1203.5737) attacks row-split's waste -- every
row padded to the *global* longest -- by grouping rows of similar length
and padding each group only to its own longest.  Rows are bucketed by the
power-of-two octave of their length, each bucket becomes one ELL block
(:func:`rowsplit_spmm.ell_slots`) padded to that bucket's tile-rounded
longest row, the row-split kernel runs once per bucket, and a final row
gather undoes the grouping permutation.  No kernel of its own: each bucket
is one ``ops.rowsplit_execute``, so on the card one ``rowsplit_spmm_cuda``
launch whose row parts (:func:`rowsplit_spmm.row_parts`) follow the
bucket's shape -- a bucket of few long rows splits each row among up to 8
warps.

The port of ``repro.kernels.rowgroup_spmm``: it registers itself as the
third SpMM method at import (``repro_torch.kernels`` imports it), with no
edit to any dispatch site.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from . import ops as _ops
from . import registry as _registry
from .merge_spmm import DEFAULT_T
from .rowsplit_spmm import DEFAULT_TL, TM, ell_slots

# Bucketing memo keyed on the live row_ptr tensor: one plan request reaches
# group_rows from resolve_params, the structure build and the inline path,
# so the host copy and the O(m log m) argsort run once per live pattern per
# tl.
_bucket_memo: dict = {}


def group_rows(row_ptr: torch.Tensor, tl: int):
    """Bucket rows by the octave of their length (host-side, memoised).

    Returns ``(order, groups)``: ``order`` (m,) int64 numpy -- row ids
    sorted by bucket, original order kept within a bucket -- and
    ``groups``, a tuple of ``(m_g, l_g)`` pairs (the group's row count and
    its tile-rounded pad) covering ``order`` contiguously, shortest rows
    first.  Rows of length 0 and 1 share bucket 0.  Copies ``row_ptr`` to
    the host: plan-time work.
    """
    key = (id(row_ptr), int(tl))
    memo = _bucket_memo.get(key)
    if memo is not None and memo[0]() is row_ptr:
        return memo[1], memo[2]
    lengths = np.diff(row_ptr.detach().to("cpu", torch.int64).numpy())
    m = lengths.shape[0]
    if m == 0:
        order, groups = np.zeros(0, np.int64), ()
    else:
        bucket = np.zeros(m, np.int64)
        nz = lengths > 1
        bucket[nz] = np.ceil(np.log2(lengths[nz])).astype(np.int64)
        order = np.argsort(bucket, kind="stable")
        out = []
        start = 0
        for b in np.unique(bucket):
            rows = order[start:start + int((bucket == b).sum())]
            m_g = rows.shape[0]
            max_len = int(lengths[rows].max())
            l_g = max(tl, tl * (-(-max(max_len, 1) // tl)))
            out.append((int(m_g), int(l_g)))
            start += m_g
        groups = tuple(out)
    ref = weakref.ref(row_ptr, lambda _, k=key: _bucket_memo.pop(k, None))
    _bucket_memo[key] = (ref, order, groups)
    return order, groups


def plan_rowgroup_structure(a, *, tl: int = DEFAULT_TL, tm: int = TM,
                            precomputed=None) -> dict:
    """Pattern-only structure: one ELL block per length bucket.

    Returns ``groups`` (a tuple of ``{cols, slot_nz}`` dicts, each
    ``(m_g_pad, l_g)`` like the row-split structure, on ``a``'s device) and
    ``inv_pos`` (m,) int32 -- the gather that maps the concatenated group
    outputs back to the original row order.  Values are re-applied per
    call through ``slot_nz``.  ``precomputed``: an ``(order, groups)`` pair
    from :func:`group_rows` the caller already has for this pattern and tl.
    """
    order, groups = precomputed if precomputed is not None \
        else group_rows(a.row_ptr, tl)
    out_groups = []
    start = 0
    for m_g, l_g in groups:
        rows = torch.from_numpy(order[start:start + m_g]).to(a.device)
        start += m_g
        out_groups.append(ell_slots(a, rows, l_g, tm=tm))
    inv = np.zeros(a.m, np.int64)
    inv[order] = np.arange(a.m)
    return dict(groups=tuple(out_groups),
                inv_pos=torch.from_numpy(inv).to(a.device, torch.int32))


def rowgroup_execute_parts(groups_meta: tuple, fwd: dict,
                           vals: torch.Tensor, b: torch.Tensor, *,
                           impl: str, epilogue=None, bias=None,
                           residual=None, acc_dtype=None, out_dtype=None):
    """Run the row-split kernel once per group, then un-permute the rows.

    ``groups_meta`` is the ``((m_g, l_g), ...)`` tuple (``PlanMeta.extra``);
    ``b (..., k, n) -> (..., m, n)``, the leading batch dims folded into
    each group's launch.  The epilogue's bias, activation and scale fuse
    into the group launches (the bias rides permuted into group row order,
    ``bias_perm[inv_pos] = bias``, and is sliced per group); a flagged
    ``residual`` is indexed in the original row order, so it is added after
    the un-permuting gather -- right because it is the last epilogue term
    -- and the groups then write ``acc_dtype``, the single ``out_dtype``
    cast coming after the add.
    """
    ep = epilogue
    adt = torch.float32 if acc_dtype is None else acc_dtype
    odt = torch.promote_types(vals.dtype, b.dtype) if out_dtype is None \
        else out_dtype
    group_ep, group_out, bias_perm = None, out_dtype, None
    if ep is not None:
        group_ep = dataclasses.replace(ep, residual=False)
        if group_ep.is_identity():
            group_ep = None
        if ep.residual:
            group_out = adt
        if ep.bias:
            bias_perm = torch.empty_like(bias)
            bias_perm[fwd["inv_pos"].long()] = bias
    outs = []
    start = 0
    for (m_g, _), gs in zip(groups_meta, fwd["groups"]):
        gb = None if bias_perm is None else bias_perm[start:start + m_g]
        start += m_g
        outs.append(_ops.rowsplit_execute(
            gs, vals, b, m=m_g, impl=impl, epilogue=group_ep, bias=gb,
            acc_dtype=acc_dtype, out_dtype=group_out))
    if not outs:
        return torch.zeros(b.shape[:-2] + (0, b.shape[-1]), dtype=odt,
                           device=b.device)
    out = torch.cat(outs, dim=-2) if len(outs) > 1 else outs[0]
    out = out.index_select(-2, fwd["inv_pos"])
    if ep is not None and ep.residual:
        out = (out + residual.to(out.dtype)).to(odt)
    return out


def launch_models(plan, n: int, batch: int, var, card) -> list:
    """The row-grouped method's launches (``MethodSpec.traffic``), as
    :func:`rowgroup_execute_parts` issues them: one row-split launch a
    length bucket (``rowsplit_spmm.ell_launch``, its row parts by the
    bucket's shape), then the PyTorch operations around them (symbol
    None): the concatenation of two or more buckets' outputs, the
    un-grouping gather (``index_select`` by ``inv_pos``) and, with a
    flagged residual, its add and the one cast to the output dtype.  A
    flagged residual never fuses into the buckets, which then write the
    accumulator's dtype."""
    from . import introspect as I
    from .rowsplit_spmm import ell_launch
    meta, ep = plan.meta, var.epilogue
    residual = bool(ep and ep.residual)
    odt = I.dtype_name(var.out_dtype or torch.promote_types(
        getattr(torch, var.vals_dtype), getattr(torch, var.b_dtype)))
    gdt = "float32" if residual else odt
    if meta.m == 0 or meta.k == 0 or n == 0 or batch == 0:
        return []
    models = []
    for i, ((m_g, _), gs) in enumerate(zip(meta.extra, plan.fwd["groups"])):
        model = ell_launch(
            f"rowgroup[g{i}]", gs, m=m_g, k=meta.k, nnz_pad=meta.nnz_pad,
            n=n, batch=batch, vals_dtype=var.vals_dtype,
            b_dtype=var.b_dtype, out_dtype=gdt, bias=bool(ep and ep.bias),
            residual=False, card=card)
        if model is not None:
            models.append(model)
    c = batch * meta.m * n
    gb = I.nbytes(gdt) * c

    def op(label, *operands):
        return I.KernelLaunch(label=label, symbol=None, source=None,
                              grid=(0, 0, 0), block=0, dynamic_smem=0,
                              static_smem=0, min_blocks=0, body="torch",
                              operands=operands)

    shape = (batch, meta.m, n)
    if len(meta.extra) > 1:
        models.append(op("rowgroup concat (torch.cat)",
                         I.OperandAccess("groups", gdt, shape, "in",
                                         read_bytes=gb),
                         I.OperandAccess("out", gdt, shape, "out",
                                         write_bytes=gb)))
    models.append(op("rowgroup un-group (index_select)",
                     I.OperandAccess("inv_pos", "int32", (meta.m,), "in",
                                     read_bytes=4 * meta.m),
                     I.OperandAccess("grouped", gdt, shape, "in",
                                     read_bytes=gb),
                     I.OperandAccess("out", gdt, shape, "out",
                                     write_bytes=gb)))
    if residual:
        rb = I.nbytes(var.b_dtype) * c
        models.append(op("rowgroup residual (add, cast)",
                         I.OperandAccess("c", gdt, shape, "in",
                                         read_bytes=2 * gb),
                         I.OperandAccess("residual", var.b_dtype, shape,
                                         "in", read_bytes=rb),
                         I.OperandAccess("out", odt, shape, "out",
                                         write_bytes=gb + I.nbytes(odt) * c)))
    return models


# --------------------------------------------------- MethodSpec adapters ---


def _resolve(a, *, t, tl, l_pad):
    if l_pad is not None:
        raise ValueError(
            "method='rowgroup' derives a pad per row group from the "
            "pattern; a global l_pad override is not supported (use "
            "method='rowsplit' for a single explicit pad).")
    t = DEFAULT_T if t is None else t
    tl = DEFAULT_TL if tl is None else tl
    _, groups = group_rows(a.row_ptr, tl)
    return t, tl, None, groups


def _build_structure(a, meta):
    return plan_rowgroup_structure(a, tl=meta.tl)


def _execute(meta, fwd, vals, b, *, impl, epilogue=None, bias=None,
             residual=None, acc_dtype=None, out_dtype=None):
    return rowgroup_execute_parts(meta.extra, fwd, vals, b, impl=impl,
                                  epilogue=epilogue, bias=bias,
                                  residual=residual, acc_dtype=acc_dtype,
                                  out_dtype=out_dtype)


def _inline(a, b, *, t, tl, l_pad, extra, impl):
    # `extra` holds the group sizes only (PlanMeta keeps it small and
    # hashable), not the row order the structure needs; group_rows is
    # memoised per live pattern, so this is a lookup once resolved.
    order, groups = group_rows(a.row_ptr, tl)
    fwd = plan_rowgroup_structure(a, tl=tl, precomputed=(order, groups))
    return rowgroup_execute_parts(groups, fwd, a.vals, b, impl=impl)


_registry.register_method(_registry.MethodSpec(
    name="rowgroup",
    description="row-grouped ELL (arXiv:1012.2270): rows bucketed by "
                "length octave, each group padded to its own max",
    build_structure=_build_structure,
    execute=_execute,
    inline=_inline,
    resolve_params=_resolve,
    tune_candidates=lambda a, wide: [dict()],
    heuristic_rank=None,          # opt-in: explicit method= or TuneDB hits
    traffic=launch_models,
))
