"""Plan-once / execute-many SpMM plans.

For the motivating workload — a pruned weight whose sparsity pattern is
frozen for the lifetime of the model — planning is paid once per pattern,
not once per call.  ``SpmmPlan`` captures everything derived from the
pattern:

* the forward execute structure, built by the resolved method's
  registered ``build_structure`` hook (merge chunk layout or row-split ELL
  layout with its static ``l_pad``),
* the kernel choice (``PlanPolicy.resolve``, the §5.4 heuristic evaluated
  at plan-build time),
* per-nonzero (row, col) coordinates for the values cotangent, and
* a transpose plan: merge-based balancing on the CSC view of A, for the
  backward ``dB = Aᵀ @ dC``.

Plans hold int32 tensors on the pattern's device plus static
``PlanMeta``; every array equals the reference's (``repro.core.plan``).
Values are not part of a plan: they are re-applied per call through
``slot_nz``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import weakref

import numpy as np
import torch

from .csr import CSR


@dataclasses.dataclass(frozen=True)
class PlanMeta:
    """Static (hashable) metadata of an SpmmPlan."""

    method: str                  # a registered method name (e.g. "merge")
    shape: tuple[int, int]       # (m, k) of A
    nnz_pad: int                 # nonzero capacity
    t: int                       # merge: nonzeroes per chunk
    tl: int                      # rowsplit: nonzeroes per row batch
    l_pad: int | None            # rowsplit: static max row length
    has_transpose: bool          # backward (CSC-view) plan present
    extra: tuple = ()            # method-specific statics (hashable)

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]


@dataclasses.dataclass(frozen=True, eq=False)
class SpmmPlan:
    """Pattern-derived execute state for C = A @ B."""

    fwd: dict                    # forward structure + nz coordinate arrays
    bwd: dict | None             # transpose merge structure (CSC view)
    meta: PlanMeta

    @property
    def device(self) -> torch.device:
        return self.fwd["nz_rows"].device


def transpose_pattern(a: CSR):
    """CSC view of A as a CSR matrix of Aᵀ, plus the nonzero permutation.

    Returns ``(a_t, perm)``: ``a_t`` is a (k, m) CSR of the same pattern
    transposed (vals are zeros — structure only) and ``perm`` an
    (nnz_pad,) int32 map from transpose nonzero position to original
    position (sentinel ``nnz_pad`` past the valid range).  Runs on the
    pattern's device (a stable sort of the column ids).
    """
    m, k = a.shape
    dev = a.device
    nnz, nnz_pad = a.nnz(), a.nnz_pad
    rows = torch.repeat_interleave(
        torch.arange(m, dtype=torch.int32, device=dev),
        a.row_lengths().long(), output_size=nnz)
    cols = a.col_ind[:nnz].long()
    perm_valid = torch.sort(cols, stable=True).indices      # CSC order
    t_row_ptr = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(cols, minlength=k), 0, out=t_row_ptr[1:])
    t_col_ind = torch.zeros(nnz_pad, dtype=torch.int32, device=dev)
    t_col_ind[:nnz] = rows[perm_valid]
    perm = torch.full((nnz_pad,), nnz_pad, dtype=torch.int32, device=dev)
    perm[:nnz] = perm_valid.to(torch.int32)
    a_t = CSR(t_row_ptr.to(torch.int32), t_col_ind,
              torch.zeros(nnz_pad, dtype=a.vals.dtype, device=dev), (k, m))
    return a_t, perm


def _compose_slots(slot_nz: torch.Tensor, perm: torch.Tensor,
                   nnz_pad: int) -> torch.Tensor:
    """Remap slot indices through a nonzero permutation (sentinel-safe)."""
    perm_ext = torch.cat([perm, perm.new_full((1,), nnz_pad)])
    return perm_ext[slot_nz.long()]


def build_plan(a: CSR, policy=None, *, _resolved=None) -> SpmmPlan:
    """Build an SpmmPlan from a CSR (once per sparsity pattern).

    ``policy`` (a ``PlanPolicy``, default ``PlanPolicy()``) resolves
    through ``PlanPolicy.resolve``; the structure comes from the resolved
    method's ``build_structure`` hook, on ``a``'s device.
    ``policy.with_transpose`` also builds the CSC-view merge plan for the
    ``dB`` backward pass.  ``_resolved``: a ResolvedPlan the caller (the
    engine cache) already computed for this request.
    """
    from repro_torch.kernels import merge_spmm, registry

    from .config import PlanPolicy

    policy = PlanPolicy() if policy is None else policy
    r = _resolved if _resolved is not None else policy.resolve(a)
    meta = PlanMeta(method=r.method, shape=a.shape, nnz_pad=a.nnz_pad,
                    t=r.t, tl=r.tl, l_pad=r.l_pad,
                    has_transpose=policy.with_transpose, extra=r.extra)
    fwd = dict(registry.get_method(r.method).build_structure(a, meta))

    # Per-nonzero coordinates for the values cotangent (in-bounds
    # everywhere; validity carried separately).
    nnz, nnz_pad, dev = a.nnz(), a.nnz_pad, a.device
    nz_rows = torch.zeros(nnz_pad, dtype=torch.int32, device=dev)
    nz_rows[:nnz] = torch.repeat_interleave(
        torch.arange(a.m, dtype=torch.int32, device=dev),
        a.row_lengths().long(), output_size=nnz)
    fwd["nz_rows"] = nz_rows
    fwd["nz_cols"] = a.col_ind
    fwd["nz_valid"] = torch.arange(nnz_pad, device=dev) < nnz

    bwd = None
    if policy.with_transpose:
        a_t, perm = transpose_pattern(a)
        # dB = Aᵀ @ dC always runs merge-based on the CSC view.
        bwd = dict(merge_spmm.plan_merge_structure(a_t, t=r.t))
        # Backward slots index the *original* vals.
        bwd["slot_nz"] = _compose_slots(bwd["slot_nz"], perm, nnz_pad)
    return SpmmPlan(fwd=fwd, bwd=bwd, meta=meta)


_fingerprint_memo: dict = {}


def pattern_fingerprint(a: CSR) -> str:
    """Content hash (sha1) of the sparsity pattern, not the values.

    The bytes hashed are the int32 ``row_ptr`` then ``col_ind``, as in the
    reference, so a pattern has the same fingerprint in both packages.
    Memoized per live CSR object, so the device→host copy is paid once
    per object.
    """
    key = id(a)
    memo = _fingerprint_memo.get(key)
    if memo is not None and memo[0]() is a:
        return memo[1]
    h = hashlib.sha1()
    for arr in (a.row_ptr, a.col_ind):
        h.update(np.ascontiguousarray(
            arr.detach().to("cpu", torch.int32).numpy()).tobytes())
    fp = h.hexdigest()
    ref = weakref.ref(a, lambda _, k=key: _fingerprint_memo.pop(k, None))
    _fingerprint_memo[key] = (ref, fp)
    return fp
