"""Host-side structural verification of the port's SpMM plans (the
reference's ``repro.analysis.planlint``, its codes P001-P074 with their
meanings).

The paper's correctness argument is *structural*: the merge decomposition
is right because every nonzero is consumed exactly once and every output
tile is flushed exactly once -- properties of the plan arrays, not of any
particular execution.  This module checks them host-side, before a kernel
ever launches.  The port's plan arrays are element for element the
reference's (``kernels/merge_spmm.py``), so the checks are the same:

* CSR sanity -- ``row_ptr`` monotone/bounded, ``col_ind`` in range;
* slot coverage -- across *all* ``slot_nz`` arrays of a structure (merge
  chunks, rowsplit ELL rows, rowgroup per-bucket blocks) each live
  nonzero id appears exactly once and every other slot holds the
  ``nnz_pad`` sentinel (which reads the appended zero -- a slot aimed at
  the dead range ``[nnz, nnz_pad)`` would read stale padding instead);
* merge path -- the chunk->tile stream is non-decreasing, visits every
  output row tile, and its ``first``/``last`` flags mark exactly the tile
  boundaries (the single-writer precondition of the kernel flush);
* rowsplit -- the static ``l_pad`` bounds the true max row length and
  every ELL slot sits on its own row;
* rowgroup -- ``extra``'s group table covers all rows and ``inv_pos`` is a
  valid inverse permutation;
* every static (``PlanMeta``, ``extra``) is hashable.

Entry points: :func:`verify_plan` (:func:`verify` dispatches on the plan
type) returns a ``Diagnostic`` list (empty = clean); :func:`check_plan`
raises :class:`PlanVerificationError` on
findings.  All checks run on host numpy copies (``.cpu().numpy()``) of the
plan's tensors, so a plan on the card costs one device-to-host copy of its
arrays: never call it inside a CUDA graph capture.
:func:`verify_sharded_plan` checks a ``ShardedSpmmPlan`` (P070-P074):
bounds that tile the span, one plan and gather a shard, the uniform flag,
exactly-once value coverage, the cols B-row gathers, and, given the CSR,
that each shard holds exactly its bounds' range of it.

Wired as the opt-in debug hook behind ``REPRO_VERIFY_PLANS=1``
(``repro_torch.analysis._flags``) in ``core.plan.build_plan`` and
``engine.PlanCache.get``.

Method-specific checkers live in :data:`STRUCTURE_CHECKS`; a new
registered method can add its own entry, and until it does, its plans
still get the generic CSR/coverage/meta checks.
"""
from __future__ import annotations

import numpy as np
import torch

from .diagnostics import Diagnostic, format_diagnostics

# Row-tile height shared by the kernels (merge lrow / ELL row padding).
_TM = 8


class PlanVerificationError(AssertionError):
    """A built plan violates a structural invariant (see .diagnostics)."""

    def __init__(self, diagnostics):
        self.diagnostics = tuple(diagnostics)
        super().__init__(format_diagnostics(
            self.diagnostics,
            header=f"plan verification failed "
                   f"({len(self.diagnostics)} finding(s)):"))


def _np(x) -> np.ndarray:
    """A host numpy copy of a plan or CSR array (tensor on any device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _head(ids, limit: int = 5) -> str:
    ids = list(ids[:limit + 1])
    if len(ids) > limit:
        return f"{ids[:limit]}…"
    return str(ids)


# ------------------------------------------------------------- CSR checks ---


def verify_csr(a, out: list | None = None, where: str = "csr") -> list:
    """P001/P002: ``row_ptr`` monotone and bounded, ``col_ind`` in range."""
    diags = [] if out is None else out
    rp = _np(a.row_ptr)
    m, k = a.shape
    if rp.shape != (m + 1,):
        diags.append(Diagnostic(
            "P001", f"{where}.row_ptr",
            f"expected shape ({m + 1},) for m={m}, got {rp.shape}"))
        return diags
    if rp[0] != 0:
        diags.append(Diagnostic(
            "P001", f"{where}.row_ptr", f"row_ptr[0] must be 0, got {rp[0]}"))
    drops = np.nonzero(np.diff(rp) < 0)[0]
    if drops.size:
        diags.append(Diagnostic(
            "P001", f"{where}.row_ptr",
            f"not non-decreasing at rows {_head(drops)}"))
    if rp[-1] > a.nnz_pad:
        diags.append(Diagnostic(
            "P001", f"{where}.row_ptr",
            f"nnz {rp[-1]} exceeds nnz_pad {a.nnz_pad}"))
    ci = _np(a.col_ind)
    if ci.shape != (a.nnz_pad,):
        diags.append(Diagnostic(
            "P002", f"{where}.col_ind",
            f"expected shape ({a.nnz_pad},), got {ci.shape}"))
        return diags
    nnz = max(int(rp[-1]), 0) if not diags else 0
    bad = np.nonzero((ci[:nnz] < 0) | (ci[:nnz] >= k))[0]
    if bad.size:
        diags.append(Diagnostic(
            "P002", f"{where}.col_ind",
            f"{bad.size} live column(s) outside [0, {k}) at "
            f"positions {_head(bad)}"))
    return diags


# ----------------------------------------------------- generic plan checks ---


def _check_hashable(obj, where: str, diags: list) -> None:
    try:
        hash(obj)
    except TypeError as e:
        diags.append(Diagnostic(
            "P010", where,
            f"static metadata must be hashable (cache key), but "
            f"hashing raised: {e}"))


def _slot_arrays(fwd: dict) -> list[tuple[str, np.ndarray]]:
    """All ``slot_nz`` arrays of a structure, with their plan paths."""
    found = []
    if "slot_nz" in fwd:
        found.append(("fwd.slot_nz", _np(fwd["slot_nz"])))
    for g, grp in enumerate(fwd.get("groups", ())):
        if isinstance(grp, dict) and "slot_nz" in grp:
            found.append((f"fwd.groups[{g}].slot_nz", _np(grp["slot_nz"])))
    return found


def _check_coverage(slots, nnz: int, nnz_pad: int, where: str,
                    diags: list) -> None:
    """P020/P021/P022: each live nonzero in exactly one slot; everything
    else is the ``nnz_pad`` sentinel (never the dead range)."""
    ids = np.concatenate([s.reshape(-1) for _, s in slots]) if slots \
        else np.zeros(0, np.int64)
    oob = np.nonzero((ids < 0) | (ids > nnz_pad))[0]
    if oob.size:
        diags.append(Diagnostic(
            "P022", where,
            f"{oob.size} slot id(s) outside [0, nnz_pad={nnz_pad}]: "
            f"{_head(ids[oob])}"))
        ids = ids[(ids >= 0) & (ids <= nnz_pad)]
    dead = ids[(ids >= nnz) & (ids < nnz_pad)]
    if dead.size:
        diags.append(Diagnostic(
            "P022", where,
            f"{dead.size} slot(s) aim at the dead range [nnz={nnz}, "
            f"nnz_pad={nnz_pad}) -- they would read stale padding instead "
            f"of the appended zero: ids {_head(np.unique(dead))}"))
    if nnz == 0:
        return
    counts = np.bincount(ids[ids < nnz], minlength=nnz)
    dup = np.nonzero(counts > 1)[0]
    if dup.size:
        diags.append(Diagnostic(
            "P020", where,
            f"{dup.size} nonzero id(s) covered more than once (values "
            f"would be double-counted): ids {_head(dup)}"))
    missing = np.nonzero(counts == 0)[0]
    if missing.size:
        diags.append(Diagnostic(
            "P021", where,
            f"{missing.size} nonzero id(s) never covered (values would "
            f"be dropped): ids {_head(missing)}"))


def _check_nz_arrays(fwd: dict, meta, a, diags: list) -> int | None:
    """P012: the SDDMM coordinate arrays; returns the live nnz count."""
    m, k = meta.shape
    nnz_pad = meta.nnz_pad
    for key in ("nz_rows", "nz_cols", "nz_valid"):
        if key not in fwd:
            diags.append(Diagnostic(
                "P012", f"plan.fwd.{key}", "coordinate array missing"))
            return None
    valid = _np(fwd["nz_valid"]).astype(bool)
    if valid.shape != (nnz_pad,):
        diags.append(Diagnostic(
            "P012", "plan.fwd.nz_valid",
            f"expected shape ({nnz_pad},), got {valid.shape}"))
        return None
    if valid.size and np.any(valid[:-1] < valid[1:]):
        diags.append(Diagnostic(
            "P012", "plan.fwd.nz_valid",
            "validity mask is not a prefix (CSR order packs live "
            "nonzeroes first)"))
    nnz = int(valid.sum())
    rows = _np(fwd["nz_rows"])
    cols = _np(fwd["nz_cols"])
    if m and np.any((rows[:nnz] < 0) | (rows[:nnz] >= m)):
        diags.append(Diagnostic(
            "P012", "plan.fwd.nz_rows", f"live row ids outside [0, {m})"))
    if k and np.any((cols[:nnz] < 0) | (cols[:nnz] >= k)):
        diags.append(Diagnostic(
            "P012", "plan.fwd.nz_cols", f"live col ids outside [0, {k})"))
    if a is not None:
        rp = _np(a.row_ptr)
        if int(rp[-1]) != nnz:
            diags.append(Diagnostic(
                "P012", "plan.fwd.nz_valid",
                f"live count {nnz} disagrees with the CSR's nnz "
                f"{int(rp[-1])}"))
        else:
            want_rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
            if not np.array_equal(rows[:nnz], want_rows):
                diags.append(Diagnostic(
                    "P012", "plan.fwd.nz_rows",
                    "row ids disagree with the CSR row_ptr expansion"))
            if not np.array_equal(cols[:nnz], _np(a.col_ind)[:nnz]):
                diags.append(Diagnostic(
                    "P012", "plan.fwd.nz_cols",
                    "col ids disagree with the CSR col_ind"))
    return nnz


# ------------------------------------------------ method-specific checkers ---


def _check_merge_structure(s: dict, *, n_tiles: int, nnz: int,
                           rows_of_nz: np.ndarray, where: str,
                           diags: list, tm: int = _TM) -> None:
    """P030/P031/P032: the merge-path chunk stream."""
    need = ("cols", "lrow", "slot_nz", "tile", "first", "last")
    missing = [kk for kk in need if kk not in s]
    if missing:
        diags.append(Diagnostic(
            "P011", where, f"merge structure missing keys {missing}"))
        return
    tile = _np(s["tile"])
    first = _np(s["first"])
    last = _np(s["last"])
    c = tile.shape[0]
    for kk in ("cols", "lrow", "slot_nz"):
        if _np(s[kk]).ndim != 2 or _np(s[kk]).shape[0] != c:
            diags.append(Diagnostic(
                "P011", f"{where}.{kk}",
                f"expected (C={c}, t) chunk array, got {_np(s[kk]).shape}"))
            return
    if np.any((tile < 0) | (tile >= max(n_tiles, 1))):
        diags.append(Diagnostic(
            "P030", f"{where}.tile",
            f"chunk tiles outside [0, {n_tiles})"))
    drops = np.nonzero(np.diff(tile) < 0)[0]
    if drops.size:
        diags.append(Diagnostic(
            "P030", f"{where}.tile",
            f"tile stream decreases at chunks {_head(drops + 1)} -- a "
            "revisited output tile would overwrite its earlier flush"))
    seen = np.unique(tile)
    if n_tiles and seen.size != n_tiles:
        missing_t = np.setdiff1d(np.arange(n_tiles), seen)
        diags.append(Diagnostic(
            "P031", f"{where}.tile",
            f"{missing_t.size} output tile(s) never visited (their C "
            f"rows would hold garbage): tiles {_head(missing_t)}"))
    want_first = np.concatenate([[1], (tile[1:] != tile[:-1]).astype(int)])
    want_last = np.concatenate([(tile[1:] != tile[:-1]).astype(int), [1]])
    if not np.array_equal(first, want_first):
        diags.append(Diagnostic(
            "P031", f"{where}.first",
            "first flags disagree with the tile boundaries (accumulator "
            "would not reset per tile)"))
    if not np.array_equal(last, want_last):
        diags.append(Diagnostic(
            "P031", f"{where}.last",
            "last flags disagree with the tile boundaries (flush would "
            "fire on the wrong chunk)"))
    slot = _np(s["slot_nz"])
    lrow = _np(s["lrow"])
    if np.any((lrow < 0) | (lrow >= tm)):
        diags.append(Diagnostic(
            "P032", f"{where}.lrow", f"row offsets outside [0, {tm})"))
        return
    live = slot < nnz
    if live.any() and rows_of_nz.size:
        want = tile[:, None] * tm + lrow         # (C, t) absolute rows
        got = rows_of_nz[np.where(live, slot, 0)]
        bad = live & (want != got)
        if bad.any():
            cc, ss = np.nonzero(bad)
            diags.append(Diagnostic(
                "P032", f"{where}.lrow",
                f"{int(bad.sum())} slot(s) scatter to the wrong output "
                f"row (chunk,slot) {_head(list(zip(cc, ss)))}"))


def _check_merge(plan, meta, nnz, diags) -> None:
    m = meta.m
    rows = _np(plan.fwd["nz_rows"]) if "nz_rows" in plan.fwd else \
        np.zeros(0, np.int64)
    _check_merge_structure(
        plan.fwd, n_tiles=-(-m // _TM) if m else 0, nnz=nnz,
        rows_of_nz=rows, where="plan.fwd", diags=diags)


def _ell_row_check(slot: np.ndarray, group_rows: np.ndarray, nnz: int,
                   rows_of_nz: np.ndarray, where: str, diags: list) -> None:
    """P041/P042: each live ELL slot sits on its own row; pad rows dead."""
    r = group_rows.shape[0]
    live = slot < nnz
    pad_live = live[r:]
    if pad_live.any():
        diags.append(Diagnostic(
            "P042", where,
            f"{int(pad_live.sum())} live slot(s) on tile-padding rows "
            f">= {r} (their contributions would be dropped)"))
    if not rows_of_nz.size:
        return
    body = live[:r]
    if body.any():
        got = rows_of_nz[np.where(body, slot[:r], 0)]
        want = np.broadcast_to(group_rows[:, None], body.shape)
        bad = body & (got != want)
        if bad.any():
            rr, ss = np.nonzero(bad)
            diags.append(Diagnostic(
                "P041", where,
                f"{int(bad.sum())} slot(s) hold a nonzero of a different "
                f"row (row,slot) {_head(list(zip(rr, ss)))}"))


def _check_rowsplit(plan, meta, nnz, diags) -> None:
    m = meta.m
    slot = _np(plan.fwd.get("slot_nz", np.zeros((0, 0), np.int32)))
    rows = _np(plan.fwd["nz_rows"]) if "nz_rows" in plan.fwd else \
        np.zeros(0, np.int64)
    if slot.ndim != 2 or slot.shape[0] < m:
        diags.append(Diagnostic(
            "P011", "plan.fwd.slot_nz",
            f"expected (m_pad >= {m}, L) ELL array, got {slot.shape}"))
        return
    length = slot.shape[1]
    if meta.l_pad is not None and length < meta.l_pad:
        diags.append(Diagnostic(
            "P040", "plan.fwd.slot_nz",
            f"ELL width {length} is narrower than meta.l_pad="
            f"{meta.l_pad}"))
    if rows.size and nnz:
        max_len = int(np.bincount(rows[:nnz], minlength=max(m, 1)).max())
        bound = length if meta.l_pad is None else meta.l_pad
        if bound < max_len:
            diags.append(Diagnostic(
                "P040", "plan.meta.l_pad",
                f"l_pad={bound} is smaller than the pattern's longest "
                f"row ({max_len} nonzeroes) -- the ELL layout silently "
                "truncates rows"))
    _ell_row_check(slot, np.arange(m, dtype=np.int64), nnz, rows,
                   "plan.fwd.slot_nz", diags)


def _check_rowgroup(plan, meta, nnz, diags) -> None:
    m = meta.m
    groups_meta = meta.extra
    groups = plan.fwd.get("groups", ())
    inv = plan.fwd.get("inv_pos")
    if inv is None or len(groups_meta) != len(groups):
        diags.append(Diagnostic(
            "P050", "plan.meta.extra",
            f"group table has {len(groups_meta)} entries but the "
            f"structure holds {len(groups)} groups"
            + ("" if inv is not None else "; inv_pos missing")))
        return
    sizes = [int(g[0]) for g in groups_meta]
    if sum(sizes) != m:
        diags.append(Diagnostic(
            "P050", "plan.meta.extra",
            f"group sizes {sizes} sum to {sum(sizes)}, not m={m}"))
        return
    inv = _np(inv)
    if inv.shape != (m,) or not np.array_equal(np.sort(inv), np.arange(m)):
        diags.append(Diagnostic(
            "P051", "plan.fwd.inv_pos",
            "not a permutation of [0, m) -- the un-grouping gather would "
            "duplicate some rows and drop others"))
        return
    row_at = np.empty(m, np.int64)
    row_at[inv] = np.arange(m)
    rows = _np(plan.fwd["nz_rows"]) if "nz_rows" in plan.fwd else \
        np.zeros(0, np.int64)
    lengths = np.bincount(rows[:nnz], minlength=max(m, 1)) if rows.size \
        else np.zeros(max(m, 1), np.int64)
    start = 0
    for g, ((m_g, l_g), gs) in enumerate(zip(groups_meta, groups)):
        grp_rows = row_at[start:start + m_g]
        start += m_g
        slot = _np(gs["slot_nz"])
        if m_g and lengths.size:
            max_len = int(lengths[grp_rows].max())
            if l_g < max_len:
                diags.append(Diagnostic(
                    "P040", f"plan.meta.extra[{g}]",
                    f"group pad l_g={l_g} is smaller than the group's "
                    f"longest row ({max_len} nonzeroes)"))
        _ell_row_check(slot, grp_rows, nnz, rows,
                       f"plan.fwd.groups[{g}].slot_nz", diags)


#: method name -> checker(plan, meta, nnz, diags).  New registered methods
#: may add an entry; without one they still get the generic CSR, slot-
#: coverage, coordinate-array and hashability checks.
STRUCTURE_CHECKS = {
    "merge": _check_merge,
    "rowsplit": _check_rowsplit,
    "rowgroup": _check_rowgroup,
}


# ------------------------------------------------------------ entry points ---


def verify_plan(plan, a=None) -> list:
    """Verify one ``SpmmPlan``; returns a (possibly empty) diagnostic list.

    ``a`` (optional): the concrete CSR the plan was built from -- adds the
    CSR-vs-plan cross checks on top of the plan-internal invariants.
    """
    diags: list = []
    meta = plan.meta
    _check_hashable(meta, "plan.meta", diags)
    _check_hashable(meta.extra, "plan.meta.extra", diags)
    from repro_torch.kernels import registry
    if meta.method not in registry.method_names():
        diags.append(Diagnostic(
            "P011", "plan.meta.method",
            f"{meta.method!r} is not a registered method "
            f"(registered: {', '.join(registry.method_names())})"))
    if a is not None:
        verify_csr(a, diags)
        if a.shape != meta.shape or a.nnz_pad != meta.nnz_pad:
            diags.append(Diagnostic(
                "P003", "plan.meta",
                f"plan is for shape {meta.shape} / nnz_pad "
                f"{meta.nnz_pad}, CSR is {a.shape} / {a.nnz_pad}"))
            return diags
    nnz = _check_nz_arrays(plan.fwd, meta, a, diags)
    if nnz is None:
        return diags
    _check_coverage(_slot_arrays(plan.fwd), nnz, meta.nnz_pad,
                    "plan.fwd", diags)
    checker = STRUCTURE_CHECKS.get(meta.method)
    if checker is not None:
        checker(plan, meta, nnz, diags)
    elif not _slot_arrays(plan.fwd):
        diags.append(Diagnostic(
            "P011", "plan.fwd",
            f"method {meta.method!r} has no STRUCTURE_CHECKS entry and "
            "no slot_nz arrays -- nothing verifiable about its structure"))
    if (plan.bwd is None) != (not meta.has_transpose):
        diags.append(Diagnostic(
            "P060", "plan.bwd",
            f"meta.has_transpose={meta.has_transpose} but bwd is "
            f"{'missing' if plan.bwd is None else 'present'}"))
    if plan.bwd is not None:
        # The backward is a merge structure on the CSC view: its rows are
        # the original columns, its slots index the original values.
        _check_coverage([("bwd.slot_nz", _np(plan.bwd["slot_nz"]))],
                        nnz, meta.nnz_pad, "plan.bwd", diags)
        cols = _np(plan.fwd["nz_cols"])
        _check_merge_structure(
            plan.bwd, n_tiles=-(-meta.k // _TM) if meta.k else 0,
            nnz=nnz, rows_of_nz=cols, where="plan.bwd", diags=diags)
    return diags


def _shard_pattern(shard) -> tuple[np.ndarray, np.ndarray]:
    """A shard plan's live (row, col) coordinates, in its slot order."""
    fwd = shard.fwd
    valid = _np(fwd.get("nz_valid", np.zeros(0, bool))).astype(bool)
    return _np(fwd["nz_rows"])[valid], _np(fwd["nz_cols"])[valid]


def _check_shard_ranges(plan, a, bounds, diags: list) -> None:
    """P070/P072 against the CSR itself: shard ``i`` must hold exactly the
    nonzeroes of its bounds' range.  Rows: its local ``row_ptr`` (from the
    shard plan's coordinates) is ``a.row_ptr[b_i:b_{i+1}+1] - a.row_ptr[
    b_i]`` with empty rows past it, its columns are the range's, and its
    live ``vals_slots`` are ``range(rp[b_i], rp[b_{i+1}])``; cols: the
    same over the CSC view (the range's nonzeroes in row-major order, at
    their rows and shard-local columns).  Bounds that still tile ``[0,
    span]`` but cut elsewhere than the shards do fail here."""
    meta = plan.meta
    rp = _np(a.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    ci = _np(a.col_ind)[:nnz].astype(np.int64)
    rows_all = np.repeat(np.arange(meta.m, dtype=np.int64), np.diff(rp))
    for i, (shard, slot) in enumerate(zip(plan.shards, plan.vals_slots)):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        sl = _np(slot)
        live = sl[sl != meta.nnz_pad].astype(np.int64)
        if meta.dim == "rows":
            want = np.arange(rp[lo], rp[hi])
            want_rows = rows_all[rp[lo]:rp[hi]] - lo
        else:
            want = np.nonzero((ci >= lo) & (ci < hi))[0]
            want_rows = rows_all[want]
        if not np.array_equal(live, want):
            diags.append(Diagnostic(
                "P072", f"plan.vals_slots[{i}]",
                f"gathers {live.size} value(s) {_head(live)} but "
                f"{meta.dim} [{lo}, {hi}) hold the global nonzeroes "
                f"{_head(want)} ({want.size})"))
        rows, cols = _shard_pattern(shard)
        want_cols = ci[want] - (lo if meta.dim == "cols" else 0)
        if not (np.array_equal(rows, want_rows)
                and np.array_equal(cols, want_cols)):
            diags.append(Diagnostic(
                "P070", f"plan.meta.bounds[{i}:{i + 2}]",
                f"shard {i}'s pattern is not the nonzeroes of {meta.dim} "
                f"[{lo}, {hi}) of the CSR: the bounds cut elsewhere than "
                "the shards were built, so assembly would misplace rows"))


def verify_sharded_plan(plan, a=None) -> list:
    """Verify a ``ShardedSpmmPlan`` (P070-P074): shard layout, per-shard
    plans, the global value-gather coverage, the cols B-row gathers and,
    given the CSR ``a``, that each shard holds exactly its bounds' range
    of ``a`` (bounds that tile the span but disagree with the shards, the
    reference's one miss, come back as P070/P072)."""
    diags: list = []
    meta = plan.meta
    _check_hashable(meta, "plan.meta", diags)
    m, k = meta.shape
    n = meta.n_shards
    span = m if meta.dim == "rows" else k
    bounds = np.asarray(meta.bounds, np.int64)
    if (bounds.shape != (n + 1,) or bounds[0] != 0 or bounds[-1] != span
            or np.any(np.diff(bounds) < 0)):
        diags.append(Diagnostic(
            "P070", "plan.meta.bounds",
            f"bounds {tuple(bounds)} do not tile [0, {span}] into "
            f"{n} monotone {meta.dim} ranges"))
        return diags
    if len(plan.shards) != n or len(plan.vals_slots) != n:
        diags.append(Diagnostic(
            "P071", "plan.shards",
            f"{len(plan.shards)} shard plan(s) / "
            f"{len(plan.vals_slots)} value gather(s) for {n} bound(s)"))
        return diags
    if meta.uniform and any(lm != meta.local_metas[0]
                            for lm in meta.local_metas):
        diags.append(Diagnostic(
            "P073", "plan.meta.uniform",
            "uniform=True but local metas differ: the SPMD path would run "
            "the wrong statics on some shards"))
    covered: list = []
    for i, (shard, slot) in enumerate(zip(plan.shards, plan.vals_slots)):
        lm = meta.local_metas[i]
        if shard.meta != lm:
            diags.append(Diagnostic(
                "P071", f"plan.shards[{i}].meta",
                "shard plan meta disagrees with meta.local_metas"))
        size = int(bounds[i + 1] - bounds[i])
        lm_span = lm.shape[0] if meta.dim == "rows" else lm.shape[1]
        other = lm.shape[1] if meta.dim == "rows" else lm.shape[0]
        want_other = k if meta.dim == "rows" else m
        if lm_span < size or other != want_other:
            diags.append(Diagnostic(
                "P071", f"plan.shards[{i}].meta.shape",
                f"local shape {lm.shape} cannot hold {meta.dim} range "
                f"[{bounds[i]}, {bounds[i + 1]}) of global {meta.shape}"))
        sl = _np(slot)
        live = sl[sl != meta.nnz_pad]
        covered.append(live)
        for d in verify_plan(shard):
            diags.append(Diagnostic(
                d.code, f"shard[{i}].{d.where}", d.message))
        local_valid = _np(shard.fwd.get("nz_valid", np.zeros(0, bool)))
        if int(local_valid.sum()) != live.size:
            diags.append(Diagnostic(
                "P072", f"plan.vals_slots[{i}]",
                f"gathers {live.size} live value(s) but the shard plan "
                f"holds {int(local_valid.sum())} nonzero(es)"))
    ids = np.concatenate(covered) if covered else np.zeros(0, np.int64)
    nnz = int(_np(a.row_ptr)[-1]) if a is not None else ids.size
    _check_coverage(
        [("vals_slots", ids)], nnz, meta.nnz_pad, "plan.vals_slots", diags)
    if meta.dim == "cols":
        if plan.b_rows is None or len(plan.b_rows) != n:
            diags.append(Diagnostic(
                "P074", "plan.b_rows",
                "cols-dim plan without one B row gather per shard"))
        else:
            for i in range(n):
                br = _np(plan.b_rows[i])
                size = int(bounds[i + 1] - bounds[i])
                want = np.full(br.shape[0], k, np.int64)
                want[:size] = np.arange(bounds[i], bounds[i + 1])
                if not np.array_equal(br, want):
                    diags.append(Diagnostic(
                        "P074", f"plan.b_rows[{i}]",
                        f"B row gather does not select columns "
                        f"[{bounds[i]}, {bounds[i + 1]}) (sentinel {k})"))
    if a is not None:
        n_csr = len(diags)
        verify_csr(a, diags)
        if a.shape != meta.shape or a.nnz_pad != meta.nnz_pad:
            diags.append(Diagnostic(
                "P003", "plan.meta",
                f"sharded plan is for shape {meta.shape} / nnz_pad "
                f"{meta.nnz_pad}, CSR is {a.shape} / {a.nnz_pad}"))
        if len(diags) == n_csr:
            _check_shard_ranges(plan, a, bounds, diags)
    return diags


def verify(plan, a=None) -> list:
    """Dispatch on plan type (``SpmmPlan`` vs ``ShardedSpmmPlan``)."""
    if hasattr(plan, "shards"):
        return verify_sharded_plan(plan, a)
    return verify_plan(plan, a)


def check_plan(plan, a=None) -> None:
    """Raise :class:`PlanVerificationError` if ``plan`` has findings."""
    diags = verify(plan, a)
    if diags:
        raise PlanVerificationError(diags)
