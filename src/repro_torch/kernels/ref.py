"""Plain PyTorch versions of the kernels: the same function, in tensor ops.

The CPU path runs these (a wrapper takes them only for tensors on the
CPU, or when ``ExecutionConfig(impl="torch")`` asks for them), the CPU
tests hold them against the JAX reference, and ``chip_smoke.py`` holds
each CUDA kernel against its plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.csr import CSR
from repro_torch.core.epilogue import apply_epilogue

from .flash_attention import NEG_INF
from .merge_spmm import apply_vals, split_rows
from .rowsplit_spmm import STAGED_WINDOW


def spmm_dense_ref(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """Densify-and-matmul oracle (small matrices only)."""
    return a.to_dense() @ b


def _map_leading(one, b, residual):
    """Apply a 2-D-operand function over folded leading batch dims, one
    batch element at a time (per-element working set, as the reference's
    ``lax.map``)."""
    lead = b.shape[:-2]
    b3 = b.reshape((-1,) + b.shape[-2:])
    res3 = None if residual is None else \
        residual.reshape((-1,) + residual.shape[-2:])
    out = torch.stack([one(b3[i], None if res3 is None else res3[i])
                       for i in range(b3.shape[0])])
    return out.reshape(lead + out.shape[1:])


def _finish(out, ep, bias_col, res2, out_dtype):
    return apply_epilogue(out, ep, bias_col, res2).to(out_dtype)


def merge_execute_ref(structure: dict, vals: torch.Tensor, b: torch.Tensor,
                      m: int, tm: int, *, epilogue=None, bias=None,
                      residual=None, acc_dtype=torch.float32,
                      out_dtype=None) -> torch.Tensor:
    """Plain version of the merge kernel on a prebuilt chunk structure.

    Gather the raw ``vals`` into chunk slots (``slot_nz``), gather B rows
    per slot, multiply, scatter-add into C by (tile, lrow) — all in
    ``acc_dtype`` — then apply the fused ``epilogue`` and cast once to
    ``out_dtype``.  ``b`` may carry leading batch dims: (..., k, n) →
    (..., m, n); a flagged ``residual`` batches with it.
    """
    odt = torch.promote_types(vals.dtype, b.dtype) if out_dtype is None \
        else out_dtype
    ep = epilogue
    chunk_vals = apply_vals(structure, vals).to(acc_dtype)
    cols = structure["cols"].long()
    rows = (structure["tile"].long()[:, None] * tm
            + structure["lrow"].long()).reshape(-1)
    m_pad = tm * (-(-m // tm))
    bias_col = bias.to(acc_dtype)[:, None] \
        if ep is not None and ep.bias else None

    def one(b2, res2):
        prods = chunk_vals[..., None] * b2.to(acc_dtype)[cols]
        out = torch.zeros((m_pad, b2.shape[-1]), dtype=acc_dtype,
                          device=b2.device)
        out.index_add_(0, rows, prods.reshape(-1, b2.shape[-1]))
        return _finish(out[:m], ep, bias_col, res2, odt)

    res = residual if ep is not None and ep.residual else None
    if b.dim() == 2:
        return one(b, res)
    return _map_leading(one, b, res)


def merge_schedule_ref(structure: dict, vals: torch.Tensor,
                       b: torch.Tensor, m: int, tm: int, g: int, *,
                       epilogue=None, bias=None, residual=None,
                       acc_dtype=torch.float32,
                       out_dtype=None) -> torch.Tensor:
    """The merge kernel's schedule replayed in tensor ops: the same C as
    :func:`merge_execute_ref`, reached the kernel's way.

    Worker w takes the ``g`` chunks [w g, (w + 1) g) and owns the rows
    between its split rows (``merge_spmm.split_rows``).  The rows strictly
    inside its range, empty ones included, are complete in it; its two end
    rows go to a carry buffer (zero where it holds none of the row).  The
    fix-up then sums each split row's partials in worker order, reading no
    worker that opens past the last live slot (those hold nothing and
    write nothing).  Raises if a live slot falls outside its worker's rows
    or a row of C is not written exactly once.  Arguments as in
    :func:`merge_execute_ref`.
    """
    odt = torch.promote_types(vals.dtype, b.dtype) if out_dtype is None \
        else out_dtype
    ep = epilogue
    n_chunks, t = structure["cols"].shape
    nnz_pad = vals.shape[0]
    split, past_end = split_rows(structure, m, g, nnz_pad)
    split, past_end = split.tolist(), past_end.tolist()
    workers = len(split) - 1
    live = (structure["slot_nz"] < nnz_pad).reshape(-1)
    rows = (structure["tile"].long()[:, None] * tm
            + structure["lrow"].long()).reshape(-1)
    cols = structure["cols"].long().reshape(-1)
    slot_vals = apply_vals(structure, vals).to(acc_dtype).reshape(-1)
    bias_col = bias.to(acc_dtype)[:, None] \
        if ep is not None and ep.bias else None

    def one(b2, res2):
        n = b2.shape[-1]
        prods = slot_vals[:, None] * b2.to(acc_dtype)[cols]
        c = torch.zeros((m, n), dtype=acc_dtype, device=b2.device)
        written = torch.zeros(m, dtype=torch.int64, device=b2.device)
        carry = torch.empty((workers, 2, n), dtype=acc_dtype,
                            device=b2.device)
        for w in range(workers):
            lo, hi = split[w], split[w + 1]
            span = slice(w * g * t, min((w + 1) * g, n_chunks) * t)
            r, p = rows[span][live[span]], prods[span][live[span]]
            if past_end[w]:
                if r.numel():
                    raise AssertionError(f"worker {w} opens past the last "
                                         "live slot but holds one")
                continue
            if r.numel() and (r.min() < lo or r.max() > hi):
                raise AssertionError(f"worker {w}: a live slot's row lies "
                                     f"outside [{lo}, {hi}]")
            sums = torch.zeros((hi - lo + 1, n), dtype=acc_dtype,
                               device=b2.device).index_add_(0, r - lo, p)
            carry[w, 0] = sums[0]
            carry[w, 1] = sums[-1] if hi > lo else 0
            c[lo + 1:hi] = sums[1:-1]
            written[lo + 1:hi] += 1
        for j in range(-1, workers):        # the fix-up, split row S_j
            row = split[j + 1]
            if j >= 0 and split[j] == row:
                continue                    # not the first of its run
            jb = j
            while jb + 1 < workers and split[jb + 2] == row:
                jb += 1
            acc = torch.zeros(n, dtype=acc_dtype, device=b2.device)
            for w in range(max(j, 0), min(jb + 1, workers - 1) + 1):
                if past_end[w]:             # it and all after hold nothing
                    break
                if w - 1 >= j:              # S_{w-1} = row: w starts there
                    acc = acc + carry[w, 0]
                if w <= jb:                 # S_w = row: w ends there
                    acc = acc + carry[w, 1]
            c[row] = acc
            written[row] += 1
        if not bool((written == 1).all()):
            raise AssertionError(f"rows written other than once: "
                                 f"{written.tolist()}")
        return _finish(c, ep, bias_col, res2, odt)

    res = residual if ep is not None and ep.residual else None
    if b.dim() == 2:
        return one(b, res)
    return _map_leading(one, b, res)


def rowsplit_execute_ref(structure: dict, vals: torch.Tensor,
                         b: torch.Tensor, m: int, *, epilogue=None,
                         bias=None, residual=None, acc_dtype=torch.float32,
                         out_dtype=None) -> torch.Tensor:
    """Plain version of the row-split kernel on a prebuilt ELL structure.

    Raw ``vals`` gathered through ``slot_nz`` like the kernel; batched like
    it too: ``b (..., k, n) → (..., m, n)``; fused ``epilogue`` and
    ``acc_dtype``/``out_dtype`` as in :func:`merge_execute_ref`.
    """
    odt = torch.promote_types(vals.dtype, b.dtype) if out_dtype is None \
        else out_dtype
    ep = epilogue
    ell_vals = apply_vals(structure, vals).to(acc_dtype)
    cols = structure["cols"].long()
    bias_col = bias.to(acc_dtype)[:, None] \
        if ep is not None and ep.bias else None

    def one(b2, res2):
        out = torch.einsum("ml,mln->mn", ell_vals,
                           b2.to(acc_dtype)[cols])[:m]
        return _finish(out, ep, bias_col, res2, odt)

    res = residual if ep is not None and ep.residual else None
    if b.dim() == 2:
        return one(b, res)
    return _map_leading(one, b, res)


def rowsplit_schedule_ref(structure: dict, vals: torch.Tensor,
                          b: torch.Tensor, m: int, parts: int, *,
                          epilogue=None, bias=None, residual=None,
                          acc_dtype=torch.float32,
                          out_dtype=None) -> torch.Tensor:
    """The row-split kernel's schedule replayed in tensor ops: the same C as
    :func:`rowsplit_execute_ref`, reached the kernel's way.

    Each row's L slots form groups of 32 (the last one padded with dead
    slots), split in ``parts`` contiguous parts of ``ceil(groups / parts)``
    groups.  A part walks its groups in order and stops after the first
    one that is not all live (a group with no live slot adds nothing), so
    it never reads past the row's end; the parts' partial sums are then
    added in part order, and the epilogue is applied once.  Raises if a
    live slot lies past the point where its part stopped, i.e. if the
    structure breaks the ELL prefix property (``rowsplit_spmm.ell_slots``)
    that the kernel's early stop relies on.  Arguments as in
    :func:`rowsplit_execute_ref`.
    """
    odt = torch.promote_types(vals.dtype, b.dtype) if out_dtype is None \
        else out_dtype
    ep = epilogue
    nnz_pad = vals.shape[0]
    m_pad, l = structure["cols"].shape
    groups = -(-l // 32)
    pad = groups * 32 - l
    live = torch.nn.functional.pad(structure["slot_nz"] < nnz_pad, (0, pad))
    full = live.reshape(m_pad, groups, 32).all(-1)
    per = -(-groups // parts)
    walked = torch.zeros((m_pad, groups), dtype=torch.bool,
                         device=live.device)
    bounds = [(p * per, min(groups, (p + 1) * per)) for p in range(parts)]
    for g0, g1 in bounds:
        if g0 < g1:                 # group g0 always; later ones while full
            walked[:, g0] = True
            walked[:, g0 + 1:g1] = torch.cumprod(
                full[:, g0:g1 - 1].int(), 1).bool()
    read = live & walked.repeat_interleave(32, 1)
    if bool((live & ~read).any()):
        raise AssertionError("a live slot lies past its part's first group "
                             "with a dead slot (the ELL prefix property)")
    ell_vals = torch.nn.functional.pad(apply_vals(structure, vals),
                                       (0, pad)).to(acc_dtype)
    ell_vals = torch.where(read, ell_vals, 0)
    cols = torch.nn.functional.pad(structure["cols"].long(), (0, pad))
    bias_col = bias.to(acc_dtype)[:, None] \
        if ep is not None and ep.bias else None

    def one(b2, res2):
        c = None
        for g0, g1 in bounds:       # the parts' partials, in part order
            s0, s1 = 32 * g0, 32 * g1
            part = torch.einsum("ml,mln->mn", ell_vals[:, s0:s1],
                                b2.to(acc_dtype)[cols[:, s0:s1]])
            c = part if c is None else c + part
        return _finish(c[:m], ep, bias_col, res2, odt)

    res = residual if ep is not None and ep.residual else None
    if b.dim() == 2:
        return one(b, res)
    return _map_leading(one, b, res)


def rowsplit_staged_ref(structure: dict, vals: torch.Tensor,
                        b: torch.Tensor, m: int, *, window: int = STAGED_WINDOW,
                        epilogue=None, bias=None, residual=None,
                        acc_dtype=torch.float32,
                        out_dtype=None) -> torch.Tensor:
    """The row-split kernel's staged body replayed in tensor ops: the same C
    as :func:`rowsplit_schedule_ref` at one part, reached the staged way.

    B is cut into windows of ``window`` rows (zero past k), taken in order.
    Every row keeps a cursor into its slots; in a window it takes the run
    of slots from the cursor whose columns lie below the window's end (a
    dead slot's column is past every window), found a group of 32 slots at
    a time as the lanes hold them and going on into the next group when a
    whole group is taken, and reads each slot's B row from the window at
    ``col - k0``.  The kernel walks the runs of a warp's rows in lockstep;
    each row's own slots go in the same order.  Raises if a
    slot is taken in a window its column is not in (its row's columns
    descend: the kernel would read outside the stage) or a live slot is
    never taken.  The products are then summed as
    :func:`rowsplit_schedule_ref` sums them, in the order the slots were
    taken.  Arguments as in :func:`rowsplit_execute_ref`.
    """
    odt = torch.promote_types(vals.dtype, b.dtype) if out_dtype is None \
        else out_dtype
    ep = epilogue
    nnz_pad = vals.shape[0]
    m_pad, l = structure["cols"].shape
    k = b.shape[-2]
    groups = -(-l // 32)
    width = groups * 32
    dev = structure["cols"].device
    live = torch.nn.functional.pad(structure["slot_nz"] < nnz_pad,
                                   (0, width - l))
    big = torch.iinfo(torch.int64).max
    cols = torch.nn.functional.pad(structure["cols"].long(), (0, width - l))
    col_or_big = torch.where(live, cols, big)
    windows = max(1, -(-k // window))
    taken_in = torch.full((m_pad, width), -1, dtype=torch.int64, device=dev)
    cur = torch.zeros(m_pad, dtype=torch.int64, device=dev)
    lane = torch.arange(32, device=dev)
    rows = torch.arange(m_pad, device=dev)
    for w in range(windows):
        kend = (w + 1) * window
        while True:                 # the groups a window's runs reach
            pos = cur % 32
            at = (cur - pos)[:, None] + lane[None, :]       # the group
            inb = at < width
            elig = torch.where(inb, col_or_big[rows[:, None],
                                               at.clamp(max=width - 1)],
                               big) < kend
            run = torch.cumprod((elig | (lane[None, :] < pos[:, None]))
                                .long(), 1).bool() & (lane[None, :] >=
                                                      pos[:, None])
            cnt = run.sum(1)
            taken_in[rows[:, None].expand_as(at)[run], at[run]] = w
            cur = cur + cnt
            if not bool(((cnt > 0) & (cur % 32 == 0)).any()):
                break
    took = taken_in >= 0
    if bool((live & ~took).any()):
        raise AssertionError("a live slot was never taken (a row's columns "
                             "descend)")
    k0 = taken_in.clamp(min=0) * window
    if bool((took & ((cols < k0) | (cols >= k0 + window))).any()):
        raise AssertionError("a slot was taken in a window its column is "
                             "not in (a row's columns descend)")
    ell_vals = torch.nn.functional.pad(apply_vals(structure, vals),
                                       (0, width - l)).to(acc_dtype)
    ell_vals = torch.where(took, ell_vals, 0)
    off = torch.where(took, cols - k0, 0)
    bias_col = bias.to(acc_dtype)[:, None] \
        if ep is not None and ep.bias else None

    def one(b2, res2):
        wins = torch.nn.functional.pad(b2.to(acc_dtype),
                                       (0, 0, 0, windows * window - k))
        wins = wins.reshape(windows, window, -1)
        brows = torch.where(took[..., None],
                            wins[taken_in.clamp(min=0), off], 0)
        c = torch.einsum("ml,mln->mn", ell_vals, brows)
        return _finish(c[:m], ep, bias_col, res2, odt)

    res = residual if ep is not None and ep.residual else None
    if b.dim() == 2:
        return one(b, res)
    return _map_leading(one, b, res)


# The columns a lane owns in a 128-column slice, by body (csrc/
# spmm_common.cuh Layout): (values a lane, their stride, rows taken at
# once by as many groups of lanes).
_LAYOUTS = {"f32x4": (4, 1, 1), "bf16x8": (8, 1, 2), "scalar": (4, 32, 1)}


def _transposed_sums(tile: torch.Tensor) -> torch.Tensor:
    """The kernel's transposed reduction: tile (..., lanes, K) holds lane
    l's partial of nonzero i at [..., l, i]; returns (..., K), column i
    summed over the lanes in lane order, as lane i of the kernel sums it."""
    s = tile[..., 0, :]
    for lane in range(1, tile.shape[-2]):
        s = s + tile[..., lane, :]
    return s


def sddmm_schedule_ref(rows: torch.Tensor, cols: torch.Tensor,
                       valid: torch.Tensor, dc: torch.Tensor,
                       b: torch.Tensor, g: int,
                       body: str = "f32x4") -> torch.Tensor:
    """The SDDMM kernel's schedule replayed in tensor ops: the same dots as
    :func:`sddmm_ref` (in float32), reached the kernel's way.

    The nonzeros form groups of 32 (the last padded with dead slots);
    worker w walks the ``g`` groups [w g, (w + 1) g).  In each 128-column
    slice a lane owns the columns of ``body``'s layout and writes one
    partial (dC row · B row over its columns) for each nonzero of its half
    of the group (all 32, or 16 a half-warp in ``bf16x8``), 0 for dead
    ones, to its row of a tile; the transposed reduction sums nonzero j's
    column of the tile over the lanes of its half in lane order (lane j of
    the kernel), and the slices' sums are added in slice order.  Dead
    slots are written as 0.  Raises unless every slot is written exactly
    once.
    ``dc``/``b`` may carry leading batch dims, kept per element.
    """
    per, stride, slots = _LAYOUTS[body]
    lanes = 32 // slots
    nnz_pad = rows.shape[0]
    n_groups = -(-nnz_pad // 32)
    pad = n_groups * 32 - nnz_pad
    live = torch.nn.functional.pad(valid, (0, pad))
    r = torch.nn.functional.pad(rows.long(), (0, pad))
    c = torch.nn.functional.pad(cols.long(), (0, pad))

    def one(dc2, b2):
        n = dc2.shape[-1]
        out = torch.zeros(n_groups * 32, dtype=torch.float32,
                          device=dc2.device)
        written = torch.zeros(n_groups * 32, dtype=torch.int64,
                              device=dc2.device)
        for w in range(-(-n_groups // g)):
            s = slice(32 * w * g, 32 * min(n_groups, (w + 1) * g))
            rw, cw, lw = r[s], c[s], live[s]
            total = torch.zeros(rw.shape[0], dtype=torch.float32,
                                device=dc2.device)
            for s0 in range(0, n, 128):     # slices, in order
                lane = torch.arange(lanes, device=dc2.device)
                q = torch.arange(per, device=dc2.device)
                own = (s0 + lane[:, None] * per + q if stride == 1
                       else s0 + lane[:, None] + stride * q)   # (lanes, per)
                inside = own < n
                own = own.clamp(max=n - 1)
                d = dc2.float()[rw][:, own] * inside    # (nz, lanes, per)
                x = b2.float()[cw][:, own] * inside
                part = torch.where(lw[:, None], (d * x).sum(-1), 0)
                # (groups, halves, nonzero i of the half, lane) -> the
                # tile [lane][i] of each half, summed by columns.
                part = part.reshape(-1, slots, lanes, lanes).transpose(-1, -2)
                total = total + _transposed_sums(part).reshape(-1)
            out[s] = torch.where(lw, total, 0)
            written[s] += 1
        if not bool((written == 1).all()):
            raise AssertionError("slots written other than once")
        return out[:nnz_pad]

    if dc.dim() == 2:
        return one(dc, b)
    lead = dc.shape[:-2]
    dc3 = dc.reshape((-1,) + dc.shape[-2:])
    b3 = b.reshape((-1,) + b.shape[-2:])
    return torch.stack([one(dc3[i], b3[i]) for i in range(dc3.shape[0])]
                       ).reshape(lead + (nnz_pad,))


def sddmm_ref(rows: torch.Tensor, cols: torch.Tensor, valid: torch.Tensor,
              dc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the SDDMM kernel: the gather-dot oracle.

    ``dvals[..., p] = dC[..., rows[p], :] · B[..., cols[p], :]`` summed in
    float32 like the kernel (or in the operands' wider type), masked by
    ``valid`` and cast to ``dc``'s dtype — the cotangent of the CSR values
    under C = A @ B.  Leading batch dims are kept per element
    (shared-values callers reduce them).
    """
    rows, cols = rows.long(), cols.long()
    acc = torch.promote_types(torch.promote_types(dc.dtype, b.dtype),
                              torch.float32)

    def one(dc2, b2):
        dots = (dc2.to(acc)[rows] * b2.to(acc)[cols]).sum(-1)
        return torch.where(valid, dots, 0).to(dc.dtype)

    if dc.dim() == 2:
        return one(dc, b)
    return _map_leading(one, dc, b)


def moe_group_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                       block_expert: torch.Tensor, tt: int) -> torch.Tensor:
    """Plain version of the grouped GEMM kernel: one batched product per
    block of ``tt`` tokens.

    ``y[i] = x[i] @ w[block_expert[i // tt]]`` in float32, cast once to
    x's dtype; a block whose expert is out of range is zeros, as in the
    kernel.  Gathers one (d_in, d_out) weight per block, never one per
    token (the reference oracle's ``w[group_ids]`` would take 34 GB at
    OLMoE's full width).
    """
    tokens, d_in = x.shape
    n_experts, _, d_out = w.shape
    n_blocks = tokens // tt
    live = block_expert < n_experts
    wb = w[block_expert.long().clamp(max=n_experts - 1)].float()
    y = torch.bmm(x.reshape(n_blocks, tt, d_in).float(), wb)
    y = torch.where(live[:, None, None], y, 0.0)
    return y.reshape(tokens, d_out).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, chunk: int = 1024) -> torch.Tensor:
    """Plain version of the flash attention kernel: causal GQA attention.

    q (b, s, h, dh), k/v (b, s, kv, dh) with h % kv == 0 → (b, s, h, dh)
    in q's dtype.  The kernel's numerics: scores in f32 from the operands'
    exact values, scaled by ``dh ** -0.5`` after the dot product; the
    causal mask by position with the finite ``NEG_INF``; softmax in f32;
    p rounded to v's dtype before P·V; sums in f32; the output divided by
    ``max(l, 1e-30)``.  Query rows go in chunks of at most ``chunk`` rows
    against every key (each row's softmax is its own, so the result does
    not depend on ``chunk``), which bounds the f32 score tensor.
    """
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    kf, vf = k.float(), v.float()
    pos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for c0 in range(0, s, chunk):
        c1 = min(s, c0 + chunk)
        qg = q[:, c0:c1].reshape(b, c1 - c0, kvh, g, dh).float()
        sc = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * dh ** -0.5
        sc = torch.where(pos[c0:c1, None] >= pos[None, :], sc, NEG_INF)
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        l = p.sum(-1)
        acc = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vf)
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, c0:c1] = o.permute(0, 3, 1, 2, 4).reshape(
            b, c1 - c0, h, dh).to(q.dtype)
    return out
