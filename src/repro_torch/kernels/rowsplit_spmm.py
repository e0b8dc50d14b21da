"""Row-splitting SpMM.  Paper §4.1.

* **Phase 0** (:func:`plan_rowsplit_structure`, torch ops on the pattern's
  device): scatter the CSR pattern into ELL-padded ``(m_pad, L)`` slot
  arrays, L = the longest row rounded up to ``TL``.  Element-for-element
  the reference planner's arrays (``repro.kernels.rowsplit_spmm``).
* **The kernel** (:func:`rowsplit_spmm_cuda`): the hand-written CUDA
  kernel in ``csrc/rowsplit_spmm.cu`` -- one warp per (batch, row,
  128-column slice), slots 32 at a time with the next 32 prefetched,
  (col, value) broadcast by ``__shfl_sync``, 16-byte row-major B loads
  (the bodies of ``_cuda.body_for``), the fused epilogue at the single C
  write.  A row's walk stops at its first group of 32 slots with a dead
  slot (the ELL prefix property of :func:`ell_slots`), and a short, wide
  matrix splits each row's groups into :func:`row_parts` parts whose
  partials one block sums in part order.  It takes any ELL slot block
  (:func:`ell_slots`), which the row-grouped method reuses per length
  bucket.  Its plain PyTorch version is
  ``repro_torch.kernels.ref.rowsplit_execute_ref``;
  ``ref.rowsplit_schedule_ref`` replays its schedule in tensor ops.
* **The staged body** of the same kernel (:func:`use_staged`): where B is
  float32, every row's live columns ascend (``structure["ascending"]``,
  found once at plan time), B is at least a tile wide and the launch's
  tiles of ``STAGED_ROWS`` rows by ``STAGED_COLS`` columns fill the card,
  a block takes ``STAGED_ROWS`` rows of a (batch, column slice) and reads B
  from windows of its panel that TMA stages in shared memory once per
  block, instead of gathering a B row from L2 for every nonzero.  Same
  sums in the same order: bit-equal to the f32x4 body at one part.
  ``ref.rowsplit_staged_ref`` replays its windows and cursors in tensor
  ops.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core.csr import CSR

from . import _cuda

TM = 8
DEFAULT_TL = 16

# Parts of a row: more warps for a matrix of few rows, within one wave.
# The kernel holds 4 blocks of 8 warps an SM (its register cap); a row's
# groups of 32 slots split in up to MAX_PARTS parts (the warps of a
# block), each of at least MIN_PART_GROUPS groups.  At Llama-3.2-1B's FFN
# shapes (n = 128) on 132 SMs: w1 (8192 rows of 512) runs 8192 warps,
# r = 1; w2 (2048 rows of 2048) 2048 warps, r = 2, 4096 warps (on the
# H100, r = 2 was the fastest of 1, 2, 4 and 8 at w2).
RESIDENT_WARPS_PER_SM = 32
MAX_PARTS = 8
MIN_PART_GROUPS = 4

# The staged body (csrc/rowsplit_spmm.cu kStagedWarps, kStagedRowsPerWarp,
# kStagedHalves, kStagedWindow, kStagedStages): its consumer warps and the
# rows each owns, a block's columns (128 a half), the rows of B a stage of
# shared memory holds and the stages.  It runs where B is at least
# STAGED_COLS wide and the launch has at least STAGED_MIN_TILES_PER_SM tiles
# (batch x row blocks x column slices) an SM: at n = 128 half of every tile
# idles, and below a tile an SM the warp-per-row body, which spreads a
# launch over more warps, was faster on the H100 (PERF.md §6, row 2: the
# crossover grid).
STAGED_WARPS = 24
STAGED_ROWS_PER_WARP = 2
STAGED_HALVES = 2
STAGED_WINDOW = 64
STAGED_STAGES = 3
STAGED_ROWS = STAGED_WARPS * STAGED_ROWS_PER_WARP
STAGED_COLS = 128 * STAGED_HALVES
STAGED_MIN_TILES_PER_SM = 1

# Slots of one block of rows that plan_rowsplit_structure fills at once.
ELL_BLOCK_SLOTS = 1 << 26

# Launches of the row-split kernel, one per rowsplit_spmm_cuda call, and
# the same launches by the body that ran.
LAUNCHES = 0
LAUNCHES_BY_BODY: dict[str, int] = {}


def ell_slots(a: CSR, rows: torch.Tensor, l: int, *, tm: int = TM) -> dict:
    """ELL slot block ``{cols, slot_nz}`` for a row subset, padded to tm.

    ``rows`` (r,) selects the rows; each is laid out over ``l`` slots.
    Invalid slots carry ``slot_nz == nnz_pad`` — the sentinel that reads a
    zero value — and the column gather is sentinel-extended so a 0-nnz
    pattern (empty ``col_ind``) stays constructible.

    The prefix property, a contract of the structure that the kernel
    relies on: each row's live slots (``slot_nz < nnz_pad``) come first,
    in CSR order, and every slot after the first dead one is dead (pad rows
    are all dead).  So the kernel ends a row at its first group of 32
    slots that holds a dead slot.

    ``ascending`` (a bool, read once on the host here): every row's live
    columns ascend (non-decreasing), as :func:`prune_to_csr` and
    ``from_dense`` give them; the staged body takes only such structures.
    """
    i32, i64 = torch.int32, torch.int64
    dev = a.device
    rows = rows.to(i64)
    row_ptr = a.row_ptr.to(i64)
    lengths = torch.diff(row_ptr)
    idx = torch.arange(l, dtype=i64, device=dev)
    take = row_ptr[rows][:, None] + idx[None, :]          # (r, l)
    valid = idx[None, :] < lengths[rows][:, None]
    safe = torch.where(valid, take, 0)
    col_ext = torch.cat([a.col_ind, a.col_ind.new_zeros(1)])
    cols = torch.where(valid, col_ext[safe], 0).to(i32)
    slot_nz = torch.where(valid, take, a.nnz_pad).to(i32)
    ascending = bool(((cols[:, 1:] >= cols[:, :-1])
                      | ~valid[:, 1:]).all())
    r = rows.shape[0]
    pad_rows = tm * (-(-r // tm)) - r
    cols = torch.nn.functional.pad(cols, (0, 0, 0, pad_rows))
    slot_nz = torch.nn.functional.pad(slot_nz, (0, 0, 0, pad_rows),
                                      value=a.nnz_pad)
    return dict(cols=cols, slot_nz=slot_nz, ascending=ascending)


def plan_rowsplit_structure(a: CSR, *, l_pad: int, tl: int = DEFAULT_TL,
                            tm: int = TM) -> dict:
    """Phase 0, pattern-only: ELL slot structure (m_pad, L), L = l_pad↑tl.

    ``l_pad`` must be an upper bound on the longest row.  Values are
    re-applied per call through ``slot_nz``; ``ascending`` as in
    :func:`ell_slots`.
    """
    l = max(tl, tl * (-(-l_pad // tl)))
    m_pad = tm * (-(-a.m // tm))
    cols = torch.zeros((m_pad, l), dtype=torch.int32, device=a.device)
    slot_nz = torch.full((m_pad, l), a.nnz_pad, dtype=torch.int32,
                         device=a.device)
    # ell_slots' int64 (rows, l) temporaries are 8x the block they fill:
    # a block of rows at a time keeps them near ELL_BLOCK_SLOTS slots, so
    # a skewed matrix whose ELL fills much of the card still plans.
    block = max(1, ELL_BLOCK_SLOTS // l)
    ascending = True
    for r0 in range(0, a.m, block):
        rows = torch.arange(r0, min(r0 + block, a.m), dtype=torch.int64,
                            device=a.device)
        part = ell_slots(a, rows, l, tm=1)
        cols[r0:r0 + rows.numel()] = part["cols"]
        slot_nz[r0:r0 + rows.numel()] = part["slot_nz"]
        ascending = ascending and part["ascending"]
    return dict(cols=cols, slot_nz=slot_nz, ascending=ascending)


def row_parts(m: int, n: int, l: int, batch: int, sm_count: int) -> int:
    """r, the parts the kernel splits each row's ``ceil(l / 32)`` groups
    of slots into: doubled from 1 while the launch's ``batch * m *
    ceil(n / 128) * 2 r`` warps would still fit one wave (``sm_count *
    RESIDENT_WARPS_PER_SM``), up to MAX_PARTS and while each part keeps
    at least MIN_PART_GROUPS groups."""
    warps = batch * m * -(-n // 128)
    groups = -(-l // 32)
    r = 1
    while (r < MAX_PARTS
           and warps * 2 * r <= sm_count * RESIDENT_WARPS_PER_SM
           and groups >= 2 * r * MIN_PART_GROUPS):
        r *= 2
    return r


def staged_tiles(m: int, n: int, batch: int) -> int:
    """The staged body's blocks: ``batch * ceil(m / STAGED_ROWS) *
    ceil(n / STAGED_COLS)`` tiles."""
    return batch * -(-m // STAGED_ROWS) * -(-n // STAGED_COLS)


def use_staged(body: str, ascending: bool, m: int, n: int, batch: int,
               sm_count: int) -> bool:
    """Whether a launch of C (batch, m, n) runs the staged body: it would
    run ``f32x4`` (``_cuda.body_for``), the structure's live columns ascend
    in every row, n is at least STAGED_COLS, and the launch's tiles
    (:func:`staged_tiles`) give each of the ``sm_count`` SMs at least
    STAGED_MIN_TILES_PER_SM."""
    return (body == "f32x4" and ascending and n >= STAGED_COLS
            and staged_tiles(m, n, batch)
            >= STAGED_MIN_TILES_PER_SM * sm_count)


def rowsplit_spmm_cuda(structure: dict, vals: torch.Tensor,
                       b: torch.Tensor, m: int, *, epilogue=None,
                       bias=None, residual=None,
                       out_dtype: torch.dtype | None = None,
                       parts: int | None = None,
                       staged: bool | None = None) -> torch.Tensor:
    """The kernel on the card: ``b`` (batch, k, n) row-major → C
    (batch, m, n) over the ELL block ``structure`` (``cols``/``slot_nz``
    (m_pad, L), m_pad >= m).

    ``vals`` are the raw (nnz_pad,) values, gathered in-kernel through
    ``slot_nz``; ``epilogue`` with ``bias (m,)`` / ``residual
    (batch, m, n)`` per its flags is applied in float32 at the single
    write, cast to ``out_dtype`` (default: b's dtype).  ``staged`` (default:
    :func:`use_staged` where ``parts`` is not given) runs the staged body;
    True raises where the body would not be ``f32x4`` or the structure's
    columns do not ascend.  Otherwise ``parts`` (1, 2, 4 or 8; default
    :func:`row_parts` on b's device) splits each row's slot groups among
    that many warps.  Launches on the current stream without
    synchronising; raises on any operand the kernel does not take.
    """
    global LAUNCHES
    if not b.is_cuda:
        raise ValueError(
            f"rowsplit_spmm_cuda runs on CUDA tensors; b is on {b.device} "
            "(the plain version is kernels.ref.rowsplit_execute_ref)")
    dev = b.device
    floats = tuple(_cuda.DTYPE_CODES)
    m_pad, l = structure["cols"].shape
    if m_pad < m:
        raise ValueError(f"structure has {m_pad} rows, C has {m}")
    if b.dim() != 3:
        raise ValueError(f"b must be (batch, k, n), got {tuple(b.shape)}")
    batch, k, n = b.shape
    for name in ("cols", "slot_nz"):
        _cuda.require(structure[name], name, device=dev,
                      dtypes=(torch.int32,), shape=(m_pad, l))
    _cuda.require(vals, "vals", device=dev, dtypes=floats)
    _cuda.require(b, "b", device=dev, dtypes=floats)
    out_dtype = b.dtype if out_dtype is None else out_dtype
    if out_dtype not in _cuda.DTYPE_CODES:
        raise TypeError(f"the row-split kernel writes float32 or bfloat16, "
                        f"not {out_dtype}")
    bias, residual, act, has_scale, scale = _cuda.epilogue_args(
        epilogue, bias, residual, device=dev, m=m, batch=batch, n=n)
    body = _cuda.body_for(b.dtype, n, aligned=all(
        t is None or t.data_ptr() % 16 == 0 for t in (b, residual)))
    ascending = bool(structure.get("ascending", False))
    if staged is None:
        staged = parts is None and use_staged(
            body, ascending, m, n, batch, _cuda.sm_count(dev))
    elif staged and (body != "f32x4" or not ascending or parts not in
                     (None, 1)):
        raise ValueError(
            f"the staged body takes float32 B with n % 4 == 0, 16-byte "
            f"aligned, a structure whose columns ascend and one part; got "
            f"the {body} body, ascending={ascending}, parts={parts}")
    if parts is None:
        parts = 1 if staged else row_parts(m, n, l, batch,
                                           _cuda.sm_count(dev))
    if parts not in (1, 2, 4, 8):
        raise ValueError(f"parts must be 1, 2, 4 or 8, got {parts}")
    lib = _cuda.library()
    out = torch.empty((batch, m, n), dtype=out_dtype, device=dev)
    ran = ctypes.c_int(-1)
    _cuda.check(lib.repro_rowsplit_spmm(
        structure["cols"].data_ptr(), structure["slot_nz"].data_ptr(),
        vals.data_ptr(), _cuda.DTYPE_CODES[vals.dtype], b.data_ptr(),
        _cuda.DTYPE_CODES[b.dtype], _cuda.ptr(bias), _cuda.ptr(residual),
        act, has_scale, scale, out.data_ptr(), _cuda.DTYPE_CODES[out_dtype],
        batch, m, l, vals.shape[0], k, n, parts, int(staged), dev.index,
        _cuda.stream_of(b), ctypes.byref(ran)), "rowsplit_spmm")
    LAUNCHES += 1
    _cuda.count_launch(LAUNCHES_BY_BODY, ran.value)
    return out


# ------------------------------------------------------ the launch model ---

# csrc/spmm_common.cuh kBlock, kWarpsPerBlock, kSliceCols (:34-36), and
# csrc/rowsplit_spmm.cu kRowsplitBlocksPerSm (its __launch_bounds__) and
# the `partial` array (float [kWarpsPerBlock][kSliceCols], static).
K_BLOCK, K_WARPS_PER_BLOCK, K_SLICE_COLS = 256, 8, 128
BLOCKS_PER_SM = 4
SMEM_PARTIAL = 4 * K_WARPS_PER_BLOCK * K_SLICE_COLS
# The staged body (csrc/rowsplit_spmm.cu kStagedThreads, kStagedSmem): its
# consumer warps and the producer; in dynamic shared memory the ring, each
# row's pairs of two groups of 32 slots (8 bytes a slot) and 128 bytes to
# align the ring; the stages' "full" and "empty" mbarriers (static); one
# block an SM (its __launch_bounds__).
STAGED_THREADS = (STAGED_WARPS + 1) * 32
STAGED_SMEM = (STAGED_STAGES * STAGED_WINDOW * STAGED_COLS * 4
               + STAGED_ROWS * 2 * 32 * 8 + 128)
SMEM_BARRIERS = 2 * 8 * STAGED_STAGES


def _ell_walk(slot_nz, m: int, l: int, nnz_pad: int, parts: int) -> dict:
    """What the warps of one (batch, 128-column slice) issue, summed over
    the rows and their parts, as ``rowsplit_kernel`` walks its groups of
    32 slots: ``index`` the lanes that load a (col, slot_nz) pair (the
    first group of a part, then the next group after each group walked),
    ``gather`` the values gathered through slot_nz (the first group, then
    the next group after each full one), ``live`` the B rows loaded (the
    live slots of the groups walked: the walk ends at a part's first
    group with no live slot, and after its first group with a dead
    one)."""
    groups = -(-l // 32)
    live = np.zeros((m, groups * 32), bool)
    live[:, :l] = slot_nz[:m] < nnz_pad
    cnt = live.reshape(m, groups, 32).sum(2)
    lanes_g = np.minimum(32, l - 32 * np.arange(groups))
    full = cnt == 32
    per_part = -(-groups // parts)            # rowsplit_spmm.cu per_part
    rows = np.arange(m)
    tot = dict(index=0, gather=0, live=0)
    for p in range(parts):
        gb, ge = p * per_part, min(groups, (p + 1) * per_part)
        if ge <= gb:
            continue
        f = full[:, gb:ge]
        wf = np.where(f.all(1), ge - gb, f.argmin(1))  # full groups walked
        nxt = np.minimum(gb + wf, groups - 1)
        walked = wf + ((gb + wf < ge) & (cnt[rows, nxt] > 0))
        cum = np.concatenate([[0], np.cumsum(lanes_g[gb:ge])])
        cc = np.concatenate([np.zeros((m, 1), np.int64),
                             np.cumsum(cnt[:, gb:ge], 1)], 1)
        tot["index"] += int(cum[np.minimum(walked + 1, ge - gb)].sum())
        tot["gather"] += int(cc[rows, np.minimum(wf + 1, ge - gb)].sum())
        tot["live"] += int(cc[rows, walked].sum())
    return tot


def ell_launch(label: str, structure: dict, *, m: int, k: int,
               nnz_pad: int, n: int, batch: int, vals_dtype, b_dtype,
               out_dtype, bias: bool, residual: bool, card):
    """The model of one :func:`rowsplit_spmm_cuda` launch over the ELL
    block ``structure`` (``cols``/``slot_nz`` (m_pad, l)), as its wrapper
    and ``repro_rowsplit_spmm`` set it up; None where the wrapper's
    caller returns before it (``ops._execute``'s m == 0, k == 0 or empty
    B)."""
    from . import introspect as I
    if m == 0 or k == 0 or n == 0 or batch == 0:
        return None
    cols, slot_nz = I.host(structure["cols"]), I.host(structure["slot_nz"])
    m_pad, l = slot_nz.shape
    vdt, bdt, odt = (I.dtype_name(d) for d in (vals_dtype, b_dtype,
                                                out_dtype))
    vb, bb, ob = I.nbytes(vdt), I.nbytes(bdt), I.nbytes(odt)
    body = _cuda.body_for(getattr(torch, bdt), n)  # pick_body, aligned
    if use_staged(body, bool(structure.get("ascending", False)), m, n,
                  batch, card.sms):
        return _staged_launch(label, cols, slot_nz, m=m, k=k,
                              nnz_pad=nnz_pad, n=n, batch=batch,
                              dtypes=(vdt, bdt, odt), bias=bias,
                              residual=residual)
    parts = row_parts(m, n, l, batch, card.sms)   # rowsplit_spmm_cuda
    # repro_rowsplit_spmm: n_slices, warps and blocks; it returns before
    # the launch when blocks == 0.
    n_slices = -(-n // K_SLICE_COLS)
    warps = batch * m * n_slices * parts
    blocks = -(-warps // K_WARPS_PER_BLOCK)
    walk = _ell_walk(slot_nz, m, l, nnz_pad, parts)
    live = slot_nz[:m] < nnz_pad
    ops = [
        I.OperandAccess("cols", "int32", (m_pad, l), "in",
                        read_bytes=4 * n_slices * batch * walk["index"]),
        I.OperandAccess("slot_nz", "int32", (m_pad, l), "in",
                        read_bytes=4 * n_slices * batch * walk["index"]),
        I.OperandAccess("vals", vdt, (nnz_pad,), "in",
                        read_bytes=vb * n_slices * batch * walk["gather"]),
        I.OperandAccess("b", bdt, (batch, k, n), "in",
                        read_bytes=bb * n * batch * walk["live"]),
        I.OperandAccess("out", odt, (batch, m, n), "out",
                        write_bytes=ob * batch * m * n)]
    if bias:       # one float32 a stored row slice (the wrapper casts)
        ops.append(I.OperandAccess("bias", "float32", (m,), "in",
                                   read_bytes=4 * batch * m * n_slices))
    if residual:
        ops.append(I.OperandAccess("residual", "float32", (batch, m, n),
                                   "in", read_bytes=4 * batch * m * n))
    ops = _with_lanes(ops, cols, slot_nz, live, l, n, body, vb, bb, ob)

    def writers():
        # An item a (batch, row, slice): whatever the parts, part 0's warp
        # alone stores it (rowsplit_spmm.cu `if (part > 0) return;`), so
        # the single writer is structural here.
        return np.ones((batch, m, n_slices), np.int64)

    def walks():
        rows = np.broadcast_to(np.arange(m)[:, None], live.shape)
        return [I.Walk("slot_nz along a row", rows[live],
                       slot_nz[:m][live])]

    def indices():
        pos = np.broadcast_to(np.arange(l), live.shape)
        first_dead = np.where(live.all(1), l, (~live).argmax(1))
        return [
            I.IndexStream("cols of live slots (B rows)", cols[:m][live], k),
            I.IndexStream("slot_nz of live slots (vals)",
                          slot_nz[:m][live], nnz_pad),
            I.IndexStream("live slot before its row's first sentinel",
                          pos[live], np.broadcast_to(
                              first_dead[:, None], live.shape)[live])]

    tv, tb, to = (I.CXX_TYPES[d] for d in (vdt, bdt, odt))
    return I.KernelLaunch(
        label=label, symbol=I.template(
            "rowsplit_kernel", I.SPMM_BODY_CODES[body], tv, tb, to),
        source="rowsplit_spmm.cu", grid=(blocks, 1, 1), block=K_BLOCK,
        dynamic_smem=0, static_smem=I.static_smem(SMEM_PARTIAL),
        min_blocks=BLOCKS_PER_SM,
        body=body, operands=tuple(ops), in_dtypes=(vdt, bdt),
        acc_dtype="float32", launched=blocks > 0, writers=writers,
        walks=walks, indices=indices)


def _staged_launch(label, cols, slot_nz, *, m, k, nnz_pad, n, batch,
                   dtypes, bias, residual):
    """The model of a staged launch (``launch_staged`` in
    rowsplit_spmm.cu): one block a (batch, STAGED_ROWS rows, STAGED_COLS
    columns) tile.  Requested bytes: B once per row block (the TMA windows,
    less what falls past k or n); each row's slot groups as its warp
    fetches them (the first three, then one more after each group of 32
    it takes whole); each live value gathered once; C stored once."""
    from . import introspect as I
    vdt, bdt, odt = dtypes
    vb, bb, ob = I.nbytes(vdt), I.nbytes(bdt), I.nbytes(odt)
    m_pad, l = slot_nz.shape
    n_slices = -(-n // STAGED_COLS)
    row_blocks = -(-m // STAGED_ROWS)
    tiles = batch * row_blocks * n_slices
    live = slot_nz[:m] < nnz_pad
    lengths = live.sum(1)
    groups = -(-l // 32)
    lanes_g = np.minimum(32, l - 32 * np.arange(groups))
    cum = np.concatenate([[0], np.cumsum(lanes_g)])
    index = int(cum[np.minimum(3 + lengths // 32, groups)].sum())
    per = batch * n_slices
    ops = [
        I.OperandAccess("cols", "int32", (m_pad, l), "in",
                        read_bytes=4 * per * index),
        I.OperandAccess("slot_nz", "int32", (m_pad, l), "in",
                        read_bytes=4 * per * index),
        I.OperandAccess("vals", vdt, (nnz_pad,), "in",
                        read_bytes=vb * per * int(lengths.sum())),
        I.OperandAccess("b", bdt, (batch, k, n), "in",
                        read_bytes=bb * batch * row_blocks * k * n),
        I.OperandAccess("out", odt, (batch, m, n), "out",
                        write_bytes=ob * batch * m * n)]
    # The epilogue runs a row's 128-column slices one store_row each.
    slices = -(-n // K_SLICE_COLS)
    if bias:
        ops.append(I.OperandAccess("bias", "float32", (m,), "in",
                                   read_bytes=4 * batch * m * slices))
    if residual:
        ops.append(I.OperandAccess("residual", "float32", (batch, m, n),
                                   "in", read_bytes=4 * batch * m * n))
    # B reaches shared memory by TMA: no warp loads it from global memory.
    ops = [o if o.name != "b" else dataclasses.replace(o, warp=())
           for o in _with_lanes(ops, cols, slot_nz, live, l, n, "f32x4",
                                vb, bb, ob)]

    def writers():
        return np.ones((batch, m, slices), np.int64)

    def walks():
        rows = np.broadcast_to(np.arange(m)[:, None], live.shape)
        return [I.Walk("slot_nz along a row", rows[live],
                       slot_nz[:m][live]),
                I.Walk("cols along a row (the windows)", rows[live],
                       cols[:m][live], strict=False)]

    def indices():
        return [
            I.IndexStream("cols of live slots (B rows)", cols[:m][live], k),
            I.IndexStream("slot_nz of live slots (vals)",
                          slot_nz[:m][live], nnz_pad)]

    tv, to = I.CXX_TYPES[vdt], I.CXX_TYPES[odt]
    return I.KernelLaunch(
        label=label, symbol=I.template(
            "rowsplit_kernel", I.SPMM_BODY_CODES["staged"], tv,
            I.CXX_TYPES[bdt], to),
        source="rowsplit_spmm.cu", grid=(tiles, 1, 1), block=STAGED_THREADS,
        dynamic_smem=STAGED_SMEM, static_smem=I.static_smem(SMEM_BARRIERS),
        min_blocks=1, body="staged", operands=tuple(ops),
        in_dtypes=(vdt, bdt), acc_dtype="float32", launched=tiles > 0,
        writers=writers, walks=walks, indices=indices)


def _with_lanes(ops, cols, slot_nz, live, l, n, body, vb, bb, ob):
    """One warp's instructions for each operand: the warp of batch 0,
    slice 0 and part 0 of the first row with a full group of 32 live
    slots (else the first with a live slot), over its first group."""
    from . import introspect as I
    cnt0 = live[:, :32].sum(1)
    pick = np.flatnonzero(cnt0 == min(32, l))
    pick = pick if pick.size else np.flatnonzero(cnt0)
    if not pick.size:
        return ops
    r = int(pick[0])
    idx = I.WarpAccess("group load", (I.lanes(r * l * 4, 4, 4,
                                              range(min(32, l))),))
    slots = [int(s) for s in slot_nz[r, :32][live[r, :32]]]
    gather = I.WarpAccess("gather", (tuple((s * vb, vb) for s in slots),))
    c = [int(x) for x in cols[r, :2]]
    brow = I.row_loads("B row", tuple(x * n * bb for x in c), n, bb, body)
    by_name = {"cols": (idx,), "slot_nz": (idx,), "vals": (gather,),
               "b": brow,
               "out": I.row_steps("C row", r * n * ob, n, ob, body),
               "residual": I.row_steps("residual row", r * n * 4, n, 4,
                                       body),
               "bias": (I.WarpAccess("bias", (((r * 4, 4),),)),)}
    return [dataclasses.replace(o, warp=by_name[o.name]) for o in ops]


def launch_models(plan, n: int, batch: int, var, card) -> list:
    """The row-split method's launches (``MethodSpec.traffic``): one
    :func:`rowsplit_spmm_cuda` launch over ``plan.fwd``.  ``var`` carries
    ``vals_dtype``/``b_dtype``/``out_dtype``/``epilogue``; ``card`` the
    SM count and limits (``introspect.card_of``)."""
    meta, ep = plan.meta, var.epilogue
    odt = var.out_dtype or torch.promote_types(
        getattr(torch, var.vals_dtype), getattr(torch, var.b_dtype))
    model = ell_launch("rowsplit", plan.fwd, m=meta.m, k=meta.k,
                       nnz_pad=meta.nnz_pad, n=n, batch=batch,
                       vals_dtype=var.vals_dtype, b_dtype=var.b_dtype,
                       out_dtype=odt, bias=bool(ep and ep.bias),
                       residual=bool(ep and ep.residual), card=card)
    return [] if model is None else [model]
