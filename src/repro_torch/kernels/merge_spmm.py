"""Merge-based (nonzero-split) SpMM.  Paper §4.2.

* **Phase 1** (:func:`plan_merge_structure`, torch ops on the pattern's
  device): assign an equal number ``T`` of nonzeroes per chunk, breaking
  chunks at ``TM``-row output tiles.  The arrays are element-for-element
  those of the reference planner (``repro.kernels.merge_spmm``), so plans
  of the two packages compare with ``array_equal``.
* **Phase 2** (:func:`merge_spmm_cuda`): the hand-written CUDA kernel in
  ``csrc/merge_spmm.cu``, the paper's merge path on the chunk stream.
  Worker w (a warp per batch and 128-column slice) takes the ``G`` chunks
  [w G, (w + 1) G) -- equal nonzeros for every worker -- and owns the rows
  between two split rows (:func:`split_rows`).  Rows inside its range are
  summed in registers and stored once with the epilogue; the two end rows
  go to a small float32 carry buffer that a second launch, the fix-up,
  sums in worker order.  No atomics, no zeroed scratch, the same bits on
  every call.  Three bodies by B's dtype, n and alignment
  (``_cuda.body_for``, shared with row-split and the SDDMM).  Its plain
  PyTorch version is ``repro_torch.kernels.ref.merge_execute_ref``;
  ``ref.merge_schedule_ref`` replays its schedule in tensor ops.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core.csr import CSR, rows_from_row_ptr

from . import _cuda

TM = 8
DEFAULT_T = 16

# Nonzero slots a worker takes: 64 chunks at the default t, so a pruned
# Llama-3.2-1B FFN matrix (4.2 M nonzeros) gives ~4.1 k warps, about one
# wave of 4 blocks of 8 warps on each of 132 SMs, and a carry buffer of
# 4 MB against 2 GB of B rows read.  Timed on the H100 at the Llama
# shapes, 16, 32, 48 and 96 chunks were no faster.
SLOTS_PER_WORKER = 1024

# Launches of the merge kernel, one per merge_spmm_cuda call (the range
# kernel and its fix-up), and the same launches by the body that ran.
LAUNCHES = 0
LAUNCHES_BY_BODY: dict[str, int] = {}


def range_chunks(t: int) -> int:
    """G, the chunks of one worker's range at chunk size ``t``: about
    SLOTS_PER_WORKER slots."""
    return max(1, SLOTS_PER_WORKER // t)


def split_rows(structure: dict, m: int, g: int, nnz_pad: int):
    """The split rows S_{-1} .. S_{W-1} of ranges of ``g`` chunks, as the
    kernel computes them (``split_at`` in ``csrc/merge_spmm.cu``): worker w
    owns the rows [S_{w-1}, S_w], sharing each end row with its neighbour.

    S_{-1} = 0 and S_{W-1} = m - 1.  Between them, chunk c = (j + 1) g
    opens worker j + 1: where it opens a row tile, the tile's first row;
    else the row of its slot 0 when that slot is live (``slot_nz`` below
    the sentinel ``nnz_pad``; every chunk of a tile but its last is full);
    else m - 1, and worker j + 1 opens past the last live slot: it and all
    later workers hold nothing.  Returns ``(split (W + 1,) int64,
    past_end (W,) bool)`` on the structure's device.
    """
    n_chunks = structure["cols"].shape[0]
    dev = structure["cols"].device
    workers = -(-n_chunks // g)
    c = torch.arange(1, workers, dtype=torch.int64, device=dev) * g
    tile = structure["tile"].long()[c]
    opens = structure["first"][c].bool()
    live = structure["slot_nz"][c, 0] < nnz_pad
    inner = torch.where(live, tile * TM + structure["lrow"][c, 0].long(),
                        m - 1)
    mid = torch.where(opens, tile * TM, inner)
    ends = torch.tensor([0], dtype=torch.int64, device=dev)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    return (torch.cat([ends, mid, ends + (m - 1)]),
            torch.cat([no, ~opens & ~live]))


def plan_merge_structure(a: CSR, *, t: int = DEFAULT_T, tm: int = TM):
    """Phase 1, pattern-only: equal-nonzero chunks broken at TM-row tiles.

    Depends only on ``row_ptr``/``col_ind``, never on ``vals``: values are
    re-applied per call through ``slot_nz``.  Returns a dict of int32
    tensors on the pattern's device:

      cols    (C, t)  column index of each nonzero in each chunk
      lrow    (C, t)  row offset within the TM-row tile, in [0, tm)
      slot_nz (C, t)  flat nonzero id feeding each slot, or ``nnz_pad`` (a
                      sentinel that reads a zero) for unused slots
      tile    (C,)    output row-tile of the chunk (non-decreasing)
      first   (C,)    1 iff chunk is the first of its row tile
      last    (C,)    1 iff chunk is the last of its row tile
    where C = nnz_pad//t + ceil(m/tm) (the static worst case).
    """
    m, nnz_pad = a.m, a.nnz_pad
    dev = a.device
    i32, i64 = torch.int32, torch.int64
    if m == 0:
        # Degenerate 0-row pattern: no output tiles, no valid nonzeroes.
        n_chunks = max(1, -(-nnz_pad // t))
        zeros = torch.zeros((n_chunks, t), dtype=i32, device=dev)
        edge = torch.zeros(n_chunks, dtype=i32, device=dev)
        first, last = edge.clone(), edge.clone()
        first[0] = 1
        last[-1] = 1
        return dict(cols=zeros, lrow=zeros.clone(),
                    slot_nz=torch.full((n_chunks, t), nnz_pad, dtype=i32,
                                       device=dev),
                    tile=edge, first=first, last=last)
    n_tiles_m = -(-m // tm)
    n_chunks = -(-nnz_pad // t) + n_tiles_m

    nz_ids = torch.arange(nnz_pad, dtype=i64, device=dev)
    rows = rows_from_row_ptr(a.row_ptr, nnz_pad).to(i64)  # pads → m
    tile_of_nz = torch.clamp(rows // tm, max=n_tiles_m - 1)
    # nonzero count per row tile, and each nonzero's rank within its tile
    # (tile_of_nz is non-decreasing: CSR order, pads at the end).
    tile_starts = torch.searchsorted(
        tile_of_nz, torch.arange(n_tiles_m, dtype=i64, device=dev))
    tile_counts = torch.diff(
        tile_starts, append=torch.tensor([nnz_pad], dtype=i64, device=dev))
    pos_in_tile = nz_ids - tile_starts[tile_of_nz]
    # chunks per tile: ceil(count/t), at least 1 so every row tile is
    # visited; exclusive prefix sum.
    chunks_per_tile = torch.clamp(-(-tile_counts // t), min=1)
    cum = torch.cumsum(chunks_per_tile, 0)            # inclusive prefix
    chunks_before = cum - chunks_per_tile
    dest_chunk = chunks_before[tile_of_nz] + pos_in_tile // t
    dest_slot = pos_in_tile % t

    # Padded nonzeroes keep their slots (reserved via the last tile's
    # count) but contribute column 0 and the sentinel value slot.
    valid = nz_ids < a.nnz()
    inb = dest_chunk < n_chunks                        # the ref's "drop"
    dc, ds, ok = dest_chunk[inb], dest_slot[inb], valid[inb]
    cols = torch.zeros((n_chunks, t), dtype=i32, device=dev)
    cols[dc, ds] = torch.where(ok, a.col_ind[inb], 0).to(i32)
    slot_nz = torch.full((n_chunks, t), nnz_pad, dtype=i32, device=dev)
    slot_nz[dc, ds] = torch.where(ok, nz_ids[inb], nnz_pad).to(i32)
    lrow = torch.zeros((n_chunks, t), dtype=i32, device=dev)
    lrow[dc, ds] = torch.where(ok, rows[inb] % tm, 0).to(i32)

    # chunk -> row tile (non-decreasing); unused tail chunks point at the
    # last tile so the stream stays monotone.
    chunk_ids = torch.arange(n_chunks, dtype=i64, device=dev)
    tile_of_chunk = torch.searchsorted(cum, chunk_ids, right=True)
    used = chunk_ids < cum[-1]
    tile_of_chunk = torch.clamp(tile_of_chunk, max=n_tiles_m - 1)
    tile = torch.where(used, tile_of_chunk, n_tiles_m - 1).to(i32)
    change = (tile[1:] != tile[:-1]).to(i32)
    one = torch.ones(1, dtype=i32, device=dev)
    return dict(cols=cols, lrow=lrow, slot_nz=slot_nz, tile=tile,
                first=torch.cat([one, change]),
                last=torch.cat([change, one]))


def apply_vals(structure: dict, vals: torch.Tensor) -> torch.Tensor:
    """Gather per-call values into a structure's slots (chunk or ELL
    layout); ``slot_nz == nnz_pad`` slots read an appended zero."""
    vals_ext = torch.cat([vals, vals.new_zeros(1)])
    return vals_ext[structure["slot_nz"].long()]


def merge_spmm_cuda(structure: dict, vals: torch.Tensor, b: torch.Tensor,
                    m: int, *, epilogue=None, bias=None, residual=None,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Phase 2 on the card: ``b`` (batch, k, n) row-major → C (batch, m, n).

    ``structure`` is :func:`plan_merge_structure`'s output on ``b``'s
    device, ``vals`` the raw (nnz_pad,) values (gathered in-kernel through
    ``slot_nz``).  ``epilogue`` with ``bias (m,)`` / ``residual
    (batch, m, n)`` per its flags is applied after all partial sums are
    in, in float32, with one cast to ``out_dtype`` (default: b's dtype).
    Workers take :func:`range_chunks` chunks each.  Launches the range
    kernel and its fix-up on the current stream without synchronising;
    raises on any operand the kernel does not take.
    """
    global LAUNCHES
    if not b.is_cuda:
        raise ValueError(
            f"merge_spmm_cuda runs on CUDA tensors; b is on {b.device} "
            "(the plain version is kernels.ref.merge_execute_ref)")
    dev = b.device
    floats = tuple(_cuda.DTYPE_CODES)
    n_chunks, t = structure["cols"].shape
    if b.dim() != 3:
        raise ValueError(f"b must be (batch, k, n), got {tuple(b.shape)}")
    batch, k, n = b.shape
    if t > 32:
        raise ValueError(f"the merge kernel takes chunks of at most 32 "
                         f"nonzeroes; this plan has t={t}")
    for name in ("cols", "lrow", "slot_nz"):
        _cuda.require(structure[name], name, device=dev,
                      dtypes=(torch.int32,), shape=(n_chunks, t))
    for name in ("tile", "first"):
        _cuda.require(structure[name], name, device=dev,
                      dtypes=(torch.int32,), shape=(n_chunks,))
    _cuda.require(vals, "vals", device=dev, dtypes=floats)
    _cuda.require(b, "b", device=dev, dtypes=floats)
    out_dtype = b.dtype if out_dtype is None else out_dtype
    if out_dtype not in _cuda.DTYPE_CODES:
        raise TypeError(f"the merge kernel writes float32 or bfloat16, "
                        f"not {out_dtype}")
    g = range_chunks(t)
    bias, residual, act, has_scale, scale = _cuda.epilogue_args(
        epilogue, bias, residual, device=dev, m=m, batch=batch, n=n)
    out = torch.empty((batch, m, n), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    workers = -(-n_chunks // g)
    carry = torch.empty((batch, workers, 2, n), dtype=torch.float32,
                        device=dev)
    body = ctypes.c_int(-1)
    _cuda.check(_cuda.library().repro_merge_spmm(
        structure["cols"].data_ptr(), structure["lrow"].data_ptr(),
        structure["slot_nz"].data_ptr(), structure["tile"].data_ptr(),
        structure["first"].data_ptr(), vals.data_ptr(),
        _cuda.DTYPE_CODES[vals.dtype], b.data_ptr(),
        _cuda.DTYPE_CODES[b.dtype], _cuda.ptr(bias), _cuda.ptr(residual),
        act, has_scale, scale, out.data_ptr(), _cuda.DTYPE_CODES[out_dtype],
        carry.data_ptr(), batch, n_chunks, t, TM, vals.shape[0], m, k, n, g,
        dev.index, _cuda.stream_of(b), ctypes.byref(body)), "merge_spmm")
    LAUNCHES += 1
    _cuda.count_launch(LAUNCHES_BY_BODY, body.value)
    return out


# ------------------------------------------------------ the launch model ---

# csrc/spmm_common.cuh kBlock, kWarpsPerBlock, kSliceCols (:34-36);
# csrc/merge_spmm.cu kRangeBlocksPerSm (the range kernel's
# __launch_bounds__, :54; the fix-up names no minimum, :280).  Neither
# kernel has shared memory.
K_BLOCK, K_WARPS_PER_BLOCK, K_SLICE_COLS = 256, 8, 128
RANGE_BLOCKS_PER_SM = 4


def _split_host(structure: dict, m: int, g: int, nnz_pad: int):
    """:func:`split_rows` on the host: (S_{-1} .. S_{W-1}, past_end)."""
    split, past = split_rows(structure, m, g, nnz_pad)
    return split.cpu().numpy().astype(np.int64), past.cpu().numpy()


def _fixup_runs(split: np.ndarray, past: np.ndarray, workers: int):
    """For each fix-up item j in [-1, W - 1] (index j + 1): whether it
    stores its row (the first j of a run of equal split rows), and the
    last split index jb and worker w_end of its run, as
    ``merge_fixup_kernel`` walks them: the run ends at the first split
    whose next worker opens past the last live slot."""
    n = workers + 1
    first = np.ones(n, bool)
    first[1:] = split[1:] != split[:-1]
    jb = np.arange(n) - 1
    w_end = np.zeros(n, np.int64)
    for i in np.flatnonzero(first):
        j = i - 1
        x = j
        while True:
            # S_x, x in [j, W - 1]: split[x + 1]; worker x + 1 opens past
            # the end when past[x + 1] (x + 1 < W).
            if x + 1 < workers and past[x + 1]:
                jb[i], w_end[i] = x, x
                break
            if x + 1 >= workers or split[x + 2] != split[i]:
                jb[i], w_end[i] = x, min(x + 1, workers - 1)
                break
            x += 1
    return first, jb, w_end


def merge_launches(structure: dict, *, m: int, k: int, nnz_pad: int,
                   n: int, batch: int, vals_dtype, b_dtype, out_dtype,
                   bias: bool, residual: bool, label: str = "merge") -> list:
    """The two launches of one :func:`merge_spmm_cuda` call over the chunk
    structure ``structure`` (the range kernel and its fix-up), as the
    wrapper and ``repro_merge_spmm`` set them up; [] where no launch
    runs (``ops._execute``'s early-out, an empty C, blocks == 0)."""
    from . import introspect as I
    if m == 0 or k == 0 or n == 0 or batch == 0:
        return []
    st = {key: I.host(structure[key]) for key in
          ("cols", "lrow", "slot_nz", "tile", "first")}
    n_chunks, t = st["cols"].shape
    vdt, bdt, odt = (I.dtype_name(d) for d in (vals_dtype, b_dtype,
                                                out_dtype))
    vb, bb, ob = I.nbytes(vdt), I.nbytes(bdt), I.nbytes(odt)
    g = range_chunks(t)                        # as merge_spmm_cuda
    body = _cuda.body_for(getattr(torch, bdt), n)
    # repro_merge_spmm: workers, n_slices, warps, fix_warps and both block
    # counts (merge_spmm.cu :391-401); no launch when blocks == 0.
    workers = -(-n_chunks // g)
    n_slices = -(-n // K_SLICE_COLS)
    blocks = -(-(batch * workers * n_slices) // K_WARPS_PER_BLOCK)
    fix_blocks = -(-(batch * (workers + 1) * n_slices) // K_WARPS_PER_BLOCK)
    if blocks == 0:
        return []
    split, past = _split_host(structure, m, g, nnz_pad)
    slot = st["slot_nz"].reshape(-1)
    live = slot < nnz_pad
    rows = np.repeat(st["tile"], t) * TM + st["lrow"].reshape(-1)
    worker = np.arange(slot.size) // (g * t)
    live_w = np.bincount(worker[live], minlength=workers)
    span_w = np.bincount(worker, minlength=workers)       # slots a range
    lo, hi = split[:-1], split[1:]
    holds = ~past                                         # not past the end
    inner = np.where(holds, np.maximum(hi - lo - 1, 0), 0)
    # split_at reads (tile, first, slot_nz, lrow) of S_j, 0 <= j < W - 1
    reads_split = lambda j: ((j >= 0) & (j < workers - 1)).astype(np.int64)
    w_ids = np.arange(workers)
    split_words = reads_split(w_ids - 1) + np.where(
        holds, reads_split(w_ids), 0)
    per = batch * n_slices                 # warps of one range or item
    first, jb, w_end = _fixup_runs(split, past, workers)
    j_ids = np.arange(-1, workers)
    lo_halves = np.where(first, np.maximum(w_end - j_ids, 0), 0)
    hi_halves = np.where(first, np.maximum(
        np.minimum(jb, w_end) - np.maximum(j_ids, 0) + 1, 0), 0)
    # The fix-up's lane l reads S_{j-1+l} (four words, 0 <= j-1+l < W-1):
    # one round (a run of 31 or more equal split rows reads 32 more a
    # round, not counted).
    lane_splits = np.clip(np.minimum(j_ids + 30, workers - 2)
                          - np.maximum(j_ids - 1, 0) + 1, 0, 32)
    stored_fix = int(first.sum())
    slots = int((span_w * holds).sum())        # fetched by live ranges
    words = int(split_words.sum())
    range_ops = [
        I.OperandAccess("cols", "int32", (n_chunks, t), "in",
                        read_bytes=4 * per * slots),
        I.OperandAccess("lrow", "int32", (n_chunks, t), "in",
                        read_bytes=4 * per * (slots + words)),
        I.OperandAccess("slot_nz", "int32", (n_chunks, t), "in",
                        read_bytes=4 * per * (slots + words)),
        I.OperandAccess("tile", "int32", (n_chunks,), "in", read_bytes=4 * per
                        * (int((span_w // t * holds).sum()) + words)),
        I.OperandAccess("first", "int32", (n_chunks,), "in",
                        read_bytes=4 * per * words),
        I.OperandAccess("vals", vdt, (nnz_pad,), "in",
                        read_bytes=vb * per * int(live_w.sum())),
        I.OperandAccess("b", bdt, (batch, k, n), "in",
                        read_bytes=bb * n * batch * int(live_w.sum())),
        I.OperandAccess("out", odt, (batch, m, n), "out",
                        write_bytes=ob * n * batch * int(inner.sum())),
        I.OperandAccess("carry", "float32", (batch, workers, 2, n), "scratch",
                        write_bytes=4 * n * batch * 2 * int(holds.sum()))]
    fix_ops = [
        I.OperandAccess(name, "int32", (n_chunks,) if name in (
            "tile", "first") else (n_chunks, t), "in",
            read_bytes=4 * per * int(lane_splits.sum()))
        for name in ("tile", "first", "slot_nz", "lrow")]
    fix_ops += [
        I.OperandAccess("carry", "float32", (batch, workers, 2, n), "scratch",
                        read_bytes=4 * n * batch * int(
                            (lo_halves + hi_halves).sum())),
        I.OperandAccess("out", odt, (batch, m, n), "out",
                        write_bytes=ob * n * batch * stored_fix)]
    for ops_, n_rows in ((range_ops, int(inner.sum())), (fix_ops, stored_fix)):
        if bias:
            ops_.append(I.OperandAccess("bias", "float32", (m,), "in",
                                        read_bytes=4 * per * n_rows))
        if residual:
            ops_.append(I.OperandAccess("residual", "float32", (batch, m, n),
                                        "in", read_bytes=4 * n * batch
                                        * n_rows))
    range_ops = _range_lanes(range_ops, st, live, t, n, body, vb, bb, ob)
    fix_ops = _fixup_lanes(fix_ops, workers, g, t, n, body, ob)

    def writers():
        # Rows strictly inside a range by its worker (the range kernel);
        # each distinct split row once, by the first fix-up item of its
        # run (merge_spmm.cu :274-306).
        stores = np.zeros(m + 1, np.int64)
        for w in np.flatnonzero(holds):
            a, b = np.clip((lo[w] + 1, hi[w]), 0, m)
            if b > a:
                stores[a] += 1
                stores[b] -= 1
        stores = np.cumsum(stores)[:m]
        fixed = split[first]
        np.add.at(stores, fixed[(fixed >= 0) & (fixed < m)], 1)
        return np.broadcast_to(stores[None, :, None], (batch, m, n_slices))

    def walks():
        return [I.Walk("slot_nz along a range", worker[live], slot[live]),
                I.Walk("rows along a range", worker[live], rows[live],
                       strict=False)]

    def indices():
        n_tiles = -(-m // TM)
        return [
            I.IndexStream("cols of live slots (B rows)",
                          st["cols"].reshape(-1)[live], k),
            I.IndexStream("slot_nz (sentinel nnz_pad: dead)", slot,
                          nnz_pad + 1),
            I.IndexStream("tile of each chunk", st["tile"], n_tiles),
            I.IndexStream("row of live slots (tile * TM + lrow)",
                          rows[live], m),
            I.IndexStream("lrow of live slots", st["lrow"].reshape(-1)[live],
                          TM),
            I.IndexStream("first flag", st["first"], 2),
            I.IndexStream("split rows", split, m)]

    tv, tb, to = (I.CXX_TYPES[d] for d in (vdt, bdt, odt))
    code = I.SPMM_BODY_CODES[body]
    fix_body = "scalar" if body == "scalar" else "f32x4"
    return [
        I.KernelLaunch(
            label=f"{label} range", symbol=I.template(
                "merge_range_kernel", code, tv, tb, to),
            source="merge_spmm.cu", grid=(blocks, 1, 1), block=K_BLOCK,
            dynamic_smem=0, static_smem=0,
            min_blocks=RANGE_BLOCKS_PER_SM, body=body,
            operands=tuple(range_ops), in_dtypes=(vdt, bdt),
            writers=writers, walks=walks, indices=indices),
        I.KernelLaunch(
            label=f"{label} fix-up", symbol=I.template(
                "merge_fixup_kernel", code, to),
            source="merge_spmm.cu", grid=(fix_blocks, 1, 1), block=K_BLOCK,
            dynamic_smem=0, static_smem=0, min_blocks=0, body=fix_body,
            operands=tuple(fix_ops), in_dtypes=("float32",))]


def _range_lanes(ops, st, live, t, n, body, vb, bb, ob):
    """The instructions of the range kernel's warp 0 over its first group
    of 32 slots."""
    from . import introspect as I
    n_slots = min(32, st["slot_nz"].size)
    slot = st["slot_nz"].reshape(-1)[:n_slots]
    cols = st["cols"].reshape(-1)[:2]
    grp = I.WarpAccess("group load", (I.lanes(0, 4, 4, range(n_slots)),))
    gather = I.WarpAccess("gather", (tuple(
        (int(s) * vb, vb) for s in slot[live[:n_slots]]),))
    tile = I.WarpAccess("tile of each slot's chunk", (tuple(
        ((lane // t) * 4, 4) for lane in range(n_slots)),))
    by_name = {
        "cols": (grp,), "lrow": (grp,), "slot_nz": (grp,),
        "tile": (tile,), "first": (),
        "vals": (gather,),
        "b": I.row_loads("B row", tuple(int(c) * n * bb for c in cols), n,
                         bb, body),
        "out": I.row_steps("C row", 0, n, ob, body),
        "carry": I.row_steps("carry row", 0, n, 4, body),
        "residual": I.row_steps("residual row", 0, n, 4, body),
        "bias": (I.WarpAccess("bias", (((0, 4),),)),)}
    return [dataclasses.replace(o, warp=by_name[o.name]) for o in ops]


def _fixup_lanes(ops, workers, g, t, n, body, ob):
    """The instructions of fix-up item j = 0: lane l reads S_{l-1}'s
    chunk words (one word a worker, apart by design: each lane its own
    run), then the carry rows and the store in the f32x4 (or scalar)
    layout."""
    from . import introspect as I
    fix = "scalar" if body == "scalar" else "f32x4"
    active = [lane for lane in range(32) if 0 <= lane - 1 < workers - 1]
    split = I.WarpAccess("split_at of S_(j-1+lane)", tuple(
        ((lane * g * t * 4, 4),) for lane in active))
    chunk = I.WarpAccess("split_at of S_(j-1+lane)", tuple(
        ((lane * g * 4, 4),) for lane in active))
    by_name = {"tile": (chunk,), "first": (chunk,), "slot_nz": (split,),
               "lrow": (split,),
               "carry": I.row_steps("carry row", 0, n, 4, fix),
               "out": I.row_steps("C row", 0, n, ob, fix),
               "residual": I.row_steps("residual row", 0, n, 4, fix),
               "bias": (I.WarpAccess("bias", (((0, 4),),)),)}
    return [dataclasses.replace(o, warp=by_name[o.name]) for o in ops]


def launch_models(plan, n: int, batch: int, var, card) -> list:
    """The merge method's launches (``MethodSpec.traffic``): the range
    kernel and the fix-up of one :func:`merge_spmm_cuda` call over
    ``plan.fwd``.  ``card`` is unused: the launch does not depend on the
    SM count."""
    meta, ep = plan.meta, var.epilogue
    odt = var.out_dtype or torch.promote_types(
        getattr(torch, var.vals_dtype), getattr(torch, var.b_dtype))
    return merge_launches(plan.fwd, m=meta.m, k=meta.k, nnz_pad=meta.nnz_pad,
                          n=n, batch=batch, vals_dtype=var.vals_dtype,
                          b_dtype=var.b_dtype, out_dtype=odt,
                          bias=bool(ep and ep.bias),
                          residual=bool(ep and ep.residual))
