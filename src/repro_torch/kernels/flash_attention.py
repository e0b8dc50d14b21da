"""Causal flash attention with online softmax.

* :func:`flash_attention_cuda`: the hand-written CUDA kernel in
  ``csrc/flash_attention.cu``, three bodies chosen by (dtype, head_dim)
  (:func:`body_for`):

  - ``wgmma``, bf16 at dh 64 and 128 (the served models' widths): a
    block owns 192 (dh 64) or 128 (dh 128) query rows of one (batch,
    head); a producer warpgroup loads Q and a ring of 128-key K/V tiles
    by TMA, and 3 or 2 consumer warpgroups of 64 rows run Q·Kᵀ and P·V
    on the tensor cores with ``wgmma`` and the softmax in registers,
    taking turns so that one's exps overlap the others' products;
  - ``mma_sync``, bf16 at the other head dims: 64 query rows a block,
    4 warps of 16 rows, ``mma.sync`` on 64-key tiles;
  - ``simt``, float32: FMA outside the tensor cores.

  Each walks its key tiles from the first to the diagonal (only the
  tiles that cross it are masked elementwise); tiles above it are never
  visited, and the query tiles with the most key tiles launch first.  The
  KV head of query head ``h`` is ``h // (heads // kv_heads)``, read in
  place (no broadcast copy), and the (b, s, h, dh) strides are read
  directly (no fold or transpose copy); a ragged s is masked, not
  padded.  The result does not depend on the tile sizes beyond bf16
  rounding of the online softmax's rescaled p.
* Its plain PyTorch version is
  ``repro_torch.kernels.ref.flash_attention_ref``.

The reference kernel has no backward, so neither has this one: a call
that would need a gradient raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _cuda

DEFAULT_BQ = 128     # the reference's block sizes (its padding length)
DEFAULT_BK = 128
NEG_INF = -1e30      # finite: no (-inf) - (-inf) can make a NaN
HEAD_DIMS = tuple(range(16, 129, 16))   # the kernel's template instances

# The kernel's bodies, by the code its C entry reports
# (csrc/flash_attention.cu, enum Body).
BODIES = ("simt", "mma_sync", "wgmma")
WGMMA_HEAD_DIMS = (64, 128)

# Launches of the flash attention kernel, one per flash_attention_cuda
# call that ran it, and the same launches by the body that ran.
LAUNCHES = 0
LAUNCHES_BY_BODY: dict[str, int] = {}


def body_for(dtype: torch.dtype, dh: int) -> str:
    """The body the kernel runs for operands of ``dtype`` and head_dim
    ``dh``: ``wgmma`` for bfloat16 at dh 64 and 128, ``mma_sync`` for
    bfloat16 at the other head dims, ``simt`` for float32."""
    if dtype == torch.float32:
        return "simt"
    if dtype == torch.bfloat16:
        return "wgmma" if dh in WGMMA_HEAD_DIMS else "mma_sync"
    raise TypeError(f"the kernel takes float32 or bfloat16, not {dtype}")


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(b, s, h, kv, dh) of a causal GQA call; raises on any other
    layout."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be (b, s, h, dh) and k/v (b, s, kv, dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    if tuple(k.shape) != (b, s, kvh, dh) or v.shape != k.shape:
        raise ValueError(f"k and v must be (b, s, kv, dh) = "
                         f"{(b, s, kvh, dh)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not share {kvh} KV heads "
                         "evenly")
    return b, s, h, kvh, dh


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """The kernel on the card: causal attention, q (b, s, h, dh), k/v
    (b, s, kv, dh), all contiguous, 16-byte aligned and of one dtype
    (float32 or bfloat16), dh one of ``HEAD_DIMS``.  Softmax and sums in
    float32; the output (b, s, h, dh) in q's dtype.  Launches once on the
    current stream without synchronising; raises on any operand the
    kernel does not take, and on a call that would need a gradient.
    """
    global LAUNCHES
    b, s, h, kvh, dh = check_shapes(q, k, v)
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} is not supported by the kernel "
                         f"(it takes {HEAD_DIMS})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda has no backward: the reference's flash "
            "attention kernel has no backward kernel either; call it under "
            "torch.no_grad() or on tensors that do not require grad")
    if not q.is_cuda:
        raise ValueError(
            f"flash_attention_cuda runs on CUDA tensors; q is on {q.device} "
            "(the plain version is kernels.ref.flash_attention_ref)")
    dev = q.device
    floats = tuple(_cuda.DTYPE_CODES)
    _cuda.require(q, "q", device=dev, dtypes=floats)
    _cuda.require(k, "k", device=dev, dtypes=(q.dtype,))
    _cuda.require(v, "v", device=dev, dtypes=(q.dtype,))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel loads 16 bytes a thread)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    body = ctypes.c_int(-1)
    _cuda.check(_cuda.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _cuda.DTYPE_CODES[q.dtype], b, s, h, kvh, dh, dh ** -0.5,
        dev.index, _cuda.stream_of(q), ctypes.byref(body)),
        "flash_attention")
    name = BODIES[body.value]
    LAUNCHES += 1
    LAUNCHES_BY_BODY[name] = LAUNCHES_BY_BODY.get(name, 0) + 1
    return out


# ------------------------------------------------------ the launch model ---

# csrc/flash_attention.cu: the mma.sync and f32 bodies' tiles and threads
# (kFaBM, kFaBN, kFaThreads, :72-74; no __launch_bounds__ minimum), the
# mma.sync body's static K and V tiles (bf16 [64][dh + 8] each) and the
# f32 body's dynamic tiles (flash_f32_smem, :689); the wgmma body's
# WgCfg<dh> (kConsumers, kBM, kThreads, kQBytes, kKvBytes, kSmem,
# :353-363), its mbarriers (uint64 q_full and four [kStages] arrays,
# :523; 72 bytes, which the compiler pads to 80) and
# __launch_bounds__(kThreads, 1); fa_grid (:873).
FA_BM, FA_BN, FA_THREADS = 64, 64, 128
WG_BN, WG_STAGES, WG_ROW_BYTES = 128, 2, 128
WG_MBARRIERS = 8 + 4 * 8 * WG_STAGES


def wg_cfg(dh: int) -> dict:
    """``WgCfg<dh>``: consumer warpgroups, query rows and threads of a
    block, and its dynamic shared memory."""
    consumers = 3 if dh == 64 else 2
    bm = 64 * consumers
    boxes = dh // 64
    q_bytes = boxes * bm * WG_ROW_BYTES
    kv_bytes = boxes * WG_BN * WG_ROW_BYTES
    return dict(bm=bm, threads=128 * (consumers + 1),
                smem=q_bytes + 2 * WG_STAGES * kv_bytes + 1024)


def launch_models(*, b: int, s: int, h: int, kvh: int, dh: int,
                  dtype) -> list:
    """The launch of one :func:`flash_attention_cuda` call, as
    ``launch_flash`` sets it up: the body (:func:`body_for`), ``fa_grid``
    (b * h, ceil(s / rows)) with the body's rows a block, its threads
    and shared memory.

    Requested bytes: a block reads its query rows once, the K and V rows
    of every key tile from the first to the last that holds a key at or
    below its last row (inside s), and writes its output rows once."""
    from . import introspect as I
    if b * s * h == 0:
        return []
    dt = I.dtype_name(dtype)
    eb = I.nbytes(dt)
    body = body_for(getattr(torch, dt), dh)
    if body == "wgmma":
        cfg = wg_cfg(dh)
        rows, tile, threads = cfg["bm"], WG_BN, cfg["threads"]
        symbol = I.template("flash_wgmma_kernel", dh)
        dyn, static, min_blocks = cfg["smem"], I.static_smem(
            WG_MBARRIERS), 1
    else:
        rows, tile, threads = FA_BM, FA_BN, FA_THREADS
        min_blocks = 0
        if body == "mma_sync":
            symbol = I.template("flash_bf16_kernel", dh)
            dyn, static = 0, I.static_smem(2 * 2 * FA_BN * (dh + 8))
        else:
            symbol = I.template("flash_f32_kernel", dh)
            dyn = 4 * ((FA_BM + FA_BN) * (dh + 1) + FA_BN * dh
                       + FA_BM * (FA_BN + 1))
            static = 0
    q_tiles = -(-s // rows)
    q0 = np.arange(q_tiles) * rows
    q_rows = np.minimum(rows, s - q0)
    if body == "wgmma":    # key tiles up to the block's last row, inside s
        n_tiles = np.minimum(-(-(q0 + rows) // tile), -(-s // tile))
    else:                  # kt = 0 .. qt (tiles of kFaBN = kFaBM keys)
        n_tiles = np.arange(q_tiles) + 1
    kv_rows = np.array([min(s, tile * int(t)) for t in n_tiles])
    row = dh * eb
    ops = (
        I.OperandAccess("q", dt, (b, s, h, dh), "in",
                        read_bytes=b * h * row * int(q_rows.sum())),
        I.OperandAccess("k", dt, (b, s, kvh, dh), "in",
                        read_bytes=b * h * row * int(kv_rows.sum())),
        I.OperandAccess("v", dt, (b, s, kvh, dh), "in",
                        read_bytes=b * h * row * int(kv_rows.sum())),
        I.OperandAccess("out", dt, (b, s, h, dh), "out",
                        write_bytes=b * h * row * s))
    stride = h * dh * eb                    # one query row to the next
    if body == "simt":     # lane: columns lane % 8 + 8 j of 4 rows
        out = I.WarpAccess("o store", tuple(
            I.lanes(r * stride, 4, 4, range(8)) for r in range(4)))
    else:   # lane: row lane / 4 (+ 8), 2 bf16 at 2 (lane % 4) + 8 j
        out = I.WarpAccess("o store", tuple(
            tuple((r * stride + 4 * quad, 4) for quad in range(4))
            for r in range(8)))
    by_name = {"out": (out,), "q": (), "k": (), "v": ()}
    ops = tuple(dataclasses.replace(o, warp=by_name[o.name]) for o in ops)
    return [I.KernelLaunch(
        label=f"flash {body}", symbol=symbol, source="flash_attention.cu",
        grid=(b * h, q_tiles, 1), block=threads, dynamic_smem=dyn,
        static_smem=static, min_blocks=min_blocks, body=body, operands=ops,
        in_dtypes=(dt, dt))]
