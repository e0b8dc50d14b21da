"""Transformer building blocks: RMSNorm and LayerNorm, RoPE and
sinusoidal positions, causal GQA attention (full or windowed) over a
prefill, one-token attention against a KV cache, and the SwiGLU/GELU MLP.

Pure functions over plain dicts of tensors, in the reference's layouts
(``repro.models.layers``): weights are ``(d_in, d_out)`` and used as
``x @ W``.  ``init_*`` draw from a ``torch.Generator`` on the target
device.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (_fit, active_mesh, constrain,
                                              pad, whole)

# ---------------------------------------------------------------- norms ----


NORMS = ("rmsnorm", "layernorm")


def _check_norm(kind: str) -> None:
    if kind not in NORMS:
        raise ValueError(f"norm {kind!r}: expected one of {NORMS}")


def init_norm(d: int, kind: str, dtype, device) -> dict:
    _check_norm(kind)
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def norm_apply(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm: statistics in f32, elementwise math in the
    input dtype, then scale and (LayerNorm) bias (the reference's cast
    order)."""
    _check_norm(kind)
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        ms = torch.mean(torch.square(xf), -1, keepdim=True)
        y = x * torch.rsqrt(ms + eps).to(x.dtype)
    else:
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
        y = (x - mu.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    y = y * p["scale"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


# ----------------------------------------------------------------- RoPE ----


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x (..., s, h, dh), positions (..., s)
    broadcastable; frequencies and angles in f32."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq   # (..., s, half)
    ang = ang[..., None, :]                                # (..., s, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal positions (MusicGen): positions (..., s) →
    f32 (..., s, d), sines then cosines."""
    half = d // 2
    freq = 10_000.0 ** (-torch.arange(half, dtype=torch.float32,
                                      device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------- conv ----


def causal_conv(x, conv, state=None):
    """Causal depthwise conv along the sequence (the SSD and RG-LRU
    blocks').  x (b, s, c), conv (w, c); ``state`` (b, w-1, c) holds the
    inputs before x (zeros when None).  Returns (out, new_state), the new
    state x's last w - 1 inputs in x's dtype; the taps are summed in
    order, in x's dtype."""
    w = conv.shape[0]
    if state is None:
        xp = pad(x, (0, 0, w - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    new_state = xp[:, -(w - 1):] if w > 1 else None
    out = sum(xp[:, i:i + x.shape[1]] * conv[i] for i in range(w))
    return out, new_state


# ------------------------------------------------------------ attention ----


def normal_init(gen, shape, dtype, scale):
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * scale


def init_attention(gen: torch.Generator, cfg) -> dict:
    d, h, kvh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d ** -0.5
    p = {
        "wq": normal_init(gen, (d, h * dh), cfg.pdtype, s),
        "wk": normal_init(gen, (d, kvh * dh), cfg.pdtype, s),
        "wv": normal_init(gen, (d, kvh * dh), cfg.pdtype, s),
        "wo": normal_init(gen, (h * dh, d), cfg.pdtype, s),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", kvh * dh),
                            ("bv", kvh * dh)):
            p[name] = torch.zeros(width, dtype=cfg.pdtype,
                                  device=gen.device)
    return p


def _qkv(p, x, cfg):
    b, s, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.cdtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    # Under a mesh: heads over the model axis (TP), batch over dp; in pure
    # FSDP mode heads stay whole and the batch spans every rank.
    bt = "dp" if cfg.tp else "dpm"
    ht = "model" if cfg.tp else None
    mesh = active_mesh()

    def heads(y, n, ht):
        if mesh is not None:
            # aten.view into heads has no DTensor rule for a width sharded
            # across a head (the model axis not dividing n): the flat
            # projection takes the heads' layout first.
            y = constrain(y, bt, None, ht if _fit(mesh, n, ht) else None)
        return constrain(y.reshape(b, s, n, dh), bt, None, ht, None)

    # Nor has the view of q's heads into (kv, g) groups when the model
    # axis splits q's heads but not kv's: q's heads then stay whole.
    qt = ht if mesh is None or _fit(mesh, kvh, ht) else None
    return heads(q, h, qt), heads(k, kvh, ht), heads(v, kvh, ht)


# A (q, kv) block whose every key is masked for every query changes none
# of the carry's bits (m stays, p is 0, alpha is 1 or the carry is 0), so
# flash_attention skips it (tests/test_torch_flash.py holds the bits with
# and without the skip).
SKIP_MASKED_BLOCKS = True


def _attend_block(q, k, v, qpos, kpos, carry, *, scale, window, softcap):
    """Online-softmax update for one (q-chunk, kv-chunk) pair (the
    reference's ``_attend_block``).  q (b, cq, kv, g, dh); k/v (b, ck, kv,
    dh); positions (cq,), (ck,); carry = (m, l, acc) with shapes (b, kv,
    g, cq[, dh]).  Scores in f32 from the inputs' exact values, p cast to
    v's dtype before PV, sums in f32.  The isfinite guards give the
    reference's values; their untaken sides are kept finite, so no NaN
    reaches a gradient."""
    m, l, acc = carry
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    s = torch.where(mask, s, float("-inf"))
    m_new = torch.maximum(m, s.amax(-1))
    live = torch.isfinite(m_new)
    p = torch.exp(s - torch.where(live, m_new, 0.0)[..., None])
    p = torch.where(live[..., None], p, 0.0)
    alpha = torch.exp(torch.where(torch.isfinite(m), m - m_new,
                                  float("-inf")))
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    return m_new, l, acc


def _attend_q_chunk(q_blk, k_win, v_win, *, qpos0, start, kv_chunk,
                    scale, window, softcap, checkpointed):
    """One query chunk against its key span: the online softmax over the
    span's kv chunks, each chunk's step checkpointed under grad; returns
    (b, cq, h, dh) in q's dtype."""
    b, cq, kvh, g, dh = q_blk.shape
    dev = q_blk.device
    qpos = qpos0 + torch.arange(cq, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    carry = (torch.full((b, kvh, g, cq), float("-inf"), **f32),
             torch.zeros((b, kvh, g, cq), **f32),
             torch.zeros((b, kvh, g, cq, dh), **f32))
    for ki in range(k_win.shape[1] // kv_chunk):
        k0 = start + ki * kv_chunk
        if SKIP_MASKED_BLOCKS and (
                k0 > qpos0 + cq - 1 or
                (window is not None and k0 + kv_chunk - 1 <= qpos0 - window)):
            continue
        sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
        kpos = k0 + torch.arange(kv_chunk, device=dev)
        step = functools.partial(_attend_block, scale=scale, window=window,
                                 softcap=softcap)
        if checkpointed:
            carry = checkpoint(step, q_blk, k_win[:, sl], v_win[:, sl], qpos,
                               kpos, carry, use_reentrant=False)
        else:
            carry = step(q_blk, k_win[:, sl], v_win[:, sl], qpos, kpos,
                         carry)
    _, l, acc = carry
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    # (b, kv, g, cq, dh) -> (b, cq, kv*g, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, cq, kvh * g, dh).to(
        q_blk.dtype)


def flash_attention(q, k, v, *, q_offset: int = 0, window: int | None = None,
                    q_chunk: int = 512, kv_chunk: int = 512,
                    softcap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """Causal blockwise attention (the reference's ``flash_attention``):
    q (b, sq, h, dh), k/v (b, skv, kv, dh) → (b, sq, h, dh) in q's dtype.

    An online softmax over (q_chunk, kv_chunk) blocks, so no tensor grows
    with sq · skv.  ``q_offset``: the absolute position of q[0].
    ``window`` (sliding or local attention): query t sees keys t - window
    + 1 … t, and each query chunk fetches only the span of kv_chunk ·
    ⌈(window + q_chunk) / kv_chunk⌉ keys that ends with it.  A block whose
    every key is masked is skipped (``SKIP_MASKED_BLOCKS``).  Under grad,
    each query chunk and each of its kv steps is checkpointed
    (non-reentrant), so the backward rebuilds one block's scores at a time
    (the reference's two ``jax.checkpoint``).  Scores are scaled by
    ``scale``, ``dh ** -0.5`` where None."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if scale is None:
        scale = dh ** -0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk:
        raise AssertionError((sq, q_chunk))
    qg = q.reshape(b, sq, kvh, g, dh)
    span = skv
    if window is not None:
        span = min(kv_chunk * -(-(window + q_chunk) // kv_chunk), skv)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for qi in range(sq // q_chunk):
        start = 0
        if window is not None:
            start = min(max(q_offset + (qi + 1) * q_chunk - span, 0),
                        skv - span)
        fn = functools.partial(
            _attend_q_chunk, qpos0=q_offset + qi * q_chunk, start=start,
            kv_chunk=kv_chunk, scale=scale, window=window, softcap=softcap,
            checkpointed=grad)
        args = (qg[:, qi * q_chunk:(qi + 1) * q_chunk],
                k[:, start:start + span], v[:, start:start + span])
        outs.append(checkpoint(fn, *args, use_reentrant=False) if grad
                    else fn(*args))
    return torch.cat(outs, dim=1)


def attention_chunk(s: int) -> int:
    """The reference's flash tile for a prefill of ``s`` tokens: 1024 up
    to 8192 tokens, 512 above (its score block bounded on 16 GiB)."""
    return 1024 if s <= 8192 else 512


def causal_attention(q, k, v, *, softcap: float = 0.0,
                     window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Causal GQA attention over a whole prefill: :func:`flash_attention`
    at the reference's chunk for the length (:func:`attention_chunk`).
    q (b, s, h, dh), k/v (b, s, kv, dh) → (b, s, h, dh) in q's dtype.  A
    length past one chunk that is not a multiple of it is padded at the
    end to one (the reference asserts instead): causality masks the
    padded keys from every real query, and the padded queries' rows are
    dropped."""
    s = q.shape[1]
    c = attention_chunk(s)
    extra = -s % c if s > c else 0
    if extra:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, extra)) for t in (q, k, v))
    out = flash_attention(q, k, v, softcap=softcap, window=window,
                          q_chunk=c, kv_chunk=c, scale=scale)
    return out[:, :s] if extra else out


def _prefill_attention(q, k, v, *, softcap, window, scale=None):
    """:func:`causal_attention`; under a mesh, on each rank's own part.
    Attention is independent across batch rows and heads, and ``_qkv``
    placed q, k and v alike over both with whole sequences, so each rank
    attends over its own rows and heads, and the result takes q's
    placements (otherwise DTensor would dispatch every op of every
    block)."""
    if not isinstance(q, DTensor):
        return causal_attention(q, k, v, softcap=softcap, window=window,
                                scale=scale)
    if not q.placements == k.placements == v.placements:
        raise ValueError(f"attention over a mesh: q, k, v placed "
                         f"{q.placements}, {k.placements}, {v.placements}")
    out = causal_attention(q.to_local(), k.to_local(), v.to_local(),
                           softcap=softcap, window=window, scale=scale)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              shape=q.shape, stride=q.stride())


def _merge_heads(out):
    """(b, s, h, dh) → (b, s, h·dh).  Under a mesh on each rank's part, the
    heads' shards becoming the width's, so the backward's view back into
    heads gets its gradient in the heads' layout (aten.view into heads has
    no DTensor rule for a width sharded across a head)."""
    b, s, h, dh = out.shape
    if not isinstance(out, DTensor):
        return out.reshape(b, s, h * dh)
    out = whole(out, 3)                 # each head's width on one rank
    local = out.to_local()
    return DTensor.from_local(
        local.reshape(*local.shape[:2], -1), out.device_mesh,
        out.placements, shape=torch.Size((b, s, h * dh)),
        stride=(s * h * dh, h * dh, 1))


def decode_attention(q, k_cache, v_cache, pos, *, softcap: float = 0.0,
                     window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """One-token attention against a cache.  q (b, 1, h, dh); caches
    (b, S, kv, dh); pos (b,) the current position (the number of tokens
    already in the cache).  Attends over the whole cache, masked to
    ``kpos <= pos`` and, with a ``window`` shorter than the cache, to
    ``kpos > pos - window``: the keys ``pos + 1 - window … pos``, the ones
    the reference slices out of the cache.  Scores are scaled by ``scale``,
    ``dh ** -0.5`` where None.

    The reference's numerics: scores from the inputs' exact f32 values
    (bf16 products are exact in f32), softmax in f32, p cast to v's dtype
    before PV, f32 sums, the output in q's dtype.
    """
    b, _, h, dh = q.shape
    s_cache, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    full_span = window is None or window >= s_cache
    if full_span:
        # Under a mesh, flash-decoding: the cache stays sharded by
        # sequence, and the softmax over it reduces partial sums.
        k_cache = constrain(k_cache, "dp", "model", None, None)
        v_cache = constrain(v_cache, "dp", "model", None, None)
        # The model axis holds the sequence here, so q's heads come whole
        # (the einsum's flattening of two sharded dims, aten.view, has no
        # DTensor rule on torch 2.11).
        q = whole(q, 2)
    qg = q.reshape(b, kvh, g, dh)
    sc = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) \
        * (dh ** -0.5 if scale is None else scale)
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    kpos = torch.arange(s_cache, device=q.device)
    mask = kpos[None, :] <= pos[:, None]                     # (b, S)
    if not full_span:
        mask &= kpos[None, :] > pos[:, None] - window
    sc = torch.where(mask[:, None, None], sc, float("-inf"))
    if full_span:
        sc = constrain(sc, "dp", None, None, "model")
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    # Under a mesh the kv heads come whole first: merging a sharded dim
    # into the next (aten.view) has no DTensor rule on torch 2.11.
    return whole(out, 1).reshape(b, 1, h, dh).to(q.dtype)


def attention_apply(p, x, cfg, *, positions=None, cache=None, pos=None):
    """Causal self-attention, over ``cfg.window`` keys for sliding-window
    and local attention (``cfg.attention`` "swa" or "local").  x (b, s,
    d).  Returns (out, new_cache), cache = {"k", "v"} (b, S, kv, dh) in
    the compute dtype:

    * no cache: a whole sequence; the new cache is its k and v;
    * ``s == 1`` with a cache: a decode step at ``pos`` (b,) — k and v are
      written into row ``pos[b]`` of each batch element's cache (a new
      tensor; the old cache is left as it was), then the token attends
      over the cache;
    * ``s > 1`` with a cache: a prefill into an allocated cache — causal
      attention over the prompt, k and v padded with zeros to S.

    ``cfg.nope`` leaves out RoPE; ``cfg.attention_multiplier``, where set,
    scales the scores in place of ``head_dim ** -0.5``.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope_theta and not cfg.nope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    softcap = cfg.attn_logit_softcap
    window = None if cfg.attention == "full" else cfg.window
    scale = cfg.attention_multiplier or None
    if cache is None:
        out = _prefill_attention(q, k, v, softcap=softcap, window=window,
                                 scale=scale)
        new_cache = {"k": k, "v": v}
    elif s == 1:
        rows = torch.arange(b, device=x.device)
        idx = (rows, pos.long())
        kc = cache["k"].index_put(idx, k[:, 0])
        vc = cache["v"].index_put(idx, v[:, 0])
        out = decode_attention(q, kc, vc, pos, softcap=softcap,
                               window=window, scale=scale)
        new_cache = {"k": kc, "v": vc}
    else:
        out = _prefill_attention(q, k, v, softcap=softcap, window=window,
                                 scale=scale)
        widths = (0, 0, 0, 0, 0, cache["k"].shape[1] - s)
        new_cache = {"k": pad(k, widths), "v": pad(v, widths)}
    out = _merge_heads(out) @ p["wo"].to(cfg.cdtype)
    return constrain(out, *cfg.residual_spec), new_cache


# ----------------------------------------------------------------- MLPs ----


def init_mlp(gen: torch.Generator, cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    s = d ** -0.5
    if cfg.mlp == "gelu":
        return {"w1": normal_init(gen, (d, ff), cfg.pdtype, s),
                "w2": normal_init(gen, (ff, d), cfg.pdtype, ff ** -0.5)}
    return {"w1": normal_init(gen, (d, ff), cfg.pdtype, s),
            "w3": normal_init(gen, (d, ff), cfg.pdtype, s),
            "w2": normal_init(gen, (ff, d), cfg.pdtype, ff ** -0.5)}


def mlp_apply(p, x, cfg) -> torch.Tensor:
    """Dense MLP, or the pruned one when ``p`` holds SparseLinear layers."""
    if callable(p.get("w1")):
        from repro_torch.models.sparse import sparse_mlp_apply
        return sparse_mlp_apply(p, x, cfg)
    dt = cfg.cdtype
    if "w3" in p:
        h = F.silu(x @ p["w1"].to(dt)) * (x @ p["w3"].to(dt))
    else:
        h = F.gelu(x @ p["w1"].to(dt), approximate="tanh")
    if cfg.tp:
        h = constrain(h, "dp", None, "model")     # the ff dim over model
    else:
        h = constrain(h, "dpm", None, None)
    return constrain(h @ p["w2"].to(dt), *cfg.residual_spec)
