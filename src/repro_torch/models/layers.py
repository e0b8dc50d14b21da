"""Transformer building blocks: RMSNorm and LayerNorm, RoPE and
sinusoidal positions, causal GQA attention (full or windowed) over a
prefill, one-token attention against a KV cache, and the SwiGLU/GELU MLP.

Pure functions over plain dicts of tensors, in the reference's layouts
(``repro.models.layers``): weights are ``(d_in, d_out)`` and used as
``x @ W``.  ``init_*`` draw from a ``torch.Generator`` on the target
device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
        pad = F.pad(x, (0, 0, w - 1, 0))
    else:
        pad = torch.cat([state.to(x.dtype), x], dim=1)
    new_state = pad[:, -(w - 1):] if w > 1 else None
    out = sum(pad[:, i:i + x.shape[1]] * conv[i] for i in range(w))
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
    return (q.reshape(b, s, h, dh), k.reshape(b, s, kvh, dh),
            v.reshape(b, s, kvh, dh))


def causal_attention(q, k, v, *, softcap: float = 0.0,
                     window: int | None = None) -> torch.Tensor:
    """Causal GQA attention over a whole prefill.  q (b, s, h, dh), k/v
    (b, s, kv, dh) → (b, s, h, dh) in q's dtype.  ``window`` (sliding or
    local attention) also masks the keys ``window`` or more positions
    back: query t sees keys t - window + 1 … t.

    The reference's blockwise online softmax with one (query, key) block:
    scores in f32 from the inputs' exact f32 values, p cast to v's dtype
    before PV, the sum of p in f32.
    """
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, dh)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) \
        * dh ** -0.5
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    pos = torch.arange(s, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    sc = torch.where(mask, sc, float("-inf"))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    denom = p.sum(-1)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    # (b, kv, g, s, dh) -> (b, s, kv*g, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, *, softcap: float = 0.0,
                     window: int | None = None) -> torch.Tensor:
    """One-token attention against a cache.  q (b, 1, h, dh); caches
    (b, S, kv, dh); pos (b,) the current position (the number of tokens
    already in the cache).  Attends over the whole cache, masked to
    ``kpos <= pos`` and, with a ``window`` shorter than the cache, to
    ``kpos > pos - window``: the keys ``pos + 1 - window … pos``, the ones
    the reference slices out of the cache.

    The reference's numerics: scores from the inputs' exact f32 values
    (bf16 products are exact in f32), softmax in f32, p cast to v's dtype
    before PV, f32 sums, the output in q's dtype.
    """
    b, _, h, dh = q.shape
    s_cache, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, dh)
    sc = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) \
        * dh ** -0.5
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    kpos = torch.arange(s_cache, device=q.device)
    mask = kpos[None, :] <= pos[:, None]                     # (b, S)
    if window is not None and window < s_cache:
        mask &= kpos[None, :] > pos[:, None] - window
    sc = torch.where(mask[:, None, None], sc, float("-inf"))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


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
    """
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    softcap = cfg.attn_logit_softcap
    window = None if cfg.attention == "full" else cfg.window
    if cache is None:
        out = causal_attention(q, k, v, softcap=softcap, window=window)
        new_cache = {"k": k, "v": v}
    elif s == 1:
        rows = torch.arange(b, device=x.device)
        idx = (rows, pos.long())
        kc = cache["k"].index_put(idx, k[:, 0])
        vc = cache["v"].index_put(idx, v[:, 0])
        out = decode_attention(q, kc, vc, pos, softcap=softcap,
                               window=window)
        new_cache = {"k": kc, "v": vc}
    else:
        out = causal_attention(q, k, v, softcap=softcap, window=window)
        pad = (0, 0, 0, 0, 0, cache["k"].shape[1] - s)
        new_cache = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    out = out.reshape(b, s, -1) @ p["wo"].to(cfg.cdtype)
    return out, new_cache


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
    return h @ p["w2"].to(dt)
