"""Transformer building blocks for Llama-style prefill: RMSNorm, RoPE,
causal GQA attention and the SwiGLU MLP.

Pure functions over plain dicts of tensors, in the reference's layouts
(``repro.models.layers``): weights are ``(d_in, d_out)`` and used as
``x @ W``.  ``init_*`` draw from a ``torch.Generator`` on the target
device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------- norms ----


def init_norm(d: int, kind: str, dtype, device) -> dict:
    if kind != "rmsnorm":
        raise ValueError(f"norm {kind!r} is not ported yet (rmsnorm only)")
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def norm_apply(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: statistics in f32, elementwise math in the input dtype
    (the reference's cast order)."""
    if kind != "rmsnorm":
        raise ValueError(f"norm {kind!r} is not ported yet (rmsnorm only)")
    ms = torch.mean(torch.square(x.to(torch.float32)), -1, keepdim=True)
    y = x * torch.rsqrt(ms + eps).to(x.dtype)
    return y * p["scale"].to(x.dtype)


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


def causal_attention(q, k, v, *, softcap: float = 0.0) -> torch.Tensor:
    """Causal GQA attention over a whole prefill.  q (b, s, h, dh), k/v
    (b, s, kv, dh) → (b, s, h, dh) in q's dtype.

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
    sc = torch.where(mask, sc, float("-inf"))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    denom = p.sum(-1)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    # (b, kv, g, s, dh) -> (b, s, kv*g, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def attention_apply(p, x, cfg) -> torch.Tensor:
    """Causal self-attention of a prefill with no KV cache.  x (b, s, d)."""
    if cfg.attention != "full":
        raise ValueError(f"attention {cfg.attention!r} is not ported yet")
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = causal_attention(q, k, v, softcap=cfg.attn_logit_softcap)
    return out.reshape(b, s, -1) @ p["wo"].to(cfg.cdtype)


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
