"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block, the
reference's ``repro.models.ssm``.

Chunked SSD: inside a chunk the recurrence is computed in its
"attention" (quadratic) dual form; states pass between chunks by a linear
recurrence.  O(s·q) work, O(1)-state decode.

Recurrence (per head, diagonal A):
    h_t = exp(Δ_t A) · h_{t-1} + Δ_t · B_t ⊗ x_t
    y_t = C_t · h_t + D · x_t

Two port-only options of the config (``configs.base.HybridConfig``) make
it the mixer of Bamba / GraniteMoeHybrid: ``ssm_conv_bias`` adds a bias to
the causal conv before its SiLU, and ``ssm_gated_norm`` replaces the gate
``y · silu(z)`` by ``rmsnorm(y · silu(z)) · w`` over all ``d_inner``
channels (one group) at ``norm_eps``, in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import on_every_rank
from repro_torch.distributed.sharding import pad as zpad

from .layers import causal_conv, normal_init


def init_ssd(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    din = cfg.ssm_expand * d
    heads = din // cfg.ssm_head_dim
    n = cfg.ssm_state
    dev = gen.device
    p = {
        # fused input projection: [z (din), x (din), B (n), C (n), dt (heads)]
        "in_proj": normal_init(gen, (d, 2 * din + 2 * n + heads),
                               cfg.pdtype, d ** -0.5),
        "conv": normal_init(gen, (cfg.conv_width, din + 2 * n), cfg.pdtype,
                            0.1),
        "a_log": torch.log(torch.linspace(1.0, 16.0, heads,
                                          dtype=torch.float32, device=dev)),
        "d_skip": torch.ones(heads, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(heads, dtype=torch.float32, device=dev),
        "out_proj": normal_init(gen, (din, d), cfg.pdtype, din ** -0.5),
    }
    if cfg.ssm_conv_bias:
        p["conv_bias"] = torch.zeros(din + 2 * n, dtype=cfg.pdtype,
                                     device=dev)
    if cfg.ssm_gated_norm:
        p["norm"] = torch.ones(din, dtype=torch.float32, device=dev)
    return p


def _split_proj(p, u, cfg):
    d = cfg.d_model
    din = cfg.ssm_expand * d
    n = cfg.ssm_state
    heads = din // cfg.ssm_head_dim
    zxbcdt = u @ p["in_proj"].to(u.dtype)
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * n, heads], dim=-1)
    return z, xbc, dt, din, n, heads


def _causal_conv(xbc, conv, state=None, bias=None):
    """Depthwise causal conv along the sequence, plus ``bias`` (c,) when
    given, then SiLU.  xbc (b, s, c), conv (w, c); ``state`` (b, w-1, c)
    holds the trailing inputs for decode.  Returns (out, new_state)."""
    out, new_state = causal_conv(xbc, conv, state)
    if bias is not None:
        out = out + bias
    return F.silu(out), new_state


def _gate(y, z, p, cfg, dtype):
    """y (f32) gated by silu(z), in ``dtype``: ``y · silu(z)``, or with
    ``ssm_gated_norm`` the gated RMSNorm ``rmsnorm(y · silu(z)) · w``
    computed in f32 and rounded once."""
    gate = F.silu(z.to(torch.float32))
    if not cfg.ssm_gated_norm:
        return y.to(dtype) * gate.to(dtype)
    g = y * gate
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)
    return (g * p["norm"]).to(dtype)


def _mac(t, mac):
    """``t`` rounded to the compute dtype, as f32: the reference's einsums
    take ``mac``-dtype operands and accumulate in f32, so the port
    multiplies their exact values in f32."""
    return t.to(mac).to(torch.float32)


def ssd_scan_chunked(x, dt, a, b, c, *, chunk: int, mac_dtype=None):
    """Chunked SSD.  x (B, S, H, P), dt (B, S, H) (after the softplus), a
    (H,) < 0, b/c (B, S, N), S a multiple of ``chunk``.  Returns
    (y (B, S, H, P), final_state (B, H, P, N)).

    The O(L²·H) decay, the scores and x enter the intra-chunk products
    rounded to ``mac_dtype`` (the compute dtype), with f32 sums."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    mac = mac_dtype or x.dtype
    xc = x.reshape(bs, nc, chunk, h, p)
    dtc = dt.reshape(bs, nc, chunk, h)
    bc = b.reshape(bs, nc, chunk, n)
    cc = c.reshape(bs, nc, chunk, n)

    da = dtc * a                                        # (B,nc,L,H) log-decay
    cum = torch.cumsum(da, dim=2)                       # within-chunk
    # intra-chunk (the dual, attention form):
    #   y_t = Σ_{u<=t} C_t·B_u exp(cum_t - cum_u) Δ_u x_u
    # masked in log space before the exp: masking after it (exp(+big)·0)
    # gives NaN in the backward.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    diff = torch.where(mask[None, None, :, :, None], diff, float("-inf"))
    decay = _mac(torch.exp(diff), mac)                  # (B,nc,L,L,H)
    xm = _mac(xc, mac)
    scores = torch.einsum("bcln,bcmn->bclm", _mac(cc, mac), _mac(bc, mac))
    w = _mac(scores, mac)[..., None] * decay * _mac(dtc, mac)[:, :, None]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", w, xm)

    # chunk states: S_c = Σ_u exp(cum_L - cum_u) Δ_u B_u ⊗ x_u
    chunk_decay = torch.exp(cum[:, :, -1:, :] - cum)   # (B,nc,L,H)
    states = torch.einsum("bclhp,bcln->bchpn",
                          _mac(dtc * chunk_decay, mac)[..., None] * xm,
                          _mac(bc, mac))                # (B,nc,H,P,N)
    total = torch.exp(cum[:, :, -1])                    # (B,nc,H)

    st = torch.zeros((bs, h, p, n), dtype=x.dtype, device=x.device)
    prev = []
    for ci in range(nc):
        prev.append(st)
        st = st * total[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)              # (B,nc,H,P,N)

    # inter-chunk: y_t += C_t · exp(cum_t) · S_{c-1}
    y_inter = torch.einsum("bcln,bchpn->bclhp", cc, prev_states) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bs, s, h, p)
    return y, st


def ssd_apply(p, u, cfg, *, state=None):
    """u (b, s, d) → (out, new_state).  A prefill or training:
    ``state=None``.  Decode: s == 1 with state = {"conv": (b, w-1, c),
    "ssm": (b, H, P, N)}.

    Over a mesh the block runs with its operands whole on every rank: the
    backward of its scan's cumulative sums calls aten.flip, which has no
    DTensor sharding rule (torch 2.11)."""
    if isinstance(u, DTensor):
        return on_every_rank(
            lambda p_, u_, st: ssd_apply(p_, u_, cfg, state=st), p, u, state)
    z, xbc, dt, din, n, heads = _split_proj(p, u, cfg)
    hd = cfg.ssm_head_dim
    a = -torch.exp(p["a_log"])
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    bias = p.get("conv_bias")
    if bias is not None:
        bias = bias.to(xbc.dtype)

    if state is None:
        xbc, conv_state = _causal_conv(xbc, p["conv"].to(xbc.dtype),
                                       bias=bias)
        x, b, c = torch.split(xbc, [din, n, n], dim=-1)
        bs, s, _ = x.shape
        xh = x.reshape(bs, s, heads, hd)
        # pad the sequence to a chunk multiple with identity steps (dt = 0:
        # decay 1, no state update), so the final state is exact
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk
        y, ssm_state = ssd_scan_chunked(
            zpad(xh.to(torch.float32), (0, 0, 0, 0, 0, pad)),
            zpad(dt, (0, 0, 0, pad)), a,
            zpad(b.to(torch.float32), (0, 0, 0, pad)),
            zpad(c.to(torch.float32), (0, 0, 0, pad)), chunk=chunk,
            mac_dtype=cfg.cdtype)
        y = y[:, :s]
        y = y + p["d_skip"][None, None, :, None] * xh.to(torch.float32)
        y = y.reshape(bs, s, din)
    else:
        xbc, conv_state = _causal_conv(xbc, p["conv"].to(xbc.dtype),
                                       state["conv"], bias)
        x, b, c = torch.split(xbc, [din, n, n], dim=-1)
        bs = x.shape[0]
        xh = x.reshape(bs, heads, hd).to(torch.float32)
        dt1 = dt[:, 0]                                  # (b, H)
        decay = torch.exp(dt1 * a[None])                # (b, H)
        db_x = torch.einsum("bh,bn,bhp->bhpn", dt1,
                            b[:, 0].to(torch.float32), xh)
        ssm_state = state["ssm"] * decay[..., None, None] + db_x
        y = torch.einsum("bn,bhpn->bhp", c[:, 0].to(torch.float32),
                         ssm_state)
        y = y + p["d_skip"][None, :, None] * xh
        y = y.reshape(bs, 1, din)

    y = _gate(y, z, p, cfg, u.dtype)
    out = y @ p["out_proj"].to(u.dtype)
    return out, {"conv": conv_state, "ssm": ssm_state}


def init_ssd_state(cfg, batch: int, device, dtype=torch.float32) -> dict:
    d = cfg.d_model
    din = cfg.ssm_expand * d
    heads = din // cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1,
                             din + 2 * cfg.ssm_state), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }
