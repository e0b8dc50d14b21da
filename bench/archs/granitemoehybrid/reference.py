"""The plain reference of the granitemoehybrid architecture (IBM's Granite
4.0-H, HF ``GraniteMoeHybridForCausalLM`` without experts) with every
layer's ``shared_mlp`` pruned, scoring one prompt at a time in plain
PyTorch, float32 arithmetic with TF32 off.

It imports nothing of the program and takes nothing the program made: it
is given the dense weights (``weights.make``) and the prompts, prunes each
FFN weight again itself (the ``keep`` largest magnitudes of every row of
the weight as the SpMM reads it, ``C = Wᵀ @ xᵀ``), and runs each request
alone, unpadded.  The model, from the configuration's keys:

* the embedding times ``embedding_multiplier``;
* each layer: x + m·mixer(rmsnorm(x)), then x + m·mlp(rmsnorm(x)), with
  m the ``residual_multiplier`` and every RMSNorm at ``rms_norm_eps``;
* the mixer of a ``mamba`` layer: ``in_proj`` to z, x, B, C, dt; a
  depthwise causal conv with its bias over x, B, C, then SiLU; dt =
  softplus(dt + dt_bias), A = -exp(A_log); per head the recurrence
  h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t⊗B_t, y_t = h_t·C_t + D·x_t (B and C
  one group for all heads); the gated RMSNorm rmsnorm(y·silu(z))·w over
  all d_inner channels; ``out_proj``;
* the mixer of an ``attention`` layer: GQA with no positions (NoPE),
  causal softmax of the scores times ``attention_multiplier``;
* the SwiGLU MLP; the final RMSNorm; the logits against the tied
  ``embed`` divided by ``logits_scaling``.

The recurrence is evaluated in blocks of ``BLOCK`` steps
(:func:`ssd_blocks`): inside a block each output sums the block's earlier
inputs directly, and the state carried in from the blocks before; the
step-by-step loop (:func:`ssd_loop`) is the definition, against which the
tests hold the blocks.

Everything is computed in float32, the rounding points of ``Precision``
aside, as ``archs/dense/reference.py`` places them: ``score(...,
control=True)`` is the same model one step below each precision the
configuration states (float8 e4m3 for bfloat16, bfloat16 for float32),
which the comparison has to fail; ``control="f32"`` lowers the float32
points alone.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch
import torch.nn.functional as F

F8_MAX = 448.0
# Steps of the recurrence a block (the program's chunk is the config's,
# 256 as published).
BLOCK = 64


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _to(dtype) -> Callable:
    def rnd(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype).to(torch.float32)
    return rnd


def _f8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 under a per-tensor scale (amax to 448)."""
    s = x.abs().amax().clamp(min=1e-30) / F8_MAX
    return (x / s).clamp(-F8_MAX, F8_MAX).to(torch.float8_e4m3fn).to(
        torch.float32) * s


@dataclasses.dataclass(frozen=True)
class Precision:
    """Where values are rounded: ``act`` at the points the configuration
    computes in its compute dtype, ``f32`` at those it computes in
    float32 (the pruned FFN's weights, the logits' operands, the scan's
    summed decay, its outputs and the state it carries, the gated norm);
    no rounding at all in the reference itself."""

    act: Callable
    f32: Callable

    @classmethod
    def of(cls, cfg: dict, control: bool | str = False) -> Precision:
        """No rounding; with ``control`` every stated precision one step
        lower, or with ``control="f32"`` the float32 points alone."""
        if not control:
            return cls(act=_identity, f32=_identity)
        lower = {"float32": _to(torch.bfloat16), "bfloat16": _f8,
                 "float16": _f8}
        act = (_identity if control == "f32"
               else lower[cfg["compute_dtype"]])
        return cls(act=act, f32=lower["float32"])


def prune(w: torch.Tensor, keep: float) -> torch.Tensor:
    """``w`` (d_in, d_out) with all but the ``round(keep · d_in)`` largest
    magnitudes of each output column zeroed (each row of ``wᵀ``, the
    matrix the SpMM reads)."""
    wt = w.t()
    k = max(1, min(int(round(keep * wt.shape[1])), wt.shape[1]))
    idx = torch.topk(wt.abs(), k, dim=1, sorted=False).indices
    out = torch.zeros_like(wt)
    out.scatter_(1, idx, torch.gather(wt, 1, idx))
    return out.t()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def ssd_loop(x, dt, a, b, c, rnd: Callable = _identity) -> torch.Tensor:
    """The recurrence one step at a time: x (s, H, P), dt (s, H), a (H,),
    b/c (s, N) → y (s, H, P), the D term left out; the state and each
    output rounded by ``rnd``."""
    s, h, p = x.shape
    state = torch.zeros(h, p, b.shape[-1], dtype=x.dtype, device=x.device)
    ys = []
    for t in range(s):
        state = rnd(state * torch.exp(dt[t] * a)[:, None, None]
                    + (dt[t][:, None] * x[t])[:, :, None] * b[t])
        ys.append(rnd(state @ c[t]))
    return torch.stack(ys)


def ssd_blocks(x, dt, a, b, c, block: int = BLOCK,
               rnd: Callable = _identity) -> torch.Tensor:
    """:func:`ssd_loop` in blocks of ``block`` steps.  With ``g_t`` the
    summed log decay ``Σ dt·a`` from the block's start through step t, an
    output is C_t·(Σ_{u≤t} e^{g_t−g_u} dt_u x_u⊗B_u + e^{g_t} h_in), and
    the state handed on is e^{g_L} h_in + Σ_u e^{g_L−g_u} dt_u x_u⊗B_u;
    ``rnd`` rounds g, each block's outputs and the state handed on."""
    s, h, p = x.shape
    state = torch.zeros(h, p, b.shape[-1], dtype=x.dtype, device=x.device)
    out = []
    for t0 in range(0, s, block):
        xs, dts = x[t0:t0 + block], dt[t0:t0 + block]
        bs, cs = b[t0:t0 + block], c[t0:t0 + block]
        n = xs.shape[0]
        g = rnd(torch.cumsum(dts * a, dim=0))                   # (n, H)
        lag = g[:, None, :] - g[None, :, :]                     # (t, u, H)
        seen = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        lag = lag.masked_fill(~seen[:, :, None], float("-inf"))
        mix = (cs @ bs.t())[:, :, None] * torch.exp(lag) * dts[None]
        y = torch.einsum("tuh,uhp->thp", mix, xs)
        y = y + torch.einsum("tn,hpn->thp", cs, state) \
            * torch.exp(g)[:, :, None]
        out.append(rnd(y))
        tail = torch.exp(g[-1][None, :] - g) * dts              # (u, H)
        state = rnd(state * torch.exp(g[-1])[:, None, None]
                    + torch.einsum("uh,uhp,un->hpn", tail, xs, bs))
    return torch.cat(out)


def mamba_mixer(a, lw: dict, cfg: dict, prec: Precision, *,
                scan: Callable = ssd_blocks):
    """The Mamba2 mixer over one request's normed activations a (s, d)."""
    act = prec.act
    d = cfg["hidden_size"]
    di = cfg["mamba_expand"] * d
    heads, hp = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    n, eps = cfg["mamba_d_state"], cfg["rms_norm_eps"]
    s = a.shape[0]
    z, xbc, dt = torch.split(act(a @ lw["in_proj"]), [di, di + 2 * n, heads],
                             dim=-1)
    conv = lw["conv"]
    width = conv.shape[0]
    padded = torch.cat([xbc.new_zeros(width - 1, xbc.shape[1]), xbc])
    xbc = sum(padded[i:i + s] * conv[i] for i in range(width))
    xbc = act(F.silu(act(xbc + lw["conv_bias"])))
    x, b, c = torch.split(xbc, [di, n, n], dim=-1)
    x = x.reshape(s, heads, hp)
    dt = F.softplus(dt + lw["dt_bias"])
    y = scan(x, dt, -torch.exp(lw["a_log"]), b, c, rnd=prec.f32)
    y = y + lw["d_skip"][None, :, None] * x
    g = prec.f32(rms_norm(prec.f32(y.reshape(s, di) * F.silu(z)),
                          lw["norm"], eps))
    return act(act(g) @ lw["out_proj"])


def attention_mixer(a, lw: dict, cfg: dict, prec: Precision):
    """Causal GQA attention with no positions over a (s, d): the scores
    times ``attention_multiplier``."""
    act = prec.act
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // h
    s = a.shape[0]
    q = act(a @ lw["wq"]).reshape(s, h, dh)
    k = act(a @ lw["wk"]).reshape(s, kv, dh).repeat_interleave(h // kv, 1)
    v = act(a @ lw["wv"]).reshape(s, kv, dh).repeat_interleave(h // kv, 1)
    sc = torch.einsum("qhd,khd->hqk", q, k) * cfg["attention_multiplier"]
    mask = torch.ones(s, s, dtype=torch.bool, device=a.device).tril()
    pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    o = act(torch.einsum("hqk,khd->qhd", pr, v).reshape(s, h * dh))
    return act(o @ lw["wo"])


def layer(x, lw: dict, kind: str, cfg: dict, prec: Precision):
    """One layer over one request's activations x (s, d); ``lw`` holds the
    layer's weights as :func:`layer_weights` rounds and prunes them."""
    act = prec.act
    eps, m = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    a = act(rms_norm(x, lw["ln1"], eps))
    mix = (mamba_mixer(a, lw, cfg, prec) if kind == "mamba"
           else attention_mixer(a, lw, cfg, prec))
    x = act(x + act(mix * m))
    a = act(rms_norm(x, lw["ln2"], eps))
    gate = act(a @ lw["w1"])
    up = act(a @ lw["w3"])
    f = act(act(F.silu(gate) * up) @ lw["w2"])
    return act(x + act(f * m))


# Kept as they are: norm scales and the scan's own float32 parameters.
AS_THEY_ARE = ("ln1", "ln2", "norm", "a_log", "dt_bias", "d_skip")


def layer_weights(lw: dict, cfg: dict, prec: Precision) -> dict:
    """A layer's weights as the forward uses them: each FFN weight pruned
    and rounded to the float32 points' precision, the dense projections,
    the conv and its bias rounded to the compute precision, the rest as
    they are."""
    out = {}
    for name, t in lw.items():
        if name in ("w1", "w3", "w2"):
            out[name] = prec.f32(prune(t, cfg["keep"]))
        elif name in AS_THEY_ARE:
            out[name] = t
        else:
            out[name] = prec.act(t)
    return out


@torch.no_grad()
def score(w: dict, cfg: dict, prompts: list, *,
          control: bool | str = False,
          on_logits: Callable | None = None) -> list:
    """Float32 logits (s, V) of each prompt (a 1-D int64 tensor on the
    weights' device), each run alone.  Layer by layer over all prompts,
    so each FFN weight is pruned once.  With ``on_logits(i, logits)`` each
    prompt's logits are handed over as soon as they exist and not kept."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        prec = Precision.of(cfg, control)
        embed = w["embed"]
        mult = cfg["embedding_multiplier"]
        xs = [prec.act(embed[t] * mult) for t in prompts]
        for kind, lw in zip(cfg["layer_types"], w["layers"]):
            lw = layer_weights(lw, cfg, prec)
            xs = [layer(x, lw, kind, cfg, prec) for x in xs]
            del lw
        head = prec.f32(w.get("unembed", embed))
        out = []
        for i, x in enumerate(xs):
            h = prec.act(rms_norm(x, w["final_norm"], cfg["rms_norm_eps"]))
            logits = (h @ head.t()) / cfg["logits_scaling"]
            if on_logits is None:
                out.append(logits)
            else:
                on_logits(i, logits)
            xs[i] = None
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was
