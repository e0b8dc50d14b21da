"""The plain reference: a pruned-FFN dense decoder scoring one prompt at a
time, in plain PyTorch, float32 arithmetic with TF32 off.

It imports nothing of the program and takes nothing the program made: it
is given the dense weights (``weights.make``) and the prompts, prunes each
FFN weight again itself (the ``keep`` largest magnitudes of every row of
the weight as the SpMM reads it, ``C = Wᵀ @ xᵀ``), and runs each request
alone, unpadded.  The model is the configuration's as run: RMSNorm, GQA
attention with half-split RoPE and optional QKV bias, causal softmax at
``head_dim ** -0.5``, a SwiGLU FFN, residual adds, the logits against
``unembed`` (or the tied ``embed``).

Everything is computed in float32: the configuration's lower compute
precision (bfloat16) is the program's business, and the comparison's
limits leave room for it.  ``score(..., control=True)`` is the control
that the comparison has to fail: the same model one step below each
precision the configuration states, float8 e4m3 (a per-tensor scale)
where it computes in bfloat16 (each activation a layer hands on, each
dense projection's weight and output) and bfloat16 where it states
float32 (the pruned FFN's weights, the logits' operands).
``control="f32"`` lowers the float32 points alone, to bfloat16.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

F8_MAX = 448.0


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
    computes in its compute dtype, ``f32`` at those it states float32
    (the pruned FFN's weights, the logits' operands); no rounding at all
    in the reference itself."""

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


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x (s, heads, dh) at positions 0…s-1."""
    s, _, dh = x.shape
    half = dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal GQA attention: q (s, H, dh), k/v (s, KV, dh) → (s, H·dh)."""
    s, h, dh = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    sc = torch.einsum("qhd,khd->hqk", q, k) * dh ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(s, h * dh)


def layer(x, lw: dict, cfg: dict, prec: Precision):
    """One block over one request's activations x (s, d); ``lw`` holds the
    layer's weights as :func:`layer_weights` rounds and prunes them."""
    act = prec.act
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // h
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    s = x.shape[0]
    a = act(rms_norm(x, lw["ln1"], eps))

    def proj(name, bias):
        y = act(a @ lw[name])
        return act(y + lw[bias]) if bias in lw else y

    q = act(rope(proj("wq", "bq").reshape(s, h, dh), theta))
    k = act(rope(proj("wk", "bk").reshape(s, kv, dh), theta))
    v = proj("wv", "bv").reshape(s, kv, dh)
    o = act(attention(q, k, v))
    x = act(x + act(o @ lw["wo"]))
    a = act(rms_norm(x, lw["ln2"], eps))
    gate = act(a @ lw["w1"])
    up = act(a @ lw["w3"])
    f = act(act(torch.nn.functional.silu(gate) * up) @ lw["w2"])
    return act(x + f)


def layer_weights(lw: dict, cfg: dict, prec: Precision) -> dict:
    """A layer's weights as the forward uses them: the dense projections
    and biases rounded to the compute precision, each FFN weight pruned
    and rounded to the float32 points' precision, the norm scales as
    they are."""
    out = {}
    for name, t in lw.items():
        if name in ("w1", "w3", "w2"):
            out[name] = prec.f32(prune(t, cfg["keep"]))
        elif name.startswith("ln"):
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
        xs = [prec.act(embed[t]) for t in prompts]
        for lw in w["layers"]:
            lw = layer_weights(lw, cfg, prec)
            xs = [layer(x, lw, cfg, prec) for x in xs]
            del lw
        head = prec.f32(w.get("unembed", embed))
        out = []
        for i, x in enumerate(xs):
            h = prec.act(rms_norm(x, w["final_norm"], cfg["rms_norm_eps"]))
            logits = h @ head.t()
            if on_logits is None:
                out.append(logits)
            else:
                on_logits(i, logits)
            xs[i] = None
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was
