"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), the
reference's ``repro.models.rglru``.

    r_t = σ(w_a ⊙ x_t)                 recurrence gate
    i_t = σ(w_x ⊙ x_t)                 input gate
    a_t = exp(-c · softplus(Λ) · r_t)   c = 8
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

A prefill runs the recurrence as a log-depth doubling scan (⌈log₂ s⌉
steps of whole-sequence tensor ops, where the reference runs
``lax.associative_scan``); decode is the O(1) recurrence step.  The block
follows Griffin: two input branches (the recurrent path with a causal
conv, the gating path with GELU), multiplied and projected out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import causal_conv, normal_init

_C = 8.0


def init_rglru(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = gen.device
    s = d ** -0.5
    # Λ so that a ∈ (0.9, 0.999) at r = 1 (Griffin §2.4)
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, w, dtype=torch.float32, device=dev)) / _C))
    return {
        "wx_in": normal_init(gen, (d, w), cfg.pdtype, s),
        "wg_in": normal_init(gen, (d, w), cfg.pdtype, s),
        "conv": normal_init(gen, (cfg.conv_width, w), cfg.pdtype, 0.1),
        "gate_a": torch.zeros(w, dtype=torch.float32, device=dev),
        "gate_x": torch.zeros(w, dtype=torch.float32, device=dev),
        "lam": lam,
        "out": normal_init(gen, (w, d), cfg.pdtype, w ** -0.5),
    }


def _gates(p, x):
    """(a, b) of the recurrence h = a·h + b, f32."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(xf * p["gate_a"])
    i = torch.sigmoid(xf * p["gate_x"])
    log_a = -_C * F.softplus(p["lam"]) * r              # (..., w), ≤ 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xf)
    return a, b


def linear_scan(a, b):
    """h_t = a_t·h_{t-1} + b_t from h_{-1} = 0, along axis 1: the
    inclusive scan of (a, b) under (a₁, b₁)∘(a₂, b₂) = (a₂a₁, a₂b₁ + b₂),
    by doubling (Hillis–Steele): ⌈log₂ s⌉ steps, each combining every
    element with the one 2^j before it."""
    s = a.shape[1]
    k = 1
    while k < s:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def rglru_apply(p, x, cfg, *, state=None):
    """x (b, s, d) → (out, new_state); state = {"conv", "h"}.  A prefill
    (``state=None``) scans the whole sequence; decode (s == 1) steps from
    ``state``."""
    dt = x.dtype
    xr = x @ p["wx_in"].to(dt)                          # recurrent branch
    xg = F.gelu(x @ p["wg_in"].to(dt), approximate="tanh")   # gating branch
    if state is None:
        xr, conv_state = causal_conv(xr, p["conv"].to(dt))
        a, b = _gates(p, xr)
        h = linear_scan(a, b)
    else:
        xr, conv_state = causal_conv(xr, p["conv"].to(dt),
                                     state["conv"])
        a, b = _gates(p, xr)
        h = a * state["h"][:, None] + b                 # (b, 1, w)
    y = (h.to(dt) * xg) @ p["out"].to(dt)
    return y, {"conv": conv_state, "h": h[:, -1]}


def init_rglru_state(cfg, batch: int, device,
                     dtype=torch.float32) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }
