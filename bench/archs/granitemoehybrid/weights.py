"""The granitemoehybrid weights of a configuration, made on the device from
the seed.

One ``torch.Generator`` on the device draws every tensor of a kind for all
the layers that have it in one call (a stacked tensor whose per-layer rows
are views), in a fixed order, in float32, the configuration's parameter
dtype.  The benchmark hands these tensors to the program and makes them
again from the same seed for the reference, once the program's state is
freed.

Layout (``x @ W`` throughout): ``embed`` (V, d), ``unembed`` (V, d) when
the embeddings are untied, ``final_norm`` (d,), and ``layers``, one dict a
layer.  Every layer: ``ln1``/``ln2`` (d,) and the SwiGLU ``shared_mlp``,
``w1`` (gate) / ``w3`` (up) (d, ff), ``w2`` (down) (ff, d).  An attention
layer: ``wq`` (d, H·dh), ``wk``/``wv`` (d, KV·dh), ``wo`` (H·dh, d).  A
Mamba2 layer, with ``di = mamba_expand · d`` and ``c = di + 2·N`` (one
group of B and C): ``in_proj`` (d, 2·di + 2·N + heads) in the order z, x,
B, C, dt; ``conv`` (width, c) and ``conv_bias`` (c,); ``a_log``,
``dt_bias``, ``d_skip`` (heads,); ``norm`` (di,), the gated RMSNorm's
scale; ``out_proj`` (di, d).

The Mamba2 parameters take Mamba2's published initialisation (the
``mamba_ssm`` package's): ``A = -exp(a_log)`` with ``exp(a_log) ~ U(1,
16)``, ``dt_bias`` the inverse softplus of a dt log-uniform in [1e-3,
0.1], ``D = 1``; the conv and its bias PyTorch's ``Conv1d`` default,
U(-1/√width, 1/√width).  So some heads decay over thousands of steps and
the state carries from chunk to chunk.
"""
from __future__ import annotations

import math

import torch

NORM_JITTER = 0.1      # norm scales 1 + 0.1·N(0, 1), so a dropped scale shows
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 0.1)
# The keys the CPU tests cut, to these values (bench/tests/conftest.py): 4
# layers, the third attention, 8 heads of 16 with d_state 16, chunks of 8.
SMOKE = dict(num_hidden_layers=4, hidden_size=64, intermediate_size=128,
             shared_intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, vocab_size=512, mamba_n_heads=8,
             mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=8,
             layer_types=["mamba", "mamba", "attention", "mamba"])


def kinds(cfg: dict) -> list[str]:
    """Each layer's kind, ``mamba`` or ``attention``, in layer order."""
    out = list(cfg["layer_types"])
    if len(out) != cfg["num_hidden_layers"] or \
            set(out) - {"mamba", "attention"}:
        raise ValueError(f"{cfg['name']}: layer_types {out} for "
                         f"{cfg['num_hidden_layers']} layers")
    return out


def mamba_dims(cfg: dict) -> tuple[int, int, int, int]:
    """``(di, heads, head_dim, d_state)`` of the Mamba2 mixer."""
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    heads, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    if heads * p != di or cfg["mamba_n_groups"] != 1:
        raise ValueError(f"{cfg['name']}: {heads} heads of {p} for "
                         f"d_inner {di}, {cfg['mamba_n_groups']} groups")
    return di, heads, p, cfg["mamba_d_state"]


def shapes(cfg: dict) -> dict:
    """``name → (kind or None for every layer, shape)``."""
    d, ff = cfg["hidden_size"], cfg["shared_intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // h
    di, heads, _, n = mamba_dims(cfg)
    c, w = di + 2 * n, cfg["mamba_d_conv"]
    return {"ln1": (None, (d,)), "ln2": (None, (d,)),
            "w1": (None, (d, ff)), "w3": (None, (d, ff)),
            "w2": (None, (ff, d)),
            "wq": ("attention", (d, h * dh)),
            "wk": ("attention", (d, kv * dh)),
            "wv": ("attention", (d, kv * dh)),
            "wo": ("attention", (h * dh, d)),
            "in_proj": ("mamba", (d, 2 * di + 2 * n + heads)),
            "conv": ("mamba", (w, c)), "conv_bias": ("mamba", (c,)),
            "a_log": ("mamba", (heads,)), "dt_bias": ("mamba", (heads,)),
            "d_skip": ("mamba", (heads,)), "norm": ("mamba", (di,)),
            "out_proj": ("mamba", (di, d))}


def make(cfg: dict, seed: int, device) -> dict:
    """Every weight of ``cfg`` from ``seed`` on ``device``, float32."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    if cfg["attention_bias"] or cfg["mamba_proj_bias"] or \
            not cfg["mamba_conv_bias"]:
        raise ValueError(f"{cfg['name']}: the weights have no projection "
                         "bias and a conv bias")
    layer_kinds = kinds(cfg)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)

    def normal(shape, std):
        return torch.randn(shape, **f32).mul_(std)

    def uniform(shape, lo, hi):
        return torch.rand(shape, **f32).mul_(hi - lo).add_(lo)

    w = {"embed": normal((v, d), d ** -0.5)}
    if not cfg["tie_word_embeddings"]:
        w["unembed"] = normal((v, d), d ** -0.5)
    w["final_norm"] = normal((d,), NORM_JITTER).add_(1.0)
    w["layers"] = [{} for _ in layer_kinds]
    width = cfg["mamba_d_conv"] ** -0.5
    for name, (kind, shape) in shapes(cfg).items():
        rows = [i for i, k in enumerate(layer_kinds) if kind in (None, k)]
        stack = (len(rows), *shape)
        if name in ("ln1", "ln2", "norm"):
            t = normal(stack, NORM_JITTER).add_(1.0)
        elif name in ("conv", "conv_bias"):
            t = uniform(stack, -width, width)
        elif name == "a_log":
            t = uniform(stack, *A_RANGE).log_()
        elif name == "dt_bias":
            lo, hi = (math.log(x) for x in DT_RANGE)
            dt = uniform(stack, lo, hi).exp_()
            t = dt + torch.log(-torch.expm1(-dt))      # softplus⁻¹(dt)
        elif name == "d_skip":
            t = torch.ones(stack, dtype=torch.float32, device=device)
        else:
            t = normal(stack, shape[0] ** -0.5)
        for j, i in enumerate(rows):
            w["layers"][i][name] = t[j]
    return w
