"""The dense weights of a configuration, made on the device from the seed.

One ``torch.Generator`` on the device draws every tensor of a kind for
all layers in one call (a stacked tensor whose per-layer rows are views),
in a fixed order, in float32, the configuration's parameter dtype.  The
benchmark hands these tensors to the program and makes them again from the
same seed for the reference, once the program's state is freed.

Layout (``x @ W`` throughout): ``embed`` (V, d), ``unembed`` (V, d) when
the embeddings are untied, ``final_norm`` (d,), and ``layers``, one dict a
layer: ``ln1``/``ln2`` (d,), ``wq`` (d, H·dh), ``wk``/``wv`` (d, KV·dh),
``wo`` (H·dh, d), with QKV bias ``bq``/``bk``/``bv``, and the SwiGLU FFN
``w1`` (gate) / ``w3`` (up) (d, ff), ``w2`` (down) (ff, d).
"""
from __future__ import annotations

import torch

NORM_JITTER = 0.1      # norm scales 1 + 0.1·N(0, 1), so a dropped scale shows
BIAS_STD = 0.1
# The keys the CPU tests cut, to these values (bench/tests/conftest.py).
SMOKE = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
             num_attention_heads=4, num_key_value_heads=2, vocab_size=512)


def shapes(cfg: dict) -> dict:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // h
    out = {"ln1": (d,), "wq": (d, h * dh), "wk": (d, kv * dh),
           "wv": (d, kv * dh), "wo": (h * dh, d), "ln2": (d,),
           "w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}
    if cfg.get("attention_bias"):
        out.update(bq=(h * dh,), bk=(kv * dh,), bv=(kv * dh,))
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """Every weight of ``cfg`` from ``seed`` on ``device``, float32."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    d, v, n = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    f32 = dict(dtype=torch.float32, device=device, generator=gen)

    def normal(shape, std):
        return torch.randn(shape, **f32).mul_(std)

    w = {"embed": normal((v, d), d ** -0.5)}
    if not cfg["tie_word_embeddings"]:
        w["unembed"] = normal((v, d), d ** -0.5)
    w["final_norm"] = normal((d,), NORM_JITTER).add_(1.0)
    stacks = {}
    for name, shape in shapes(cfg).items():
        if name.startswith("ln"):
            stacks[name] = normal((n, *shape), NORM_JITTER).add_(1.0)
        elif name.startswith("b"):
            stacks[name] = normal((n, *shape), BIAS_STD)
        else:
            stacks[name] = normal((n, *shape), shape[0] ** -0.5)
    w["layers"] = [{k: s[i] for k, s in stacks.items()} for i in range(n)]
    return w
