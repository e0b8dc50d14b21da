"""The dense architecture's operations: a decoder of attention and pruned
SwiGLU FFN layers, counted from the configuration's shapes."""
from __future__ import annotations

import counts


def spmm_launches(cfg: dict) -> list[tuple[int, int, int]]:
    """The ``(m, k, nnz)`` of every row-split launch of one forward, in
    launch order: each layer's FFN matrices (w1, w3, w2), layer by
    layer."""
    one = [(m, k, nnz) for _, m, k, nnz in counts.ffn_matrices(cfg)]
    return one * cfg["num_hidden_layers"]


def request_flops(cfg: dict, length: int) -> float:
    """Model FLOPs of scoring one prompt of ``length`` tokens: the sparse
    FFN at 2·nnz a token, the attention projections at 2·params a token
    (biases not counted), causal attention (QKᵀ and PV over the keys at or
    before each query), and the logits at 2·d·V a token."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // h
    proj = d * h * dh * 2 + d * kv * dh * 2
    ffn = sum(nnz for *_, nnz in counts.ffn_matrices(cfg))
    pairs = length * (length + 1) // 2
    attn = 2 * 2 * h * dh * pairs
    per_layer = 2 * (proj + ffn) * length + attn
    return cfg["num_hidden_layers"] * per_layer + 2.0 * d * v * length
