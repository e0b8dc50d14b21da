"""The granitemoehybrid architecture's operations: Mamba2 and attention
mixers, each layer followed by its pruned SwiGLU ``shared_mlp``, counted
from the configuration's shapes for a prompt's own tokens (no padding)."""
from __future__ import annotations

import counts


def layer_kinds(cfg: dict) -> list[str]:
    """Each layer's kind, ``mamba`` or ``attention``, in launch order: a
    layer's mixer runs before its three row-split launches."""
    return list(cfg["layer_types"])


def spmm_launches(cfg: dict) -> list[tuple[int, int, int]]:
    """The ``(m, k, nnz)`` of every row-split launch of one forward, in
    launch order: each layer's FFN matrices (w1, w3, w2), layer by layer,
    the same list as a dense decoder's of the same FFN shapes."""
    one = [(m, k, nnz) for _, m, k, nnz in counts.ffn_matrices(cfg)]
    return one * cfg["num_hidden_layers"]


def causal_pairs(length: int, chunk: int) -> int:
    """(query, key) pairs at or below the diagonal inside each chunk of
    ``chunk`` tokens, the last chunk the prompt's remainder."""
    full, rest = divmod(length, chunk)
    return full * chunk * (chunk + 1) // 2 + rest * (rest + 1) // 2


def mamba_flops(cfg: dict, length: int) -> float:
    """One Mamba2 mixer over ``length`` tokens in chunks of
    ``mamba_chunk_size``: ``in_proj``; the depthwise conv; the scan —
    inside each chunk the C·Bᵀ scores (one group) and their weighted sums
    of x for every head, each token's x⊗B into its chunk's state, C times
    the state carried into each token's chunk, the state handed from chunk
    to chunk — and the D skip; the gated RMSNorm at 5 operations a channel
    (the gate's product, the square and its sum, the two scales); and
    ``out_proj``."""
    d = cfg["hidden_size"]
    di = cfg["mamba_expand"] * d
    heads, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    n, q = cfg["mamba_d_state"], cfg["mamba_chunk_size"]
    pairs = causal_pairs(length, q)
    chunks = -(-length // q)
    proj = 2 * d * (2 * di + 2 * n + heads) * length
    conv = 2 * cfg["mamba_d_conv"] * (di + 2 * n) * length
    intra = 2 * n * pairs + 2 * heads * p * pairs
    state = 2 * heads * p * n * (2 * length + chunks) + 2 * di * length
    gate = 5 * di * length
    out = 2 * di * d * length
    return proj + conv + intra + state + gate + out


def attention_flops(cfg: dict, length: int) -> float:
    """One NoPE GQA layer: the projections at 2·params a token and causal
    attention (QKᵀ and PV over the keys at or before each query)."""
    d = cfg["hidden_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // h
    proj = 2 * (d * h * dh * 2 + d * kv * dh * 2) * length
    return proj + 2 * 2 * h * dh * (length * (length + 1) // 2)


def request_flops(cfg: dict, length: int) -> float:
    """Model FLOPs of scoring one prompt of ``length`` tokens: every
    layer's mixer and its sparse FFN at 2·nnz a token, and the logits at
    2·d·V a token."""
    ffn = 2 * sum(nnz for *_, nnz in counts.ffn_matrices(cfg)) * length
    mix = {"mamba": mamba_flops(cfg, length),
           "attention": attention_flops(cfg, length)}
    total = sum(mix[k] + ffn for k in layer_kinds(cfg))
    return total + 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * length
