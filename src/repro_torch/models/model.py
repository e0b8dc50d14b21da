"""Decoder model over attention and MoE blocks (the ``attn`` and ``moe``
block types of the reference's ``repro.models.model``).

Parameters are a plain dict: ``embed`` (vocab, d), ``unembed`` when
untied, ``final_norm``, and ``blocks`` — one dict per layer (``ln1``,
``attn``, ``ln2``, and ``mlp`` or ``moe``), in layer order.  The reference
stacks each segment's layers on a leading axis for ``lax.scan``; eager
PyTorch walks a list instead (``repro_torch.convert`` unstacks a reference
param tree), and the KV caches are a list of per-layer dicts likewise.
Three entry points: ``forward``, ``prefill`` and ``decode_step``.  SSD and
RG-LRU blocks arrive with later slices.
"""
from __future__ import annotations

import torch

from . import layers as L
from . import moe as MOE

_BTYPES = ("attn", "moe")      # the block types ported so far


def _check_btype(btype: str) -> None:
    if btype not in _BTYPES:
        raise ValueError(f"block type {btype!r} is not ported yet "
                         f"(ported: {_BTYPES})")


def init_block(gen: torch.Generator, btype: str, cfg) -> dict:
    _check_btype(btype)
    d, dev = cfg.d_model, gen.device
    p = {"ln1": L.init_norm(d, cfg.norm, torch.float32, dev),
         "attn": L.init_attention(gen, cfg),
         "ln2": L.init_norm(d, cfg.norm, torch.float32, dev)}
    if btype == "attn":
        p["mlp"] = L.init_mlp(gen, cfg)
    else:
        p["moe"] = MOE.init_moe(gen, cfg)
    return p


def init_block_cache(btype: str, cfg, batch: int, cache_len: int,
                     device) -> dict:
    _check_btype(btype)
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def init_params(cfg, seed: int, device="cuda") -> dict:
    """Random parameters from ``seed`` on ``device`` (weights drawn on the
    device itself: a full-width model never passes through the host)."""
    if cfg.input_mode != "tokens":
        raise ValueError("only token-input models are ported yet")
    gen = torch.Generator(device=device).manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    params = {"embed": L.normal_init(gen, (v, d), cfg.pdtype, d ** -0.5)}
    if not cfg.tie_embeddings:
        params["unembed"] = L.normal_init(gen, (v, d), cfg.pdtype, d ** -0.5)
    params["final_norm"] = L.init_norm(d, cfg.norm, torch.float32,
                                       gen.device)
    params["blocks"] = [init_block(gen, bt, cfg) for bt in cfg.block_types()]
    return params


def init_caches(cfg, batch: int, cache_len: int, device) -> list:
    """One zeroed KV cache per layer, in layer order."""
    return [init_block_cache(bt, cfg, batch, cache_len, device)
            for bt in cfg.block_types()]


def block_apply(p, btype, x, cfg, *, positions=None, cache=None, pos=None):
    """One pre-norm block (sequential, or ``parallel_block``): attention,
    then the MLP or the MoE.  Returns (x, new_cache, aux)."""
    _check_btype(btype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    attn_out, new_cache = L.attention_apply(p["attn"], h, cfg,
                                            positions=positions, cache=cache,
                                            pos=pos)
    if not cfg.parallel_block:
        x = x + attn_out
        h = L.norm_apply(p["ln2"], x, cfg.norm)
    if btype == "moe":
        ffn_out, aux = MOE.moe_apply(p["moe"], h, cfg)
    else:
        ffn_out = L.mlp_apply(p["mlp"], h, cfg)
    if cfg.parallel_block:
        return x + attn_out + ffn_out, new_cache, aux
    return x + ffn_out, new_cache, aux


def forward(params, cfg, h, *, positions=None, caches=None, pos=None):
    """h (b, s, d) embedded inputs → (h, new_caches, aux_total)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    new_caches = []
    for i, (btype, lp) in enumerate(zip(cfg.block_types(),
                                        params["blocks"])):
        h, nc, a = block_apply(lp, btype, h, cfg, positions=positions,
                               cache=None if caches is None else caches[i],
                               pos=pos)
        new_caches.append(nc)
        aux_total = aux_total + a
    return h, new_caches, aux_total


def embed_inputs(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.rope_theta == 0.0:
        raise ValueError("sinusoidal positions are not ported yet")
    h = params["embed"][tokens].to(cfg.cdtype)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype)
    return h


def unembed_matrix(params, cfg) -> torch.Tensor:
    return params.get("unembed", params["embed"])


def _logits(params, cfg, h) -> torch.Tensor:
    """h (b, s, d) after the final norm → f32 logits (b, s, vocab): the
    unembedding cast to h's dtype, then both operands' exact f32 values
    multiplied in f32 (the reference's ``preferred_element_type=f32``)."""
    w = unembed_matrix(params, cfg).to(h.dtype)
    logits = torch.einsum("bsd,vd->bsv", h.float(), w.float())
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def prefill(params, cfg, batch: dict, *, cache_len: int | None = None):
    """Forward pass that fills caches.  batch: tokens (b, s).  Returns
    (caches, last_logits (b, 1, vocab) f32, pos (b,) int64)."""
    tokens = batch["tokens"]
    h = embed_inputs(params, cfg, tokens)
    b, s, _ = h.shape
    caches = init_caches(cfg, b, cache_len or s, h.device)
    h, caches, _ = forward(params, cfg, h, caches=caches)
    h_last = L.norm_apply(params["final_norm"], h[:, -1:], cfg.norm)
    pos = torch.full((b,), s, dtype=torch.int64, device=h.device)
    return caches, _logits(params, cfg, h_last), pos


def decode_step(params, cfg, caches, batch: dict, pos):
    """One-token step.  batch: tokens (b, 1); pos (b,).  Returns (logits
    (b, 1, vocab) f32, new_caches)."""
    positions = pos[:, None]
    h = embed_inputs(params, cfg, batch["tokens"])
    h, caches, _ = forward(params, cfg, h, positions=positions,
                           caches=caches, pos=pos)
    h = L.norm_apply(params["final_norm"], h, cfg.norm)
    return _logits(params, cfg, h), caches
