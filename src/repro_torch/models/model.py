"""Decoder model over attention blocks (the ``attn`` block type of the
reference's ``repro.models.model``).

Parameters are a plain dict: ``embed`` (vocab, d), ``final_norm``, and
``blocks`` — one dict per layer (``ln1``, ``attn``, ``ln2``, ``mlp``), in
layer order.  The reference stacks each segment's layers on a leading
axis for ``lax.scan``; eager PyTorch walks a list instead
(``repro_torch.convert`` unstacks a reference param tree).  MoE, SSD and
RG-LRU blocks arrive with later slices.
"""
from __future__ import annotations

import torch

from . import layers as L


def init_block(gen: torch.Generator, btype: str, cfg) -> dict:
    if btype != "attn":
        raise ValueError(f"block type {btype!r} is not ported yet")
    d, dev = cfg.d_model, gen.device
    return {"ln1": L.init_norm(d, cfg.norm, torch.float32, dev),
            "attn": L.init_attention(gen, cfg),
            "ln2": L.init_norm(d, cfg.norm, torch.float32, dev),
            "mlp": L.init_mlp(gen, cfg)}


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


def block_apply(p, btype, x, cfg) -> torch.Tensor:
    """One pre-norm attention block (sequential, or ``parallel_block``)."""
    if btype != "attn":
        raise ValueError(f"block type {btype!r} is not ported yet")
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    attn_out = L.attention_apply(p["attn"], h, cfg)
    if cfg.parallel_block:
        return x + attn_out + L.mlp_apply(p["mlp"], h, cfg)
    x = x + attn_out
    h2 = L.norm_apply(p["ln2"], x, cfg.norm)
    return x + L.mlp_apply(p["mlp"], h2, cfg)


def embed_inputs(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.rope_theta == 0.0:
        raise ValueError("sinusoidal positions are not ported yet")
    h = params["embed"][tokens].to(cfg.cdtype)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype)
    return h


def unembed_matrix(params, cfg) -> torch.Tensor:
    return params.get("unembed", params["embed"])
