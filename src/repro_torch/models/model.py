"""Decoder model over attention and MoE blocks (the ``attn`` and ``moe``
block types of the reference's ``repro.models.model``).

Parameters are a plain dict: ``embed`` (vocab, d), ``unembed`` when
untied, ``final_norm``, and ``blocks`` — one dict per layer (``ln1``,
``attn``, ``ln2``, and ``mlp`` or ``moe``), in layer order.  The reference
stacks each segment's layers on a leading axis for ``lax.scan``; eager
PyTorch walks a list instead (``repro_torch.convert`` unstacks a reference
param tree), and the KV caches are a list of per-layer dicts likewise.
Entry points: ``loss_and_aux`` (training), ``prefill`` and
``decode_step``.  SSD and RG-LRU blocks arrive with later slices.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import paths

from . import layers as L
from . import moe as MOE
from . import losses

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


def stack_keys(params, cfg) -> list[str]:
    """For each leaf of ``params`` (in ``tree.leaves`` order) the
    reference's tensor that holds it: a leaf of layer i's block names its
    segment and pattern position instead of i, since the reference stacks
    a segment's layers on one leading axis; other leaves name
    themselves."""
    where = [f"{si}.{pi}" for si, (pattern, count) in enumerate(cfg.segments)
             for _ in range(count) for pi in range(len(pattern))]
    keys = []
    for p in paths(params):
        parts = p.split("/")
        if parts[0] == "blocks":
            parts[1] = where[int(parts[1])]
        keys.append("/".join(parts))
    return keys


def init_caches(cfg, batch: int, cache_len: int, device) -> list:
    """One zeroed KV cache per layer, in layer order."""
    return [init_block_cache(bt, cfg, batch, cache_len, device)
            for bt in cfg.block_types()]


def block_apply(p, btype, x, cfg, *, positions=None, cache=None, pos=None,
                use_kernel: bool | None = None):
    """One pre-norm block (sequential, or ``parallel_block``): attention,
    then the MLP or the MoE (``use_kernel`` as in ``moe.moe_apply``).
    Returns (x, new_cache, aux)."""
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
        ffn_out, aux = MOE.moe_apply(p["moe"], h, cfg, use_kernel=use_kernel)
    else:
        ffn_out = L.mlp_apply(p["mlp"], h, cfg)
    if cfg.parallel_block:
        return x + attn_out + ffn_out, new_cache, aux
    return x + ffn_out, new_cache, aux


def forward(params, cfg, h, *, positions=None, caches=None, pos=None,
            remat: bool = False, use_kernel: bool | None = None):
    """h (b, s, d) embedded inputs → (h, new_caches, aux_total).

    ``remat`` checkpoints each block: its activations are dropped after
    the forward and rebuilt in the backward (the reference's
    ``jax.checkpoint`` of each scan step, which is one block for
    single-block patterns).  ``use_kernel`` goes to every MoE block."""
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    new_caches = []
    for i, (btype, lp) in enumerate(zip(cfg.block_types(),
                                        params["blocks"])):
        kw = dict(positions=positions, pos=pos, use_kernel=use_kernel,
                  cache=None if caches is None else caches[i])
        if remat:
            h, nc, a = checkpoint(block_apply, lp, btype, h, cfg,
                                  use_reentrant=False, **kw)
        else:
            h, nc, a = block_apply(lp, btype, h, cfg, **kw)
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
    """h (b, s, d) after the final norm → f32 logits (b, s, vocab), by
    the loss's rule (:func:`repro_torch.models.losses.logits`)."""
    return losses.logits(h, unembed_matrix(params, cfg), cfg.logit_softcap)


def loss_and_aux(params, cfg, batch, *, remat: bool = True,
                 loss_chunk: int = 512, aux_weight: float = 0.01):
    """Causal-LM loss.  batch: tokens (b, s), labels (b, s) and an optional
    mask (b, s).  Returns (loss, {"nll", "aux", "tokens"}), float32 0-d.

    MoE blocks run their experts through the batched matmul, on every
    device: the grouped GEMM kernel has no backward (the reference's
    trainer takes the same path off the TPU)."""
    if "tokens" not in batch:
        raise ValueError("loss_and_aux takes token batches (embedding "
                         "inputs are not ported yet)")
    h = embed_inputs(params, cfg, batch["tokens"])
    h, _, aux = forward(params, cfg, h, remat=remat, use_kernel=False)
    h = L.norm_apply(params["final_norm"], h, cfg.norm)
    nll, cnt = losses.chunked_cross_entropy(
        h, unembed_matrix(params, cfg), batch["labels"], chunk=loss_chunk,
        logit_softcap=cfg.logit_softcap, mask=batch.get("mask"))
    return nll + aux_weight * aux, {"nll": nll, "aux": aux, "tokens": cnt}


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
