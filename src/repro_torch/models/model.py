"""Decoder model over heterogeneous block stacks (the reference's
``repro.models.model``).  A model is a sequence of *segments*
``(pattern, repeat)``, each pattern a tuple of block types:

  attn   — pre-norm GQA attention (full, sliding-window or local) + MLP
  moe    — attention + mixture-of-experts FFN (merge-based dispatch)
  ssd    — Mamba2 state-space block
  rglru  — RG-LRU recurrent block + MLP (RecurrentGemma)
  ssd_mlp — Mamba2 state-space mixer + MLP (Granite 4.0-H, the port's own)

Parameters are a plain dict: ``embed`` (vocab, d) for token inputs,
``unembed`` when untied or when the inputs are embeddings, ``final_norm``,
and ``blocks`` — one dict per layer, in layer order.  The reference stacks
each segment's layers on a leading axis for ``lax.scan``; eager PyTorch
walks a list instead (``repro_torch.convert`` unstacks a reference param
tree), and the caches (KV for attention, conv and recurrent state for SSD
and RG-LRU) are a list of per-layer dicts likewise.  Entry points:
``loss_and_aux`` (training), ``prefill`` and ``decode_step``; a batch
holds ``tokens`` (b, s) or, for embedding inputs, ``embeds`` (b, s, d).

The port-only knobs of ``configs.base.HybridConfig`` act here: every norm
at ``norm_eps``, embeddings times ``embedding_multiplier``, each block's
branch times ``residual_multiplier`` before its add, logits divided by
``logits_scaling``; at their defaults each is left out, so a plain config
computes the reference's ops.  Each block's mixer runs inside an
``obs.span`` (``ssd_mixer``, ``rglru_mixer`` or ``attention``, category
``model``): nothing while tracing is off, a ``torch.profiler`` range
inside a capture.  No counter is kept in the forward: a bucket program's
CUDA graph replays its kernels without running the Python that would
count them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.distributed.sharding import constrain
from repro_torch.tree import paths

from . import layers as L
from . import moe as MOE
from . import losses
from . import rglru as R
from . import ssm as S

BTYPES = ("attn", "moe", "ssd", "rglru", "ssd_mlp")
RECURRENT = ("ssd", "rglru", "ssd_mlp")


def _check_btype(btype: str) -> None:
    if btype not in BTYPES:
        raise ValueError(f"block type {btype!r}: expected one of {BTYPES}")


def init_block(gen: torch.Generator, btype: str, cfg) -> dict:
    _check_btype(btype)
    d, dev = cfg.d_model, gen.device
    p = {"ln1": L.init_norm(d, cfg.norm, torch.float32, dev)}
    if btype in ("ssd", "ssd_mlp"):
        p["ssd"] = S.init_ssd(gen, cfg)
        if btype == "ssd":
            return p
    elif btype == "rglru":
        p["rec"] = R.init_rglru(gen, cfg)
    else:
        p["attn"] = L.init_attention(gen, cfg)
    p["ln2"] = L.init_norm(d, cfg.norm, torch.float32, dev)
    if btype == "moe":
        p["moe"] = MOE.init_moe(gen, cfg)
    else:
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def init_block_cache(btype: str, cfg, batch: int, cache_len: int,
                     device) -> dict:
    """A zeroed cache of one block: KV (b, cache_len, kv, dh) in the
    compute dtype for attention; for SSD and RG-LRU the recurrent state,
    whose size does not depend on ``cache_len``."""
    _check_btype(btype)
    if btype in ("ssd", "ssd_mlp"):
        return S.init_ssd_state(cfg, batch, device)
    if btype == "rglru":
        return R.init_rglru_state(cfg, batch, device)
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def init_params(cfg, seed: int, device="cuda") -> dict:
    """Random parameters from ``seed`` on ``device`` (weights drawn on the
    device itself: a full-width model never passes through the host).  An
    embeddings-input model (a stub modality frontend gives the
    embeddings) has an ``unembed`` and no ``embed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    params = {}
    if cfg.input_mode == "tokens":
        params["embed"] = L.normal_init(gen, (v, d), cfg.pdtype, d ** -0.5)
    if cfg.input_mode != "tokens" or not cfg.tie_embeddings:
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
    """One zeroed cache per layer, in layer order."""
    return [init_block_cache(bt, cfg, batch, cache_len, device)
            for bt in cfg.block_types()]


def _branch(out, cfg):
    """A block's branch output as its residual add takes it: times
    ``residual_multiplier`` where that is set."""
    rm = cfg.residual_multiplier
    return out if rm == 1.0 else out * rm


def _norm(p, x, cfg):
    return L.norm_apply(p, x, cfg.norm, eps=cfg.norm_eps)


def block_apply(p, btype, x, cfg, *, positions=None, cache=None, pos=None,
                use_kernel: bool | None = None):
    """One pre-norm block.  Attention blocks (sequential, or
    ``parallel_block``): attention, then the MLP or the MoE (``use_kernel``
    as in ``moe.moe_apply``).  SSD: the state-space mixer, then, for
    ``ssd_mlp``, the MLP.  RG-LRU: the recurrent mixer, then the MLP.  A
    recurrent block decodes from its cache when ``x`` is one token; a
    longer ``x`` is a prefill from a zero state (the cache passed is only a
    shape donor).  Returns (x, new_cache, aux)."""
    _check_btype(btype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm(p["ln1"], x, cfg)
    # Under a mesh the norm outputs of attention blocks take the residual
    # layout, so the backward's partial sums over the model axis are
    # reduced here, in the compute dtype (the reference's constraint).
    rs = cfg.residual_spec
    if btype in RECURRENT:
        state = cache if (cache is not None and x.shape[1] == 1) else None
        if btype == "rglru":
            with obs.span("rglru_mixer", cat="model"):
                out, new_cache = R.rglru_apply(p["rec"], h, cfg, state=state)
        else:
            with obs.span("ssd_mixer", cat="model"):
                out, new_cache = S.ssd_apply(p["ssd"], h, cfg, state=state)
        x = x + _branch(out, cfg)
        if btype == "ssd":
            return x, new_cache, aux
        h = _norm(p["ln2"], x, cfg)
        return x + _branch(L.mlp_apply(p["mlp"], h, cfg), cfg), new_cache, aux
    h = constrain(h, *rs)
    with obs.span("attention", cat="model"):
        attn_out, new_cache = L.attention_apply(p["attn"], h, cfg,
                                                positions=positions,
                                                cache=cache, pos=pos)
    attn_out = _branch(attn_out, cfg)
    if not cfg.parallel_block:
        x = x + attn_out
        h = constrain(_norm(p["ln2"], x, cfg), *rs)
    if btype == "moe":
        ffn_out, aux = MOE.moe_apply(p["moe"], h, cfg, use_kernel=use_kernel)
    else:
        ffn_out = L.mlp_apply(p["mlp"], h, cfg)
    ffn_out = _branch(ffn_out, cfg)
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
    h = constrain(h, *cfg.residual_spec)
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
        h = constrain(h, *cfg.residual_spec)
        new_caches.append(nc)
        aux_total = aux_total + a
    return h, new_caches, aux_total


def embed_inputs(params, cfg, batch: dict, *, positions=None):
    """The batch's inputs (b, s, d) in the compute dtype: ``tokens``
    looked up in ``embed`` (times sqrt(d) with ``embed_scale``, times
    ``embedding_multiplier`` in the table's dtype before the cast), or
    ``embeds`` as given; plus sinusoidal positions (``positions``,
    default 0 … s-1) when ``rope_theta`` is 0."""
    if cfg.input_mode == "tokens":
        h = F.embedding(batch["tokens"], _vocab_table(params["embed"], cfg))
        if cfg.embedding_multiplier != 1.0:
            h = h * cfg.embedding_multiplier
        h = h.to(cfg.cdtype)
        if cfg.embed_scale:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype)
    else:
        h = batch["embeds"].to(cfg.cdtype)
    if cfg.rope_theta == 0.0 and not cfg.nope:
        if positions is None:
            positions = torch.arange(h.shape[1], device=h.device)[None, :]
        h = h + L.sinusoidal(positions, cfg.d_model).to(h.dtype)
    return h


def _vocab_table(w, cfg):
    """A (vocab, d) table as the lookup and the logits use it: under a
    mesh the vocab whole on every rank, d over the model axis (TP).  Each
    use redistributes on its own, so each use's gradient comes back in the
    param's placements: a tied table's two gradients then add in one
    layout (torch 2.11's DTensor cannot add a Shard gradient to a Partial
    one: "redistribute from S(0) to P(sum)")."""
    return constrain(w, None, "model" if cfg.tp else None)


def unembed_matrix(params, cfg) -> torch.Tensor:
    return _vocab_table(params["unembed"] if "unembed" in params
                        else params["embed"], cfg)


def _logits(params, cfg, h) -> torch.Tensor:
    """h (b, s, d) after the final norm → f32 logits (b, s, vocab), by
    the loss's rule (:func:`repro_torch.models.losses.logits`), divided
    by ``logits_scaling`` where that is set."""
    out = losses.logits(h, unembed_matrix(params, cfg), cfg.logit_softcap)
    return out if cfg.logits_scaling == 1.0 else out / cfg.logits_scaling


def loss_and_aux(params, cfg, batch, *, remat: bool = True,
                 loss_chunk: int = 512, aux_weight: float = 0.01):
    """Causal-LM loss.  batch: tokens (b, s) or embeds (b, s, d), labels
    (b, s) and an optional mask (b, s).  Returns (loss, {"nll", "aux",
    "tokens"}), float32 0-d.

    MoE blocks run their experts through the batched matmul, on every
    device: the grouped GEMM kernel has no backward (the reference's
    trainer takes the same path off the TPU)."""
    h = embed_inputs(params, cfg, batch)
    h, _, aux = forward(params, cfg, h, remat=remat, use_kernel=False)
    h = _norm(params["final_norm"], h, cfg)
    if cfg.logits_scaling != 1.0:
        # (h / s) @ Eᵀ is the scaled logits (exact for a power of two)
        h = h / cfg.logits_scaling
    nll, cnt = losses.chunked_cross_entropy(
        h, unembed_matrix(params, cfg), batch["labels"], chunk=loss_chunk,
        logit_softcap=cfg.logit_softcap, mask=batch.get("mask"))
    return nll + aux_weight * aux, {"nll": nll, "aux": aux, "tokens": cnt}


def prefill(params, cfg, batch: dict, *, cache_len: int | None = None):
    """Forward pass that fills caches.  batch: tokens (b, s) or embeds
    (b, s, d).  Returns (caches, last_logits (b, 1, vocab) f32, pos (b,)
    int64)."""
    h = embed_inputs(params, cfg, batch)
    b, s, _ = h.shape
    caches = init_caches(cfg, b, cache_len or s, h.device)
    h, caches, _ = forward(params, cfg, h, caches=caches)
    h_last = _norm(params["final_norm"], h[:, -1:], cfg)
    pos = torch.full((b,), s, dtype=torch.int64, device=h.device)
    return caches, _logits(params, cfg, h_last), pos


def decode_step(params, cfg, caches, batch: dict, pos):
    """One-token step.  batch: tokens (b, 1) or embeds (b, 1, d); pos (b,).
    Returns (logits (b, 1, vocab) f32, new_caches)."""
    positions = pos[:, None]
    h = embed_inputs(params, cfg, batch, positions=positions)
    h, caches, _ = forward(params, cfg, h, positions=positions,
                           caches=caches, pos=pos)
    h = _norm(params["final_norm"], h, cfg)
    return _logits(params, cfg, h), caches
