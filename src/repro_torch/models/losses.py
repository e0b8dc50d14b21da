"""Vocab-safe losses: sequence-chunked cross-entropy (the reference's
``repro.models.losses``).

The logits of a whole batch at a 128k vocabulary would dominate
activation memory (8 x 128 tokens x 128,256 x 4 B = 0.5 GB a step at
Llama-3.2-1B's width, and s times that at long context).  The loss walks
the sequence in chunks, each chunk's logits made, reduced to its
negative log-likelihood and dropped; each chunk is checkpointed, so the
backward rebuilds one chunk's logits at a time instead of keeping every
chunk's.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import whole


def logits(h, unembed, logit_softcap: float = 0.0) -> torch.Tensor:
    """h (..., d), unembed (v, d) → float32 logits (..., v): the
    unembedding cast to h's dtype, then both operands' exact values
    multiplied in float32 (the reference's bf16 operands with
    ``preferred_element_type=f32``), then the optional softcap."""
    w = unembed.to(h.dtype)
    out = torch.einsum("...d,vd->...v", h.to(torch.float32),
                       w.to(torch.float32))
    if logit_softcap:
        out = logit_softcap * torch.tanh(out / logit_softcap)
    return out


def _chunk_nll(hc, unembed, yc, mc, logit_softcap):
    # Over a mesh the vocab dim is made whole first: aten.gather along a
    # vocab sharded across ranks has no DTensor rule that survives the
    # squeeze after it.
    logits_c = whole(logits(hc, unembed, logit_softcap), -1)
    lse = torch.logsumexp(logits_c, dim=-1)
    gold = torch.gather(logits_c, -1, yc[..., None].long())[..., 0]
    nll = (lse - gold) * mc
    return nll.sum(), mc.sum()


def chunked_cross_entropy(h, unembed, labels, *, chunk: int = 512,
                          logit_softcap: float = 0.0, mask=None):
    """h (b, s, d) final hidden states; unembed (v, d); labels (b, s).

    Returns (mean_nll, token_count), float32 0-d tensors; ``mask`` (b, s)
    weights each position's loss (default all ones)."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"loss chunk {chunk}")
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        t, c = checkpoint(_chunk_nll, h[:, i:i + chunk], unembed,
                          labels[:, i:i + chunk], mask[:, i:i + chunk],
                          logit_softcap, use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0), cnt
