"""Mixture-of-Experts with merge-based (paper §4.2) load balancing.

The token→expert routing matrix is sparse and irregular — hot experts are
the paper's long rows, cold experts its short rows.  The ``sort``
implementation is the nonzero-split idea applied to experts:

  1. top-k routing,
  2. sort token-replicas by expert (CSR ordering),
  3. pad each expert group to the token tile ``TT`` (chunk breaks at group
     boundaries),
  4. grouped GEMM over equal-token blocks (``kernels/moe_gemm.py``: the
     CUDA kernel on the card, its plain version on the CPU; or one batched
     matmul over the (E, cap, d) layout with ``use_kernel=False``),
  5. weighted scatter back to token order (the fix-up epilogue).

Load balance is perfect by construction whatever the routing skew.
``dense`` is the GShard-style einsum baseline.  With ``moe_groups = g >
1`` (and ``b·s`` divisible by ``g``) the tokens split into ``g`` groups,
each sorted, capped and scattered on its own (the reference's
hierarchical dispatch), their expert GEMMs folded into one launch.

Over a mesh (``distributed.sharding``) the block runs with its tokens and
expert weights whole on every rank: its routing, sort and scatter use ops
that DTensor has no sharding rule for (aten.index_add_ first), so the
reference's constraint of the grouped tokens over dp has no counterpart
here, and each rank computes the one-process block's capacity and drops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import on_every_rank

from repro_torch.kernels import ops as _ops

from .layers import normal_init

TT = 64  # tokens per block (the merge chunk size for experts)


def init_moe(gen: torch.Generator, cfg) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = d ** -0.5
    return {
        "router": normal_init(gen, (d, e), torch.float32, s),
        "w1": normal_init(gen, (e, d, ff), cfg.pdtype, s),
        "w3": normal_init(gen, (e, d, ff), cfg.pdtype, s),
        "w2": normal_init(gen, (e, ff, d), cfg.pdtype, ff ** -0.5),
    }


def route(p, x, cfg):
    """Top-k routing.  x (t, d) → gates (t, k) f32, experts (t, k) int64,
    probs (t, E) f32."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    return gates, experts, probs


def _expert_counts(experts, e):
    """Replicas routed to each expert, (E,) int64 — a scatter-add, where
    ``bincount`` would read its length back to the host on the card."""
    flat = experts.reshape(-1)
    return torch.zeros(e, dtype=torch.int64, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))


def aux_load_balance_loss(probs, experts, cfg):
    """Switch-style auxiliary loss: E · Σ_e f_e · P_e.

    probs (t, E) router probabilities; experts (t, k) selected ids."""
    e = cfg.num_experts
    counts = _expert_counts(experts, e).to(torch.float32)          # (E,)
    f = counts / torch.clamp(counts.sum(), min=1.0)
    return e * torch.sum(f * probs.mean(0))


def _sorted_dispatch(x, experts, cfg, tt, capacity_factor: float = 1.25):
    """Sort token-replicas by expert into a fixed-capacity buffer.

    Expert ``e`` owns rows ``[e·cap, (e+1)·cap)`` of ``buf`` (cap =
    ⌈t·k/E · capacity_factor⌉ rounded up to ``tt``).  Replicas beyond an
    expert's capacity are dropped: they land in one spare row past the
    buffer (the reference's ``mode="drop"``), which is cut off, so no index
    is ever out of range.
    """
    t, d = x.shape
    k, e = cfg.top_k, cfg.num_experts
    cap = tt * max(1, -(-int(t * k * capacity_factor) // (e * tt)))
    flat_e = experts.reshape(-1)                     # (t*k,)
    order = torch.argsort(flat_e, stable=True)       # CSR ordering
    sorted_e = flat_e[order]
    sizes = _expert_counts(flat_e, e)                # true group sizes
    group_start = torch.cumsum(sizes, 0) - sizes
    rank = torch.arange(t * k, device=x.device) - group_start[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[order // k]
    return buf[:e * cap], dict(order=order, slot=slot, keep=keep, cap=cap)


def _group_mlp(buf, p, cfg, tt, use_kernel, impl=None):
    """SwiGLU through grouped GEMMs (equal tokens per block).
    ``use_kernel`` runs the grouped GEMM op (``impl`` as in
    ``ops.moe_group_gemm``), else one batched matmul per weight."""
    dt = cfg.cdtype
    e = cfg.num_experts
    cap = buf.shape[0] // e
    if use_kernel:
        sizes = torch.full((e,), cap, dtype=torch.int32, device=buf.device)

        def gg(a, w):
            return _ops.moe_group_gemm(a, w, sizes, tt=tt, impl=impl)

        h = F.silu(gg(buf, p["w1"].to(dt))) * gg(buf, p["w3"].to(dt))
        return gg(h, p["w2"].to(dt))
    xb = buf.reshape(e, cap, -1)
    h = F.silu(torch.bmm(xb, p["w1"].to(dt))) * torch.bmm(xb,
                                                        p["w3"].to(dt))
    return torch.bmm(h, p["w2"].to(dt)).reshape(e * cap, -1)


def _fixup(out, meta, gates, cfg, t):
    """The fix-up epilogue: the weighted scatter of the expert outputs
    ``out`` (E·cap, d) back to the order of the ``t`` tokens."""
    safe_slot = torch.clamp(meta["slot"], max=out.shape[0] - 1)
    contrib = torch.where(meta["keep"][:, None], out[safe_slot], 0.0)
    tok = meta["order"] // cfg.top_k
    w = gates.reshape(-1)[meta["order"]].to(contrib.dtype)
    y = torch.zeros((t, out.shape[1]), dtype=contrib.dtype,
                    device=out.device)
    return y.index_add_(0, tok, contrib * w[:, None])


def _sort_moe(p, xt, gates, experts, cfg, tt, use_kernel, capacity_factor,
              impl=None):
    buf, meta = _sorted_dispatch(xt, experts, cfg, tt, capacity_factor)
    out = _group_mlp(buf, p, cfg, tt, use_kernel, impl)
    return _fixup(out, meta, gates, cfg, xt.shape[0])


def _grouped_sort_moe(p, xt, gates, experts, cfg, groups, tt, use_kernel,
                      capacity_factor, impl=None):
    """The hierarchical dispatch: the tokens split into ``groups`` equal
    groups, each sorted into its own fixed-capacity buffer (its own
    capacity, its own drops) and scattered back on its own, as the
    reference's ``vmap`` of ``_sort_moe`` over the groups.  The expert
    GEMMs of all groups run as one: the buffers fold expert-major (expert
    ``e``'s rows of group 0, then of group 1, ...), so each grouped GEMM
    launch takes ``groups · cap`` rows an expert, and each row's product
    is the one a group's own launch computes."""
    t, d = xt.shape
    tg, e = t // groups, cfg.num_experts
    bufs, metas = [], []
    for i in range(groups):
        buf, meta = _sorted_dispatch(xt[i * tg:(i + 1) * tg],
                                     experts[i * tg:(i + 1) * tg], cfg, tt,
                                     capacity_factor)
        bufs.append(buf)
        metas.append(meta)
    cap = metas[0]["cap"]                 # a function of tg alone
    folded = torch.stack(bufs).reshape(groups, e, cap, d).transpose(0, 1)
    out = _group_mlp(folded.reshape(e * groups * cap, d), p, cfg, tt,
                     use_kernel, impl)
    out = out.reshape(e, groups, cap, -1).transpose(0, 1)
    return torch.cat([
        _fixup(out[i].reshape(e * cap, -1), metas[i],
               gates[i * tg:(i + 1) * tg], cfg, tg)
        for i in range(groups)])


def moe_apply(p, x, cfg, *, tt: int = TT, use_kernel: bool | None = None,
              capacity_factor: float = 1.25, impl: str | None = None):
    """x (b, s, d) → (y, aux_loss).

    ``use_kernel=None`` follows the device: the grouped GEMM kernel for a
    ``sort`` MoE on a CUDA tensor, the batched matmul on the CPU.
    ``impl`` goes to ``ops.moe_group_gemm`` when the kernel path runs
    (``"torch"``: its plain version on any device)."""
    if isinstance(x, DTensor):
        return on_every_rank(moe_apply, p, x, cfg, tt=tt,
                             use_kernel=use_kernel,
                             capacity_factor=capacity_factor, impl=impl)
    if use_kernel is None:
        use_kernel = cfg.moe_impl == "sort" and x.is_cuda
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, experts, probs = route(p, xt, cfg)
    aux = aux_load_balance_loss(probs, experts, cfg)
    if cfg.moe_impl == "dense":
        y = _dense_moe(p, xt, gates, experts, cfg)
    elif cfg.moe_groups > 1 and (b * s) % cfg.moe_groups == 0:
        # Hierarchical dispatch: a local sort and scatter a group (groups
        # track the data shards, so the merge ordering never crosses
        # them); a capacity a group keeps the total work equal.
        y = _grouped_sort_moe(p, xt, gates, experts, cfg, cfg.moe_groups,
                              tt, use_kernel, capacity_factor, impl)
    else:
        y = _sort_moe(p, xt, gates, experts, cfg, tt, use_kernel,
                      capacity_factor, impl)
    return y.reshape(b, s, d).to(x.dtype), aux


def _dense_moe(p, xt, gates, experts, cfg):
    """GShard-style einsum baseline: every token × every expert mask."""
    e = cfg.num_experts
    dt = cfg.cdtype
    comb = torch.zeros((xt.shape[0], e), dtype=torch.float32,
                       device=xt.device)
    comb.scatter_add_(1, experts, gates)
    h = torch.einsum("td,edf->tef", xt, p["w1"].to(dt))
    h3 = torch.einsum("td,edf->tef", xt, p["w3"].to(dt))
    o = torch.einsum("tef,efd->ted", F.silu(h) * h3, p["w2"].to(dt))
    return torch.einsum("ted,te->td", o, comb.to(dt))
