"""Serving entry point: pruned-FFN prefill scoring through the SpMM engine.

    python -m repro_torch.launch.serve --prune-ffn 0.25
    python -m repro_torch.launch.serve --prune-ffn 0.25 --spmm-method merge
    python -m repro_torch.launch.serve --smoke --prune-ffn 0.25 --device cpu

Every FFN matrix is magnitude-pruned to CSR once, its plan built once
through the engine cache, and the forward then runs every FFN matmul as a
planned SpMM — the hand-written CUDA kernels on the card, their plain
versions on the CPU.  The dense decode path (``generate``), online
serving, microbatching, device meshes and TuneDB-driven plans are later
slices of the port; the CLI rejects their flags.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core import PlanPolicy
from repro_torch.engine import cache_stats
from repro_torch.kernels import registry
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sparse as S

_PRUNABLE_BTYPES = ("attn",)   # ported blocks that own a dense "mlp"


def _check_replans(before, after) -> int:
    """Count plan-cache misses between two ``cache_stats()`` snapshots and
    fail loudly if the serving forward built any (a real check, not an
    ``assert``, which ``python -O`` strips)."""
    replans = after.misses - before.misses
    if replans:
        raise RuntimeError(
            f"serving replanned: {replans} plan(s) built during the "
            f"forward (cache misses {before.misses} -> {after.misses}). "
            "Plans must be attached before serving — build the sparse "
            "params with prune_ffn_blocks first.")
    return replans


def check_prunable(cfg):
    btypes = set(cfg.block_types())
    unsupported = btypes - set(_PRUNABLE_BTYPES)
    if unsupported:
        raise SystemExit(
            f"--prune-ffn needs every block to own a dense MLP (ported "
            f"btypes {_PRUNABLE_BTYPES}); arch has {sorted(unsupported)} "
            "blocks")


def prune_ffn_blocks(params, cfg, keep: float, policy=None) -> list:
    """Each layer's params with its MLP pruned (on the weights' device)
    and planned through the engine cache; ``policy`` pins the plan
    request, e.g. a forced kernel method from ``--spmm-method``.  Serving
    runs forward only, so the plans leave out the transpose (CSC) plan of
    the backward."""
    policy = dataclasses.replace(policy or PlanPolicy(),
                                 with_transpose=False)
    return [dict(lp, mlp=S.prune_mlp(lp["mlp"], keep, policy=policy))
            for lp in params["blocks"]]


def make_pruned_forward(cfg):
    """Full forward with SparseLinear MLPs: tokens (b, s) → f32 logits
    (b, s, vocab).  Routes through ``model.block_apply``, so only
    ``mlp_apply`` differs from the dense model.  The logits are
    ``h.float() @ embed.T.float()``, a plain float32 matmul (TF32 off)."""
    btypes = cfg.block_types()

    def fwd(params, blocks, tokens):
        h = M.embed_inputs(params, cfg, tokens)
        for btype, lp in zip(btypes, blocks):
            h = M.block_apply(lp, btype, h, cfg)
        h = L.norm_apply(params["final_norm"], h, cfg.norm)
        return h.float() @ M.unembed_matrix(params, cfg).T.float()

    return fwd


@dataclasses.dataclass
class ServeReport:
    """What one ``serve_pruned`` run measured (host clock, synchronised)."""

    logits: torch.Tensor
    methods: dict
    plan_s: float
    cold_s: float
    warm_s: float
    tok_per_s: float
    replans: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_pruned(cfg, params, prompt, keep: float, *,
                 policy=None) -> ServeReport:
    """Prune + plan every FFN, then score ``prompt`` twice (cold, warm);
    raises if the forward built a plan."""
    check_prunable(cfg)
    device = prompt.device
    _sync(device)
    t0 = time.perf_counter()
    blocks = prune_ffn_blocks(params, cfg, keep, policy=policy)
    _sync(device)
    t_plan = time.perf_counter() - t0
    stats = cache_stats()
    methods = {k: v.method for k, v in blocks[0]["mlp"].items()}
    print(f"[serve] pruned {len(blocks)} MLPs (keep={keep:.0%}) "
          f"in {t_plan:.2f}s; methods={methods}; "
          f"plan cache: {stats.misses} built, {stats.hits} reused")
    fwd = make_pruned_forward(cfg)
    with torch.no_grad():
        t1 = time.perf_counter()
        fwd(params, blocks, prompt)
        _sync(device)
        t_cold = time.perf_counter() - t1
        t2 = time.perf_counter()
        logits = fwd(params, blocks, prompt)
        _sync(device)
        t_warm = time.perf_counter() - t2
    replans = _check_replans(stats, cache_stats())
    tok_s = prompt.numel() / t_warm
    print(f"[serve] cold forward {t_cold * 1e3:.1f}ms; warm pruned forward "
          f"{t_warm * 1e3:.1f}ms ({tok_s:.0f} tok/s); plans built during "
          f"serving: {replans}")
    return ServeReport(logits, methods, t_plan, t_cold, t_warm, tok_s,
                       replans)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="pruned-FFN serving through the SpMM engine")
    ap.add_argument("--arch", choices=ARCHS, default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prune-ffn", type=float, default=0.0, metavar="KEEP",
                    help="serve with magnitude-pruned FFNs (CSR SpMM via "
                    "the plan engine); KEEP is the kept fraction per row")
    ap.add_argument("--spmm-method", default="auto",
                    choices=("auto",) + registry.method_names(),
                    help="force the SpMM kernel method of the pruned-FFN "
                    "plans ('auto': the paper's §5.4 rule)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                    "kernels' plain versions)")
    # The reference's flags of paths this port has not reached yet.
    later = {"--gen": "the dense decode path (generate)",
             "--serve": "online serving",
             "--microbatch": "microbatched scoring",
             "--mesh": "sharded plans",
             "--tunedb": "TuneDB-driven plans"}
    for flag in later:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [f for f in later
             if getattr(args, f.lstrip("-").replace("-", "_")) is not None]
    if given:
        ap.error(", ".join(f"{f} ({later[f]})" for f in given)
                 + ": not ported to repro_torch yet; this slice serves "
                 "pruned-FFN prefill only")
    if args.prune_ffn <= 0.0:
        ap.error("the dense decode path is not ported to repro_torch yet; "
                 "pass --prune-ffn KEEP to serve with pruned FFNs")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to run the plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = M.init_params(cfg, args.seed, device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    rep = serve_pruned(cfg, params, prompt, args.prune_ffn,
                       policy=PlanPolicy(method=args.spmm_method))
    print(f"pruned-FFN logits {tuple(rep.logits.shape)}; argmax@last "
          f"{rep.logits[:, -1].argmax(-1).tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
