"""The system under test: the port's online server over the pruned-FFN
forward, built as ``python -m repro_torch.launch.serve --prune-ffn KEEP
--serve`` builds it.

``launch.serve.prune_ffn_blocks`` prunes and plans every FFN matrix
through the engine's plan cache (the §5.4 "auto" method), then
``launch.serve.make_pruned_forward`` is the forward of a ``serving.Server``
over the traffic's bucket ladder, whose ``warmup`` captures one CUDA
graph a bucket.  This module is the only one of the benchmark that
imports the program; the benchmark takes from it the server, its
futures' stamps and its metrics registry.
"""
from __future__ import annotations

import gc

import torch


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig

    if cfg["hidden_act"] != "silu":
        raise ValueError(f"{cfg['name']}: the harness runs SwiGLU FFNs, "
                         f"not {cfg['hidden_act']!r}")
    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg.get("head_dim") or 0,
        qkv_bias=bool(cfg.get("attention_bias")),
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        param_dtype=cfg["param_dtype"], compute_dtype=cfg["compute_dtype"])


def port_params(w: dict) -> dict:
    """The benchmark's weights (``weights.make``) in the port's parameter
    tree: the same tensors, no copy."""
    params = {"embed": w["embed"], "final_norm": {"scale": w["final_norm"]}}
    if "unembed" in w:
        params["unembed"] = w["unembed"]
    blocks = []
    for lw in w["layers"]:
        attn = {k: lw[k] for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
                if k in lw}
        blocks.append({"ln1": {"scale": lw["ln1"]}, "attn": attn,
                       "ln2": {"scale": lw["ln2"]},
                       "mlp": {k: lw[k] for k in ("w1", "w3", "w2")}})
    params["blocks"] = blocks
    return params


def build(cfg: dict, w: dict, traffic: dict):
    """The warmed-up, not yet started server over ``w``."""
    from repro_torch import serving
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False     # as serve's CLI
    torch.backends.cudnn.allow_tf32 = False
    mc = model_config(cfg)
    serve.check_prunable(mc)
    params = port_params(w)
    blocks = serve.prune_ffn_blocks(params, mc, cfg["keep"])
    base = serve.make_pruned_forward(mc)

    def forward(state, tokens):
        p, blk = state
        return base(p, blk, tokens)

    ladder = serving.BucketLadder(lengths=tuple(traffic["ladder"]["lengths"]),
                                  batches=tuple(traffic["ladder"]["batches"]))
    server = serving.Server(forward, (params, blocks), ladder,
                            queue_depth=traffic["queue_depth"],
                            name="bench")
    return server.warmup()


def counters() -> dict:
    """The program's metrics registry: ``name{label=value,...}`` → the
    count and sum of a histogram, or the value of a counter or gauge."""
    from repro_torch.obs import registry

    out = {}
    for fam in registry.families():
        for child in fam.children():
            key = fam.name + "{" + ",".join(
                f"{k}={v}" for k, v in sorted(child.labels.items())) + "}"
            if fam.kind == "histogram":
                out[key] = {"count": child.count, "sum": child.sum}
            else:
                out[key] = {"value": child.value}
    return out


def release(server) -> None:
    """Stop the server and free the program's device state: its bucket
    programs, its parameters and the plan cache's plans."""
    from repro_torch import engine

    server.stop(timeout=120)
    server.programs.clear()
    server.state = None
    engine.clear_cache()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
