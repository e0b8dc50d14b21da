"""The dense architecture's system under test: the port's online server
over the pruned-FFN forward, built as ``python -m repro_torch.launch.serve
--prune-ffn KEEP --serve`` builds it.

``launch.serve.prune_ffn_blocks`` prunes and plans every FFN matrix
through the engine's plan cache (the §5.4 "auto" method), then
``launch.serve.make_pruned_forward`` is the forward of the server that
``system.serve`` builds over the traffic's bucket ladder.
"""
from __future__ import annotations

import torch

import system


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

    return system.serve(forward, (params, blocks), traffic)
