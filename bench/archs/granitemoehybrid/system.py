"""The granitemoehybrid architecture's system under test: the port's
online server over the pruned-FFN forward of a Mamba2 / attention hybrid,
built as the dense one is.

``launch.serve.check_prunable`` accepts its ``ssd_mlp`` and ``attn``
blocks, ``launch.serve.prune_ffn_blocks`` prunes and plans every layer's
``shared_mlp`` through the engine's plan cache (the §5.4 "auto" method),
then ``launch.serve.make_pruned_forward`` is the forward of the server
that ``system.serve`` builds over the traffic's bucket ladder.
"""
from __future__ import annotations

import torch

import system

MIXER_KEYS = ("in_proj", "conv", "conv_bias", "a_log", "dt_bias", "d_skip",
              "norm", "out_proj")


def model_config(cfg: dict):
    """The port's ``HybridConfig`` of a configuration file."""
    from repro_torch.configs.base import HybridConfig

    same = {"hidden_act": "silu", "normalization_function": "rmsnorm",
            "num_local_experts": 0, "mamba_n_groups": 1,
            "shared_intermediate_size": cfg["intermediate_size"]}
    for key, want in same.items():
        if cfg[key] != want:
            raise ValueError(f"{cfg['name']}: the harness runs {key} "
                             f"{want!r}, not {cfg[key]!r}")
    btype = {"mamba": "ssd_mlp", "attention": "attn"}
    d = cfg["hidden_size"]
    return HybridConfig(
        name=cfg["name"], family="hybrid",
        num_layers=cfg["num_hidden_layers"], d_model=d,
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["shared_intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg.get("head_dim") or 0,
        segments=((tuple(btype[k] for k in cfg["layer_types"]), 1),),
        ssm_state=cfg["mamba_d_state"], ssm_head_dim=cfg["mamba_d_head"],
        ssm_expand=cfg["mamba_expand"], ssm_chunk=cfg["mamba_chunk_size"],
        conv_width=cfg["mamba_d_conv"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        param_dtype=cfg["param_dtype"], compute_dtype=cfg["compute_dtype"],
        norm_eps=cfg["rms_norm_eps"],
        embedding_multiplier=float(cfg["embedding_multiplier"]),
        attention_multiplier=float(cfg["attention_multiplier"]),
        residual_multiplier=float(cfg["residual_multiplier"]),
        logits_scaling=float(cfg["logits_scaling"]),
        nope=cfg["position_embedding_type"] == "nope",
        ssm_conv_bias=cfg["mamba_conv_bias"], ssm_gated_norm=True)


def port_params(w: dict) -> dict:
    """The benchmark's weights (``weights.make``) in the port's parameter
    tree: the same tensors, no copy."""
    params = {"embed": w["embed"], "final_norm": {"scale": w["final_norm"]}}
    if "unembed" in w:
        params["unembed"] = w["unembed"]
    blocks = []
    for lw in w["layers"]:
        blk = {"ln1": {"scale": lw["ln1"]}, "ln2": {"scale": lw["ln2"]},
               "mlp": {k: lw[k] for k in ("w1", "w3", "w2")}}
        if "in_proj" in lw:
            blk["ssd"] = {k: lw[k] for k in MIXER_KEYS}
        else:
            blk["attn"] = {k: lw[k] for k in ("wq", "wk", "wv", "wo")}
        blocks.append(blk)
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
