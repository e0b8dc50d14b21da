"""granite-4.0-h-micro [hybrid] — Mamba2 and NoPE GQA attention, every
layer with a SwiGLU MLP, µP multipliers [hf:ibm-granite/granite-4.0-h-micro
config.json, ``model_type`` granitemoehybrid].

Not one of the reference's architectures: it is in ``PORT_ARCHS``, not
``ARCHS``, and its knobs are :class:`HybridConfig` fields, which the
reference's ``ModelConfig`` lacks.
Layers 5, 15, 25 and 35 attend; the other 36 are SSD mixers (64 heads of
64, d_state 128, one group of B and C, conv 4 with a bias, chunk 256,
a gated RMSNorm before ``out_proj``)."""
import dataclasses

from .base import HybridConfig

PERIOD = ("ssd_mlp",) * 5 + ("attn",) + ("ssd_mlp",) * 4

CONFIG = HybridConfig(
    name="granite-4.0-h-micro",
    family="hybrid",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=100352,
    segments=((PERIOD, 4),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
    norm_eps=1e-5,
    embedding_multiplier=12.0,
    attention_multiplier=1 / 64,
    residual_multiplier=0.22,
    logits_scaling=8.0,
    nope=True,
    ssm_conv_bias=True,
    ssm_gated_norm=True,
)


def smoke_config() -> HybridConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=0, d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=8, segments=((("ssd_mlp", "ssd_mlp", "attn", "ssd_mlp"),
                                1),))
