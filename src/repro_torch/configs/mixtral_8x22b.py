"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf]."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    segments=((("moe",), 56),),
    num_experts=8,
    top_k=2,
    attention="swa",
    window=4096,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=0, d_ff=96, vocab_size=256, num_experts=4, top_k=2,
        window=16, segments=((("moe",), 2),))
