"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf]."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    segments=((("moe",), 16),),
    num_experts=64,
    top_k=8,
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=0, d_ff=32, vocab_size=256, num_experts=8, top_k=2,
        segments=((("moe",), 2),))
