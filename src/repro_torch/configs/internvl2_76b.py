"""internvl2-76b [vlm] — InternViT + LLM backbone [arXiv:2404.16821;
unverified].  The InternViT patch frontend is a stub:
a batch carries precomputed patch/text ``embeds``."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    input_mode="embeddings",
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=0, d_ff=128, vocab_size=512, segments=())
