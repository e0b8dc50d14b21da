"""command-r-35b [dense] — GQA, no-bias, parallel blocks
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=0, d_ff=128, vocab_size=512, segments=())
