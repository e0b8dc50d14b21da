"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B;
unverified]."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=500_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=0, d_ff=128, vocab_size=512, segments=())
