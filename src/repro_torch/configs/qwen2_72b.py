"""qwen2-72b [dense] — GQA, QKV bias [arXiv:2407.10671; hf]."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=0, d_ff=128, vocab_size=512, segments=())
