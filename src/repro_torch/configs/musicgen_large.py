"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  The EnCodec frontend is a stub:
a batch carries precomputed frame ``embeds``."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    input_mode="embeddings",
    mlp="gelu",
    norm="layernorm",
    rope_theta=0.0,          # sinusoidal absolute positions
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=0, d_ff=128, vocab_size=128, segments=())
