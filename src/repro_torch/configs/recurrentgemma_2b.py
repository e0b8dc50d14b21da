"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn per 2
recurrent layers [arXiv:2402.19427; hf].  26 layers = 8×(rec,rec,attn)+2rec.
Sub-quadratic (local window 2048) → runs long_500k."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    segments=(
        (("rglru", "rglru", "attn"), 8),
        (("rglru", "rglru"), 1),
    ),
    attention="local",
    window=2048,
    lru_width=2560,
    conv_width=4,
    embed_scale=True,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=0, d_ff=128, vocab_size=256, window=16, lru_width=64,
        segments=((("rglru", "rglru", "attn"), 1), (("rglru", "rglru"), 1)))
