"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060;
unverified].  Attention-free; sub-quadratic → runs long_500k."""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    segments=((("ssd",), 48),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8, segments=((("ssd",), 2),))
