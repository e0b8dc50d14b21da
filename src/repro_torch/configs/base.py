"""Model architecture config, input-shape cells and the training config
(the reference's ``repro.configs.base``).

Every ported architecture gets a ``configs/<id>.py`` exporting ``CONFIG``
(the published numbers) and ``smoke_config()`` (a reduced same-family
variant for CPU tests).  The fields are the reference's, so a config reads
the same in both packages.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int              # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 → d_model // num_heads

    # segments: ((pattern, repeat), ...) where pattern is a tuple of block
    # types from {"attn", "moe", "ssd", "rglru", "ssd_mlp"}; "attn",
    # "rglru" and "ssd_mlp" blocks carry an MLP.
    segments: tuple[tuple[tuple[str, ...], int], ...] = ()

    # --- attention --------------------------------------------------------
    attention: str = "full"     # full | swa | local
    window: int = 4096
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_impl: str = "sort"
    moe_groups: int = 0

    # --- SSM (mamba2) -----------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64

    # --- RG-LRU (recurrentgemma) -------------------------------------------
    lru_width: int = 0
    conv_width: int = 4

    # --- embeddings / io ----------------------------------------------------
    input_mode: str = "tokens"  # tokens | embeddings
    tie_embeddings: bool = True
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 10_000.0  # 0 → sinusoidal absolute positions
    logit_softcap: float = 0.0
    parallel_block: bool = False  # command-r style parallel attn+FFN
    embed_scale: bool = False     # multiply embeddings by sqrt(d)
    mlp: str = "swiglu"           # swiglu | gelu

    # --- paper technique ----------------------------------------------------
    ffn_prune: float = 0.0      # >0: serve FFN via CSR SpMM, keep fraction

    # --- numerics -----------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # --- distribution: the residual stream's layout and tensor parallelism
    # under a mesh (``repro_torch.distributed.sharding.constrain``) -------
    residual_spec: tuple = ("dp", None, None)
    tp: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if not self.segments:
            object.__setattr__(self, "segments",
                               ((("attn",), self.num_layers),))
        n = sum(len(p) * r for p, r in self.segments)
        if n != self.num_layers:
            raise ValueError(
                f"segments cover {n} layers, config says {self.num_layers}")

    # --- port-only knobs: class constants here, not fields, so the field
    # list stays the reference's; :class:`HybridConfig` makes them fields.
    # These values are today's numerics. ----------------------------------
    norm_eps = 1e-6               # every RMSNorm / LayerNorm of the model
    embedding_multiplier = 1.0    # embeddings times this
    attention_multiplier = 0.0    # the score scale; 0 → head_dim ** -0.5
    residual_multiplier = 1.0     # each branch times this before its add
    logits_scaling = 1.0          # logits divided by this
    nope = False                  # attention without positions
    ssm_conv_bias = False         # a bias on the SSD block's causal conv
    ssm_gated_norm = False        # rmsnorm(y · silu(z)) · w before out_proj

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def block_types(self) -> list[str]:
        out = []
        for pattern, reps in self.segments:
            out += list(pattern) * reps
        return out


@dataclasses.dataclass(frozen=True)
class HybridConfig(ModelConfig):
    """A :class:`ModelConfig` with the port-only knobs as fields: the µP
    multipliers and normalisation epsilon of IBM's Granite 4.0 models,
    NoPE attention, and the SSD block of Bamba / GraniteMoeHybrid (a bias
    on its conv, a gated RMSNorm before ``out_proj``).  Each default is
    the class constant of :class:`ModelConfig`, so a config that sets none
    computes what a plain one does."""

    norm_eps: float = 1e-6
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    nope: bool = False
    ssm_conv_bias: bool = False
    ssm_gated_norm: bool = False


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 2048
    global_batch: int = 8
    microbatches: int = 1        # gradient accumulation steps
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: bool = True
    seed: int = 0
    # distributed-optimization tricks
    grad_compression: str = "none"   # none | int8_ef
    loss_chunk: int = 512            # vocab-chunked CE sequence chunk
