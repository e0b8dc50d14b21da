"""Model architecture config (the reference's ``repro.configs.base``).

Every ported architecture gets a ``configs/<id>.py`` exporting ``CONFIG``
(the published numbers) and ``smoke_config()`` (a reduced same-family
variant for CPU tests).  The fields are the reference's, so a config reads
the same in both packages; the model code of this port implements the
``attn`` block type only.
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
    # types from {"attn", "moe", "ssd", "rglru"}; "attn" blocks carry an MLP.
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

    # --- distribution (the reference's layout; unused by this port) -------
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
