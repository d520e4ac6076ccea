"""Model configuration schema, the JAX package's ``ModelConfig`` with the
same fields and defaults; ``DTYPES`` maps its dtype names to torch."""

from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    block_pattern: tuple = ("attn",)   # cycled over layers
    activation: str = "swiglu"         # swiglu|geglu|gelu
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    expert_parallel: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    local_window: int = 0
    causal: bool = True
    frontend: str = "none"             # none|audio_stub|vision_stub
    n_patches: int = 0
    emb_scale: bool = False
    logits_softcap: float = 0.0
    norm_eps: float = 1e-6
    rnn_width: int = 0
    conv_width: int = 4
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"       # at-rest parameter dtype
    opt_state_dtype: str = "float32"
    grad_accum_dtype: str = "float32"
    seq_parallel: bool = False
    tie_embeddings: bool = False
    remat: bool = True
    scan_layers: bool = True
    attn_q_block: int = 512

    def blocks(self) -> tuple:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def uniform_stack(self) -> bool:
        return len(set(self.block_pattern)) == 1

    @property
    def attn_q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def sub_quadratic(self) -> bool:
        return "attn" not in set(self.blocks())

    @property
    def has_decode(self) -> bool:
        return self.causal

    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]
