"""phi3.5-moe-42b-a6.6b [moe] — hf:microsoft/Phi-3.5-MoE-instruct (hf tier).

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2,
SwiGLU experts, bf16 at rest.  The same values as the JAX package's
``repro/configs/phi35_moe_42b.py``.
"""

from repro_torch.configs.registry import ArchMeta
from repro_torch.models.config import ModelConfig

META = ArchMeta(train_microbatches=4,
                source="hf:microsoft/Phi-3.5-MoE-instruct")


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=6400, vocab=32064, activation="swiglu",
        n_experts=16, top_k=2, param_dtype="bfloat16",
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-tiny", family="moe",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=211, activation="swiglu", n_experts=8, top_k=2,
        dtype="float32")
