"""grok-1-314b [moe] — hf:xai-org/grok-1 (unverified tier).

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts
top-2, GeGLU experts, tanh logit soft-cap 30, bf16 at rest.  The same
values as the JAX package's ``repro/configs/grok_1_314b.py``.
"""

from repro_torch.configs.registry import ArchMeta
from repro_torch.models.config import ModelConfig

META = ArchMeta(train_microbatches=8, source="hf:xai-org/grok-1")


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=32768, vocab=131072, activation="geglu",
        n_experts=8, top_k=2, logits_softcap=30.0,
        param_dtype="bfloat16", seq_parallel=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="grok-1-tiny", family="moe",
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=499, activation="geglu", n_experts=4, top_k=2,
        logits_softcap=30.0, dtype="float32")
