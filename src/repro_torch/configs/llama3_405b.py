"""llama3-405b [dense] — arXiv:2407.21783 (unverified tier).

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256, SwiGLU,
rope_theta=500k, bf16 at rest (parameters, Adam moments and gradient
accumulation).  The same values as the JAX package's
``repro/configs/llama3_405b.py``.
"""

from repro_torch.configs.registry import ArchMeta
from repro_torch.models.config import ModelConfig

META = ArchMeta(train_microbatches=4, source="arXiv:2407.21783")


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
        d_ff=53248, vocab=128256, activation="swiglu", rope_theta=500_000.0,
        param_dtype="bfloat16", opt_state_dtype="bfloat16",
        grad_accum_dtype="bfloat16", seq_parallel=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-tiny", family="dense",
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=503, activation="swiglu", rope_theta=500_000.0,
        dtype="float32")
