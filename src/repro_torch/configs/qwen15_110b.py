"""qwen1.5-110b [dense] — hf:Qwen/Qwen1.5-110B family (hf tier).

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, SwiGLU, QKV bias,
bf16 at rest.  The same values as the JAX package's
``repro/configs/qwen15_110b.py``.
"""

from repro_torch.configs.registry import ArchMeta
from repro_torch.models.config import ModelConfig

META = ArchMeta(train_microbatches=8, source="hf:Qwen/Qwen1.5-110B")


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=49152, vocab=152064, activation="swiglu", qkv_bias=True,
        rope_theta=1e6, param_dtype="bfloat16", seq_parallel=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-tiny", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab=269, activation="swiglu", qkv_bias=True,
        dtype="float32")
