"""llava-next-mistral-7b [vlm] — hf:llava-hf/llava-v1.6-mistral-7b-hf.

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) head_dim=128
d_ff=14336 vocab=32000, SwiGLU, rope_theta=1e6.  The anyres vision tower
is a stub, as in the reference: a batch carries ``n_patches`` = 2880
precomputed patch embeddings (base 576 + 4 tiles x 576) that are put
before the token embeddings.  The same values as the JAX package's
``repro/configs/llava_next_mistral_7b.py``.
"""

from repro_torch.configs.registry import ArchMeta
from repro_torch.models.config import ModelConfig

META = ArchMeta(train_microbatches=2,
                source="hf:llava-hf/llava-v1.6-mistral-7b-hf")


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=32000, activation="swiglu", rope_theta=1e6,
        frontend="vision_stub", n_patches=2880,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="llava-tiny", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=223, activation="swiglu",
        frontend="vision_stub", n_patches=8, dtype="float32")
