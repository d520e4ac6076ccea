"""gemma-7b [dense] — arXiv:2403.08295.

28L d_model=3072 16H (kv=16, MHA) head_dim=256 d_ff=24576 (GeGLU)
vocab=256000; embeddings scaled by sqrt(d) and tied.  The same values as
the JAX package's ``repro/configs/gemma_7b.py``.
"""

from repro_torch.configs.registry import ArchMeta
from repro_torch.models.config import ModelConfig

META = ArchMeta(train_microbatches=2, source="arXiv:2403.08295")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000, activation="geglu",
        emb_scale=True, tie_embeddings=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-tiny", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=401, activation="geglu", emb_scale=True,
        tie_embeddings=True, dtype="float32")
