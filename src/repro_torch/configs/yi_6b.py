"""yi-6b [dense] — arXiv:2403.04652 (hf tier).

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, llama-style SwiGLU,
rope_theta=5e6.  The same values as the JAX package's
``repro/configs/yi_6b.py``.
"""

import dataclasses

from repro_torch.configs.registry import ArchMeta
from repro_torch.models.config import ModelConfig

META = ArchMeta(train_microbatches=2, source="arXiv:2403.04652")


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=11008, vocab=64000, activation="swiglu", rope_theta=5e6,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-tiny", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab=251, activation="swiglu", rope_theta=5e6,
        dtype="float32")


def tiny_card() -> ModelConfig:
    """tiny() with its heads widened from 8 to 32 dimensions, the smallest
    head dim the port's attention kernels take: what the examples run on
    the card, where tiny()'s head dim 8 raises (the plain versions on the
    CPU take both).  The JAX package has no such config."""
    return dataclasses.replace(tiny(), name="yi-6b-tiny-dh32", head_dim=32)
