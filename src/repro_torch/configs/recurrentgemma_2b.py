"""recurrentgemma-2b [hybrid] — arXiv:2402.19427.

26L d_model=2560 10H (GQA kv=1, MQA) head_dim=256 d_ff=7680 (GeGLU)
vocab=256000; block pattern (RG-LRU, RG-LRU, local-attn) with a 2048-token
attention window; embeddings scaled by sqrt(d) and tied.  The same values
as the JAX package's ``repro/configs/recurrentgemma_2b.py``.
"""

from repro_torch.configs.registry import ArchMeta
from repro_torch.models.config import ModelConfig

META = ArchMeta(train_microbatches=1, source="arXiv:2402.19427")


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab=256000, activation="geglu",
        block_pattern=("rglru", "rglru", "local_attn"),
        local_window=2048, rnn_width=2560, conv_width=4,
        emb_scale=True, tie_embeddings=True, rope_theta=10_000.0,
        scan_layers=False,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-tiny", family="hybrid",
        n_layers=3, d_model=96, n_heads=4, n_kv_heads=1, head_dim=24,
        d_ff=192, vocab=307, activation="geglu",
        block_pattern=("rglru", "rglru", "local_attn"),
        local_window=16, rnn_width=96, conv_width=4,
        emb_scale=True, tie_embeddings=True, scan_layers=False,
        dtype="float32")
