"""hubert-xlarge [audio] — arXiv:2106.07447.

48L d_model=1280 16H (kv=16) head_dim=80 d_ff=5120 (GELU) vocab=504
(k-means units); encoder-only: bidirectional attention and no decode
step.  The wav2vec2-style conv frontend is a stub, as in the reference:
a batch carries precomputed frame embeddings ``frames`` [B, S, d_model].
The same values as the JAX package's ``repro/configs/hubert_xlarge.py``.
"""

from repro_torch.configs.registry import ArchMeta
from repro_torch.models.config import ModelConfig

META = ArchMeta(train_microbatches=1, source="arXiv:2106.07447")


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
        d_ff=5120, vocab=504, activation="gelu", causal=False,
        frontend="audio_stub",
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="hubert-tiny", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=97, activation="gelu", causal=False,
        frontend="audio_stub", dtype="float32")
