"""xlstm-125m [ssm] — arXiv:2405.04517.

12L d_model=768 4H head_dim=192 d_ff=0 vocab=50304; alternating
mLSTM / sLSTM blocks (the mLSTM block carries its own gated projection, the
sLSTM block a 4/3-factor GeGLU FFN).  The same values as the JAX
package's ``repro/configs/xlstm_125m.py``.
"""

from repro_torch.configs.registry import ArchMeta
from repro_torch.models.config import ModelConfig

META = ArchMeta(train_microbatches=1, source="arXiv:2405.04517")


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
        d_ff=0, vocab=50304, block_pattern=("mlstm", "slstm"),
        scan_layers=False,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="xlstm-tiny", family="ssm",
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=0, vocab=191, block_pattern=("mlstm", "slstm"),
        scan_layers=False, dtype="float32")
