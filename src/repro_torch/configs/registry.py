"""Architecture registry: ``get(arch_id)`` -> (ModelConfig, ArchMeta).

The port has a module for each of the JAX package's ten architectures:
``xlstm_125m``, ``yi_6b``, ``recurrentgemma_2b``, ``gemma_7b``, the
mixture-of-experts ``phi35_moe_42b`` and ``grok_1_314b``, the dense
``llama3_405b`` and ``qwen15_110b`` (these four do not fit one card at
full depth), and the two with a modality frontend,
``llava_next_mistral_7b`` (``vision_stub``) and ``hubert_xlarge``
(``audio_stub``, encoder-only).  An unknown name raises ``KeyError``, as
the reference does.  Each module exports ``config()`` (the published
configuration), ``tiny()`` (a reduced same-family config for CPU tests)
and ``META``.
"""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ArchMeta:
    train_microbatches: int = 1      # grad-accumulation steps at train_4k
    source: str = ""


ARCHS = [
    "llava_next_mistral_7b",
    "grok_1_314b",
    "phi35_moe_42b",
    "recurrentgemma_2b",
    "gemma_7b",
    "yi_6b",
    "llama3_405b",
    "qwen15_110b",
    "xlstm_125m",
    "hubert_xlarge",
]
# Every architecture of the reference has its module here.
PORTED = tuple(ARCHS)

# CLI ids (dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _mod(arch: str):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get(arch: str):
    m = _mod(arch)
    return m.config(), m.META


def get_tiny(arch: str):
    m = _mod(arch)
    return m.tiny()
