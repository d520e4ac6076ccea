"""Architecture registry: ``get(arch_id)`` -> (ModelConfig, ArchMeta).

The JAX package's registry names ten architectures; the port has the
modules of those whose serving path it runs so far (``xlstm_125m``,
``yi_6b``, ``recurrentgemma_2b``, ``gemma_7b``, the mixture-of-experts
``phi35_moe_42b`` and ``grok_1_314b``, and the dense ``llama3_405b`` and
``qwen15_110b``; the last four do not fit one card at full depth).
Naming another known architecture raises ``NotImplementedError``; an
unknown name raises ``KeyError``, as the reference does.  Each module
exports ``config()`` (the published configuration), ``tiny()`` (a reduced
same-family config for CPU tests) and ``META``.
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
PORTED = ("xlstm_125m", "yi_6b", "recurrentgemma_2b", "gemma_7b",
          "phi35_moe_42b", "grok_1_314b", "llama3_405b", "qwen15_110b")

# CLI ids (dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _mod(arch: str):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to repro_torch yet "
            f"(ported: {list(PORTED)})")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get(arch: str):
    m = _mod(arch)
    return m.config(), m.META


def get_tiny(arch: str):
    m = _mod(arch)
    return m.tiny()
