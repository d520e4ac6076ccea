"""Where the port's entry points run: ``device=None`` means the CUDA
device, and there is no silent CPU fallback."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> the CUDA device (raises when there is none); anything
    else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "version on the CPU")
        return torch.device("cuda")
    return torch.device(device)
