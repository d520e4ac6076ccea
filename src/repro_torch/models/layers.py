"""Shared model layers of the port: the schema leaf, the projection
einsum, RMS norm and the gated FFN.

Only what the xLSTM blocks use is here so far; attention, RoPE and the
attention caches come with the dense serving path.  The JAX package's
sharding constraint (``constrain``) is a no-op on one device and is
dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Parameter/cache leaf spec: shape + logical axes + init recipe.

    init: ("normal", scale) | ("zeros",) | ("ones",) | ("const", c)
    """

    shape: tuple
    axes: tuple
    init: tuple = ("normal", 1.0)


def ein(eq: str, *args: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Projection einsum whose result is in ``dtype``, as the reference's
    ``preferred_element_type=dtype``: an f32 result takes the f32 product
    of the (lower-precision) inputs; a bf16 result is a bf16 einsum, which
    accumulates in f32 and rounds once."""
    if dtype == torch.float32:
        args = tuple(a.float() for a in args)
    return torch.einsum(eq, *args).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """RMS norm over the last axis in f32, times ``(1 + scale)``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def mlp_schema(d: int, f: int, activation: str) -> dict:
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    sch = {"wi": PSpec((d, f), ("embed", "ff"), ("normal", s_in)),
           "wo": PSpec((f, d), ("ff", "embed"), ("normal", s_out))}
    if activation in ("swiglu", "geglu"):
        sch["wg"] = PSpec((d, f), ("embed", "ff"), ("normal", s_in))
    return sch


def mlp_apply(p: dict, x: torch.Tensor, activation: str, dtype):
    """Gated (``swiglu`` / ``geglu``, tanh GELU) or plain ``gelu`` FFN."""
    h = ein("bsd,df->bsf", x, p["wi"].to(dtype), dtype=dtype)
    if activation in ("swiglu", "geglu"):
        g = ein("bsd,df->bsf", x, p["wg"].to(dtype), dtype=dtype)
        act = F.silu if activation == "swiglu" else \
            (lambda t: F.gelu(t, approximate="tanh"))
        h = act(g.float()).to(dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(dtype)
    return ein("bsf,fd->bsd", h, p["wo"].to(dtype), dtype=dtype)
