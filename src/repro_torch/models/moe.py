"""Capacity-based top-k mixture of experts (GShard-style), the JAX
package's ``repro/models/moe.py`` off the mesh.

Each call routes its ``b * s`` tokens locally: f32 router logits, a
softmax, the top ``k`` experts of each token, and its position in each
chosen expert from a cumulative one-hot in priority order (every token's
first choice before any second choice, then token order).  Tokens past an
expert's ``capacity`` slots are dropped.  The kept rows are scattered into
an ``[E, C, D]`` buffer, the experts run as batched products over it, and
each token gathers its rows back, weighted by its renormalised gates.

Three points where the port must act as the compiled reference does:

* ``jax.lax.top_k`` puts the lower expert id first on a tie; the port
  takes a stable descending sort cut to ``k`` (:func:`_top_k`), not
  ``torch.topk``, whose order on ties is not defined.
* A dropped pair's position may pass the capacity.  JAX clamps an
  out-of-bounds gather index and the pair's zero weight removes the row;
  PyTorch raises on such an index (a device-side assert on the card), so
  :func:`_combine_local` clamps the position to ``capacity - 1`` first.
* The scatter adds ``x * 0`` for a dropped pair at slot ``capacity - 1``
  of its expert, and kept pairs never share a slot, so an accumulating
  ``index_put_`` gives the reference's bytes.

The expert products are plain batched products (no TPU kernel), through
:func:`repro_torch.models.layers.ein`.  The gate product of a gated
activation stays f32 before ``silu`` / tanh-``gelu`` (the dense FFN's
``mlp_apply`` rounds it to the compute dtype first).

Only the reference's off-mesh path is ported: its ``shard_map`` dispatch
and expert-parallel sharding have no counterpart on one card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import PSpec, ein


def moe_schema(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(f)
    sch = {
        "router": PSpec((d, e), ("norm", "norm2"), ("normal", s_in)),
        "w1": PSpec((e, d, f), ("experts", "embed", "ff"), ("normal", s_in)),
        "w2": PSpec((e, f, d), ("experts", "ff", "embed"),
                    ("normal", s_out)),
    }
    if cfg.activation in ("swiglu", "geglu"):
        sch["wg"] = PSpec((e, d, f), ("experts", "embed", "ff"),
                          ("normal", s_in))
    return sch


def _capacity(tokens_local: int, cfg: ModelConfig) -> int:
    cap = int(math.ceil(tokens_local * cfg.top_k * cfg.capacity_factor
                        / cfg.n_experts))
    return max(8, -(-cap // 8) * 8)  # round up to 8


def _top_k(probs: torch.Tensor, k: int) -> tuple:
    """(values, expert ids) of the ``k`` largest of each row, largest
    first and the lower id first on a tie, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route_local(x, router, cfg: ModelConfig, capacity: int):
    """x: [T, D] tokens -> (dispatch buffer [E, C, D], (idx, pos, keep,
    gate) each [T, k], the load-balance term)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = ein("td,de->te", x, router.to(x.dtype), dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)                 # [T,E] f32
    gate, idx = _top_k(probs, k)                          # [T,k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # Position in expert, in priority order: slot k, then token order.
    idx_f = idx.transpose(0, 1).reshape(-1)               # [k*T], k-major
    onehot = F.one_hot(idx_f, e)                          # [k*T, E]
    pos_f = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    pos = pos_f.reshape(k, t).transpose(0, 1)             # [T,k]
    keep = pos < capacity

    # Scatter the kept rows into [E, C, D]; a dropped pair adds x * 0 at
    # its expert's last slot.
    buf = torch.zeros((e, capacity, d), dtype=x.dtype, device=x.device)
    p_flat = torch.where(keep, pos, capacity - 1).reshape(-1)
    contrib = x.repeat_interleave(k, dim=0) \
        * keep.reshape(-1)[:, None].to(x.dtype)
    buf.index_put_((idx.reshape(-1), p_flat), contrib, accumulate=True)

    # The load-balance term (GShard): mean first-choice fraction times
    # mean probability, summed over experts, times E.
    density = F.one_hot(idx[:, 0], e).to(torch.float32).mean(0)
    aux = torch.sum(density * probs.mean(0)) * e
    return buf, (idx, pos, keep, gate), aux


def _combine_local(out_buf, meta, dtype):
    """Gather each (token, choice) row of ``out_buf`` [E, C, D] and sum
    them weighted by ``gate * keep`` in f32 -> [T, D] in ``dtype``.  A
    dropped pair's position is clamped to the last slot, as JAX's gather
    clamps it; its zero weight removes the row."""
    idx, pos, keep, gate = meta
    y = out_buf[idx, torch.clamp(pos, max=out_buf.shape[1] - 1)]  # [T,k,D]
    w = (gate * keep).to(torch.float32)
    return torch.einsum("tkd,tk->td", y.float(), w).to(dtype)


def _expert_ffn(p, buf, cfg: ModelConfig, dtype):
    """buf: [E, C, D] -> [E, C, D]: each expert's FFN over its slots."""
    h = ein("ecd,edf->ecf", buf, p["w1"].to(dtype), dtype=dtype)
    if cfg.activation in ("swiglu", "geglu"):
        g = ein("ecd,edf->ecf", buf, p["wg"].to(dtype), dtype=torch.float32)
        act = F.silu if cfg.activation == "swiglu" else \
            (lambda v: F.gelu(v, approximate="tanh"))
        h = act(g).to(dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(dtype)
    return ein("ecf,efd->ecd", h, p["w2"].to(dtype), dtype=dtype)


def moe_apply(p, x, cfg: ModelConfig):
    """x: [B,S,D] -> ([B,S,D], the load-balance term)."""
    dtype = cfg.compute_dtype()
    b, s, d = x.shape
    cap = _capacity(b * s, cfg)
    buf, meta, aux = _route_local(x.reshape(b * s, d), p["router"], cfg, cap)
    out_buf = _expert_ffn(p, buf, cfg, dtype)
    y = _combine_local(out_buf, meta, dtype)
    return y.reshape(b, s, d), aux
