"""Shared model layers of the port: the schema leaf, the projection
einsum, RMS norm, RoPE, GQA attention, the gated FFN and the attention
block with its KV cache (its FFN the mixture of experts of
:mod:`repro_torch.models.moe` when the config has ``n_experts``).

Attention runs in the port's kernels: prefill and training in
``flash_attention`` and decode in ``decode_attention``
(:mod:`repro_torch.kernels.ops`), which launch the CUDA kernels on the
card and run their plain versions on the CPU; under autograd (training)
``flash_attention`` is differentiable, its backward the
``flash_attention_bwd`` kernels.  A caller may pass ``flash_attention=`` / ``decode_attention=`` to
run another implementation of the same function (``chip_smoke.py`` runs
the plain versions on the card that way).  The kernels do P.V in f32;
the JAX package's jnp attention rounds the probabilities to the compute
dtype first (``probs.astype(dtype)``), so in bf16 the two differ by that
rounding.  Local (``local=True``) blocks attend within
``cfg.local_window`` positions; their decode mask on a wrapped ring is a
run of slots that need not start at slot 0, which the decode kernel takes
as a per-row ring start.

The JAX package's sharding constraint (``constrain``) is a no-op on one
device and is dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


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
    ``jnp.einsum(..., preferred_element_type=dtype)`` compiles: each
    operand is converted to ``dtype`` first, then multiplied with an f32
    accumulator and rounded once.  So an f32 result is the f32 product of
    the (widened) inputs, and a bf16 result of an f32 activation and bf16
    weights is the bf16 product of the activation rounded to bf16
    (``tests/test_torch_emb_scale.py`` holds both bit for bit)."""
    return torch.einsum(eq, *(a.to(dtype) for a in args)).to(dtype)


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


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, dh]; positions: [B, S] (absolute).  Angles in f32;
    each half is cast to x's dtype before the concat."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq              # [B,S,half]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([(x1f * cos - x2f * sin).to(x.dtype),
                      (x2f * cos + x1f * sin).to(x.dtype)], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal, window=0, q_offset=0, lengths=None,
              q_block=512, dtype=torch.bfloat16, flash_attention=None):
    """GQA attention. q: [B,S,H,dh]; k,v: [B,T,K,dh] -> [B,S,H,dh].

    One ``flash_attention`` call over the whole sequence: the kernel tiles
    the queries itself, so ``q_block`` (the reference's query blocking)
    changes nothing.  The model calls it with ``q_offset=0`` and no
    ``lengths``; the kernel has neither, and other values raise."""
    del q_block
    if q_offset or lengths is not None:
        raise NotImplementedError(
            "attention with a q_offset or kv lengths is not ported "
            "(the flash_attention kernel has neither)")
    fn = flash_attention or ops.flash_attention
    out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             causal=causal, window=window)
    return out.transpose(1, 2).to(dtype)


def cache_slot_positions(last_pos, t_cache: int):
    """Absolute position held by each ring slot after writing ``last_pos``:
    slot s holds the largest p <= last_pos with p == s (mod t_cache);
    slots never written come out negative."""
    s = torch.arange(t_cache, device=last_pos.device)
    return last_pos - torch.remainder(last_pos - s, t_cache)


def decode_run(last_pos, t_cache: int, window: int = 0):
    """(length, start) of the reference's position-aware decode mask after
    writing ``last_pos``: the slots holding positions in
    ``(last_pos - window, last_pos]`` (``window`` 0: no limit) that were
    written.  They are one run of ``length`` slots in ring order, ending
    at the write slot ``last_pos mod t_cache``, so they begin at
    ``start = (last_pos - length + 1) mod t_cache``."""
    pos = cache_slot_positions(last_pos, t_cache)              # [T]
    valid = (pos >= 0) & (pos <= last_pos)
    if window:
        valid &= pos > last_pos - window
    n = valid.sum()
    return n, torch.remainder(last_pos - n + 1, t_cache)


def decode_attention(q, k_cache, v_cache, lengths, starts=None, *,
                     dtype=torch.bfloat16, decode_attention=None):
    """Single-token attention against the cache. q: [B,1,H,dh]; caches:
    [B,T,K,dh]; lengths, starts: [B] (starts None: zeros), row b's valid
    slots ``(starts[b] + j) mod T`` for ``j < lengths[b]`` ->
    [B,1,H,dh].

    The reference takes a ``[B,T]`` validity mask; the kernel takes the
    ring run that mask is (:func:`decode_run`)."""
    b, _, h, dh = q.shape
    fn = decode_attention or ops.decode_attention
    out = fn(q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2),
             lengths, starts)
    return out.reshape(b, 1, h, dh).to(dtype)


# ---------------------------------------------------------------------------
# Attention block (params schema + apply / prefill / decode)
# ---------------------------------------------------------------------------

def attn_schema(cfg: ModelConfig, *, local: bool) -> dict:
    d, h, k, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.d_ff)
    s = 1.0 / np.sqrt(d)
    sch = {
        "ln1": PSpec((d,), ("norm",), ("zeros",)),
        "wq": PSpec((d, h, dh), ("embed", "q_heads", "head_dim"),
                    ("normal", s)),
        "wk": PSpec((d, k, dh), ("embed", "kv_heads", "head_dim"),
                    ("normal", s)),
        "wv": PSpec((d, k, dh), ("embed", "kv_heads", "head_dim"),
                    ("normal", s)),
        "wo": PSpec((h, dh, d), ("q_heads", "head_dim", "embed"),
                    ("normal", 1.0 / np.sqrt(h * dh))),
        "ln2": PSpec((d,), ("norm",), ("zeros",)),
    }
    if cfg.qkv_bias:
        sch["bq"] = PSpec((h, dh), ("q_heads", "head_dim"), ("zeros",))
        sch["bk"] = PSpec((k, dh), ("kv_heads", "head_dim"), ("zeros",))
        sch["bv"] = PSpec((k, dh), ("kv_heads", "head_dim"), ("zeros",))
    if cfg.n_experts:
        from repro_torch.models.moe import moe_schema  # (cycle)
        sch["moe"] = moe_schema(cfg)
    else:
        sch["mlp"] = mlp_schema(d, f, cfg.activation)
    return sch


def _qkv(p, x, cfg: ModelConfig, positions, dtype):
    q = ein("bsd,dhk->bshk", x, p["wq"].to(dtype), dtype=dtype)
    k = ein("bsd,dmk->bsmk", x, p["wk"].to(dtype), dtype=dtype)
    v = ein("bsd,dmk->bsmk", x, p["wv"].to(dtype), dtype=dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_and_mlp(p, x, out, cfg: ModelConfig, dtype):
    """Output projection, residual, and the FFN's residual branch: the
    mixture of experts when ``cfg.n_experts`` (its load-balance term is
    dropped, as the reference's blocks drop it)."""
    out = ein("bshk,hkd->bsd", out, p["wo"].to(dtype), dtype=dtype)
    x = x + out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        from repro_torch.models.moe import moe_apply  # (cycle)
        return x + moe_apply(p["moe"], h2, cfg)[0]
    return x + mlp_apply(p["mlp"], h2, cfg.activation, dtype)


def attn_block_apply(p, x, cfg: ModelConfig, *, local: bool, positions,
                     q_offset=0, **kernels):
    """Full residual block (train/prefill, no cache). x: [B,S,D].
    ``kernels`` may name a ``flash_attention`` to run (default: the
    kernel's dispatch); other entries are for other blocks."""
    dtype = cfg.compute_dtype()
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg, positions, dtype)
    out = attention(q, k, v, causal=cfg.causal,
                    window=cfg.local_window if local else 0,
                    q_offset=q_offset, dtype=dtype,
                    flash_attention=kernels.get("flash_attention"))
    return _out_and_mlp(p, x, out, cfg, dtype)


def attn_block_prefill(p, x, cfg: ModelConfig, *, local: bool, positions,
                       cache, **kernels):
    """Like apply, but also fills the KV cache; returns (x, cache).  The
    input cache is not modified."""
    dtype = cfg.compute_dtype()
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg, positions, dtype)
    t_cache = cache["k"].shape[1]
    s = k.shape[1]
    if s >= t_cache:
        # The trailing window, rolled so position p sits at slot
        # p % t_cache (the ring invariant decode relies on).
        new = {n: torch.roll(t[:, s - t_cache:], shifts=s % t_cache,
                             dims=1).to(cache[n].dtype)
               for n, t in (("k", k), ("v", v))}
    else:
        new = {n: torch.cat([t.to(cache[n].dtype), cache[n][:, s:]], dim=1)
               for n, t in (("k", k), ("v", v))}
    out = attention(q, k, v, causal=cfg.causal,
                    window=cfg.local_window if local else 0, dtype=dtype,
                    flash_attention=kernels.get("flash_attention"))
    return _out_and_mlp(p, x, out, cfg, dtype), new


def attn_block_decode(p, x, cfg: ModelConfig, *, local: bool, positions,
                      cache, lengths, **kernels):
    """One-token step. x: [B,1,D]; cache k/v: [B,T,K,dh] (a ring once the
    sequence passes T).  The batch decodes at the shared position
    ``lengths[0]``, as in the reference.  ``kernels`` may name
    a ``decode_attention`` to run.  The input cache is not modified."""
    dtype = cfg.compute_dtype()
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg, positions, dtype)
    t_cache = cache["k"].shape[1]
    pos0 = lengths[0].long()
    slot = torch.remainder(pos0, t_cache).reshape(1)
    kc = cache["k"].index_copy(1, slot, k.to(cache["k"].dtype))
    vc = cache["v"].index_copy(1, slot, v.to(cache["v"].dtype))
    # The reference's position-aware mask as a ring run.  For a full block
    # it is the prefix of min(lengths[0] + 1, T) slots, before and after
    # the ring wraps (once all T are valid, any start will do), so only a
    # local block passes its start.
    b = x.shape[0]
    n, start = decode_run(pos0, t_cache, cfg.local_window if local else 0)
    out = decode_attention(q, kc.to(dtype), vc.to(dtype), n.expand(b),
                           start.expand(b) if local else None, dtype=dtype,
                           decode_attention=kernels.get("decode_attention"))
    return _out_and_mlp(p, x, out, cfg, dtype), {"k": kc, "v": vc}


def attn_cache_schema(cfg: ModelConfig, batch: int, t_cache: int,
                      local: bool) -> dict:
    if local and cfg.local_window:
        t_cache = min(t_cache, cfg.local_window + 1)
    axes = ("cache_batch", "kv_seq", "kv_heads", "head_dim")
    shape = (batch, t_cache, cfg.n_kv_heads, cfg.head_dim)
    return {"k": PSpec(shape, axes, ("zeros",)),
            "v": PSpec(shape, axes, ("zeros",))}
