"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

mLSTM per head (stabilized exponential gating)::

    log f_t = log sigmoid(f̃_t);  m_t = max(log f_t + m_{t-1}, ĩ_t)
    i' = exp(ĩ_t - m_t);  f' = exp(log f_t + m_{t-1} - m_t)
    C_t = f' C_{t-1} + i' v_t k_tᵀ          (C: [dh, dh] matrix memory)
    n_t = f' n_{t-1} + i' k_t
    h_t = C_t q_t / max(|n_tᵀ q_t|, 1)

The mLSTM recurrence runs in the ``mlstm_scan`` kernel
(:func:`repro_torch.kernels.ops.mlstm_scan`) on the card, and in its plain
version on the CPU; a caller may pass ``mlstm_scan=`` to run another
implementation of the same function (``chip_smoke.py`` runs the plain
version on the card that way, to hold the model's two paths together).

sLSTM per head: a scalar-gated cell with recurrent gate inputs (R h_{t-1}),
genuinely sequential.  The JAX package has no TPU kernel for it, so it runs
here as a plain PyTorch loop over time.

Block layout follows the paper: the mLSTM block carries its own SiLU output
gate + down-projection (no separate FFN); the sLSTM block is followed by a
GeGLU FFN of projection factor 4/3.  Parameters, caches and the order of
operations are the JAX package's (``repro/models/xlstm.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import softplus
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import PSpec, ein, mlp_apply, mlp_schema, \
    rms_norm


def _slstm_ff(cfg: ModelConfig) -> int:
    f = int(round(4 * cfg.d_model / 3))
    return -(-f // 8) * 8


def _k_scale(dh: int) -> float:
    """The f32 factor that scales k.  The reference divides by
    ``np.sqrt(dh)``, and XLA compiles that division by a constant into a
    multiply by ``f32(1) / f32(sqrt(dh))``; the port multiplies by the
    same f32 value (exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(np.sqrt(dh)))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_schema(cfg: ModelConfig) -> dict:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    return {
        "ln": PSpec((d,), ("norm",), ("zeros",)),
        "wq": PSpec((d, h, dh), ("embed", "q_heads", "head_dim"), ("normal", s)),
        "wk": PSpec((d, h, dh), ("embed", "q_heads", "head_dim"), ("normal", s)),
        "wv": PSpec((d, h, dh), ("embed", "q_heads", "head_dim"), ("normal", s)),
        "w_i": PSpec((d, h), ("embed", "q_heads"), ("normal", s)),
        "b_i": PSpec((h,), ("q_heads",), ("zeros",)),
        "w_f": PSpec((d, h), ("embed", "q_heads"), ("normal", s)),
        "b_f": PSpec((h,), ("q_heads",), ("const", 3.0)),  # open forget gates
        "w_gate": PSpec((d, h, dh), ("embed", "q_heads", "head_dim"),
                        ("normal", s)),
        "mhn": PSpec((h, dh), ("q_heads", "head_dim"), ("zeros",)),
        "w_down": PSpec((h, dh, d), ("q_heads", "head_dim", "embed"),
                        ("normal", 1.0 / np.sqrt(h * dh))),
    }


def _mlstm_scan(p, x, cfg: ModelConfig, carry=None, scan=None):
    """x: [B,S,D] -> (h [B,S,H,dh] in the compute dtype, final carry)."""
    dtype = cfg.compute_dtype()
    f32 = torch.float32
    q = ein("bsd,dhk->bshk", x, p["wq"].to(dtype), dtype=f32)
    k = ein("bsd,dhk->bshk", x, p["wk"].to(dtype), dtype=f32) \
        * _k_scale(cfg.head_dim)
    v = ein("bsd,dhk->bshk", x, p["wv"].to(dtype), dtype=f32)
    i_t = ein("bsd,dh->bsh", x, p["w_i"].to(dtype), dtype=f32) + p["b_i"]
    f_t = ein("bsd,dh->bsh", x, p["w_f"].to(dtype), dtype=f32) + p["b_f"]
    # The kernel's layout: heads before time.
    qkv = tuple(t.transpose(1, 2) for t in (q, k, v))
    gates = tuple(t.transpose(1, 2) for t in (i_t, f_t))
    hs, carry = (scan or ops.mlstm_scan)(*qkv, *gates, carry)
    return hs.transpose(1, 2).to(dtype), carry


def _mlstm_block(p, x, cfg: ModelConfig, carry=None, scan=None):
    dtype = cfg.compute_dtype()
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    mixed, carry = _mlstm_scan(p, h, cfg, carry, scan)
    # Per-head RMS norm then SiLU output gate, then down projection.
    mixed = rms_norm(mixed, p["mhn"], cfg.norm_eps)
    gate = ein("bsd,dhk->bshk", h, p["w_gate"].to(dtype), dtype=dtype)
    mixed = mixed * F.silu(gate.float()).to(dtype)
    y = ein("bshk,hkd->bsd", mixed, p["w_down"].to(dtype), dtype=dtype)
    return x + y, carry


def mlstm_block_apply(p, x, cfg, *, mlstm_scan=None, **_):
    y, _c = _mlstm_block(p, x, cfg, scan=mlstm_scan)
    return y


def mlstm_block_prefill(p, x, cfg, *, cache, mlstm_scan=None, **_):
    """Like the reference, ignores the incoming cache: a prompt starts
    from zeros and ``m = -1e30``."""
    y, (C, n, m) = _mlstm_block(p, x, cfg, scan=mlstm_scan)
    return y, {"C": C, "n": n, "m": m}


def mlstm_block_decode(p, x, cfg, *, cache, mlstm_scan=None, **_):
    carry = (cache["C"], cache["n"], cache["m"])
    y, (C, n, m) = _mlstm_block(p, x, cfg, carry, scan=mlstm_scan)
    return y, {"C": C, "n": n, "m": m}


def mlstm_cache_schema(cfg: ModelConfig, batch: int) -> dict:
    h, dh = cfg.n_heads, cfg.head_dim
    return {
        "C": PSpec((batch, h, dh, dh),
                   ("cache_batch", "q_heads", "head_dim", "norm"), ("zeros",)),
        "n": PSpec((batch, h, dh), ("cache_batch", "q_heads", "head_dim"),
                   ("zeros",)),
        "m": PSpec((batch, h), ("cache_batch", "q_heads"), ("const", -1e30)),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_schema(cfg: ModelConfig) -> dict:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    sr = 1.0 / np.sqrt(dh)
    return {
        "ln": PSpec((d,), ("norm",), ("zeros",)),
        "wx": PSpec((d, 4, h, dh), ("embed", "norm", "q_heads", "head_dim"),
                    ("normal", s)),
        "r": PSpec((4, h, dh, dh), ("norm", "q_heads", "head_dim", "norm2"),
                   ("normal", sr)),
        "b": PSpec((4, h, dh), ("norm", "q_heads", "head_dim"), ("zeros",)),
        "w_out": PSpec((h, dh, d), ("q_heads", "head_dim", "embed"),
                       ("normal", 1.0 / np.sqrt(h * dh))),
        "ln2": PSpec((d,), ("norm",), ("zeros",)),
        "mlp": mlp_schema(d, _slstm_ff(cfg), "geglu"),
    }


def _slstm_cell(r, carry, xt):
    """xt: [B,4,H,dh] pre-activations from W x_t; r: [4,H,dh,dh] f32."""
    c, h, n, m = carry                              # [B,H,dh] each
    pre = xt + torch.einsum("ghij,bhj->bghi", r, h)
    z_t, i_t, f_t, o_t = pre.unbind(1)
    z = torch.tanh(z_t)
    o = torch.sigmoid(o_t)
    log_f = -softplus(-f_t)
    m_new = torch.maximum(log_f + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h_new = o * (c / torch.clamp_min(n, 1.0))
    return (c, h_new, n, m_new), h_new


def _slstm_scan(p, x, cfg: ModelConfig, carry=None):
    dtype = cfg.compute_dtype()
    b = x.shape[0]
    h_, dh = cfg.n_heads, cfg.head_dim
    pre = ein("bsd,dghk->bsghk", x, p["wx"].to(dtype),
              dtype=torch.float32) + p["b"]
    if carry is None:
        z = torch.zeros((b, h_, dh), dtype=torch.float32, device=x.device)
        carry = (z, z, z, torch.full((b, h_, dh), -1e30, dtype=torch.float32,
                                     device=x.device))
    r = p["r"].float()
    hs = []
    for t in range(pre.shape[1]):
        carry, h_t = _slstm_cell(r, carry, pre[:, t])
        hs.append(h_t)
    return torch.stack(hs, dim=1).to(dtype), carry


def _slstm_block(p, x, cfg: ModelConfig, carry=None):
    dtype = cfg.compute_dtype()
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    mixed, carry = _slstm_scan(p, h, cfg, carry)
    y = ein("bshk,hkd->bsd", mixed, p["w_out"].to(dtype), dtype=dtype)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_apply(p["mlp"], h2, "geglu", dtype)
    return x, carry


def slstm_block_apply(p, x, cfg, **_):
    y, _c = _slstm_block(p, x, cfg)
    return y


def slstm_block_prefill(p, x, cfg, *, cache, **_):
    y, (c, h, n, m) = _slstm_block(p, x, cfg)
    return y, {"c": c, "h": h, "n": n, "m": m}


def slstm_block_decode(p, x, cfg, *, cache, **_):
    carry = (cache["c"], cache["h"], cache["n"], cache["m"])
    y, (c, h, n, m) = _slstm_block(p, x, cfg, carry)
    return y, {"c": c, "h": h, "n": n, "m": m}


def slstm_cache_schema(cfg: ModelConfig, batch: int) -> dict:
    h, dh = cfg.n_heads, cfg.head_dim
    vec = ("cache_batch", "q_heads", "head_dim")
    return {
        "c": PSpec((batch, h, dh), vec, ("zeros",)),
        "h": PSpec((batch, h, dh), vec, ("zeros",)),
        "n": PSpec((batch, h, dh), vec, ("zeros",)),
        "m": PSpec((batch, h, dh), vec, ("const", -1e30)),
    }
