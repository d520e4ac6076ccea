"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Residual block = gated linear recurrence mixer + GeGLU MLP::

    gate = gelu(h @ W_gate)                       # [B,S,R]
    u    = causal_conv1d(h @ W_x)                 # width-4 depthwise
    r_t  = sigmoid(w_r u + b_r);  i_t = sigmoid(w_i u + b_i)
    log a_t = -c * softplus(Lambda) * r_t         # c = 8
    h_t  = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
    y    = (h_t * gate) @ W_out

The recurrence runs in the ``rglru_scan`` kernel
(:func:`repro_torch.kernels.ops.rglru_scan`) on the card, and in its plain
version on the CPU: a prefill scans the whole sequence, a decode step
scans one step from the carried state, and under autograd (training) the
backward runs the same kernel over reversed inputs.  The JAX package's prefill runs
``jax.lax.associative_scan`` over the same recurrence, which rounds in
another order, and its decode step ``a * h + b``, which the scan of one
step equals.  A caller may pass ``rglru_scan=`` to run another
implementation of the same function (``chip_smoke.py`` runs the plain
version on the card that way).  Parameters, caches and the order of the
other operations are the JAX package's (``repro/models/rglru.py``).
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

_C = 8.0  # Griffin's recurrence-gate temperature


def rglru_schema(cfg: ModelConfig) -> dict:
    d, r, f, cw = cfg.d_model, cfg.rnn_width, cfg.d_ff, cfg.conv_width
    s = 1.0 / np.sqrt(d)
    return {
        "ln1": PSpec((d,), ("norm",), ("zeros",)),
        "w_gate": PSpec((d, r), ("embed", "rnn"), ("normal", s)),
        "w_x": PSpec((d, r), ("embed", "rnn"), ("normal", s)),
        "conv_w": PSpec((cw, r), ("norm", "rnn"), ("normal", 0.5)),
        "conv_b": PSpec((r,), ("rnn",), ("zeros",)),
        "w_i": PSpec((r,), ("rnn",), ("ones",)),
        "b_i": PSpec((r,), ("rnn",), ("zeros",)),
        "w_r": PSpec((r,), ("rnn",), ("ones",)),
        "b_r": PSpec((r,), ("rnn",), ("zeros",)),
        # softplus(-5) ~= 0.0067 -> a ~= exp(-8*0.0067*sigmoid) in (0.95,1)
        "lam": PSpec((r,), ("rnn",), ("const", -5.0)),
        "w_out": PSpec((r, d), ("rnn", "embed"), ("normal", 1.0 / np.sqrt(r))),
        "ln2": PSpec((d,), ("norm",), ("zeros",)),
        "mlp": mlp_schema(d, f, cfg.activation),
    }


def _causal_conv(u, w, b, prev=None):
    """Depthwise causal conv: out_t = sum_j w[j] * u_{t-(cw-1-j)} + b, in
    u's dtype, the taps summed in order.

    u: [B,S,R]; w: [cw,R] (tap cw-1 = current step); prev: [B,cw-1,R]
    carries the trailing inputs across prefill/decode steps.
    """
    s, cw = u.shape[1], w.shape[0]
    if prev is None:
        full = F.pad(u, (0, 0, cw - 1, 0))
    else:
        full = torch.cat([prev.to(u.dtype), u], dim=1)
    acc = None
    for j in range(cw):
        term = full[:, j:j + s] * w[j].to(u.dtype)
        acc = term if acc is None else acc + term
    return acc + b.to(u.dtype)


def _gates(p, u):
    """-> (a, sqrt(1 - a^2) * i * u), both f32 [B,S,R]."""
    uf = u.float()
    i = torch.sigmoid(uf * p["w_i"] + p["b_i"])
    r = torch.sigmoid(uf * p["w_r"] + p["b_r"])
    log_a = -_C * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    # sqrt(1-a^2) with expm1 for stability near a=1.
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, beta * (i * uf)


def _gate_and_input(p, h, cfg: ModelConfig):
    """The GELU output gate and the recurrence's input u, both in the
    compute dtype."""
    dtype = cfg.compute_dtype()
    gate = F.gelu(
        ein("bsd,dr->bsr", h, p["w_gate"].to(dtype), dtype=dtype).float(),
        approximate="tanh").to(dtype)
    u = ein("bsd,dr->bsr", h, p["w_x"].to(dtype), dtype=dtype)
    return gate, u


def _mixer_train(p, h, cfg: ModelConfig, scan=None):
    """The mixer over a whole sequence from a zero state; -> (y, the
    state after its last step)."""
    dtype = cfg.compute_dtype()
    gate, u = _gate_and_input(p, h, cfg)
    uc = _causal_conv(u, p["conv_w"], p["conv_b"])
    a, bterm = _gates(p, uc)
    hseq = (scan or ops.rglru_scan)(a, bterm).to(dtype)
    y = ein("bsr,rd->bsd", hseq * gate, p["w_out"].to(dtype), dtype=dtype)
    state = {"h": hseq[:, -1].float(),
             "conv": u[:, -(cfg.conv_width - 1):].float()}
    return y, state


def _ffn(p, x, cfg: ModelConfig):
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg.activation, cfg.compute_dtype())


def rglru_block_apply(p, x, cfg: ModelConfig, *, rglru_scan=None, **_):
    """Full residual block (train/prefill, no cache). x: [B,S,D]."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, _state = _mixer_train(p, h, cfg, rglru_scan)
    return _ffn(p, x + y, cfg)


def rglru_block_prefill(p, x, cfg: ModelConfig, *, cache, rglru_scan=None,
                        **_):
    """Like apply, but also returns the state after the last step (the
    input cache is not read: a prefill starts from zeros)."""
    del cache
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, state = _mixer_train(p, h, cfg, rglru_scan)
    return _ffn(p, x + y, cfg), state


def rglru_block_decode(p, x, cfg: ModelConfig, *, cache, rglru_scan=None,
                       **_):
    """x: [B,1,D]; cache: {"h": [B,R] f32, "conv": [B,cw-1,R] f32}.  The
    input cache is not modified."""
    dtype = cfg.compute_dtype()
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    gate, u = _gate_and_input(p, h, cfg)
    uc = _causal_conv(u, p["conv_w"], p["conv_b"], prev=cache["conv"])
    a, bterm = _gates(p, uc)
    hnew = (rglru_scan or ops.rglru_scan)(a, bterm, cache["h"])[:, 0]
    y = ein("bsr,rd->bsd", hnew[:, None].to(dtype) * gate,
            p["w_out"].to(dtype), dtype=dtype)
    conv_new = torch.cat([cache["conv"][:, 1:], u.float()], dim=1)
    return _ffn(p, x + y, cfg), {"h": hnew, "conv": conv_new}


def rglru_cache_schema(cfg: ModelConfig, batch: int) -> dict:
    r, cw = cfg.rnn_width, cfg.conv_width
    return {
        "h": PSpec((batch, r), ("cache_batch", "rnn"), ("zeros",)),
        "conv": PSpec((batch, cw - 1, r), ("cache_batch", "norm", "rnn"),
                      ("zeros",)),
    }
