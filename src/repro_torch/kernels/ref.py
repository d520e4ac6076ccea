"""Plain PyTorch versions of the port's kernels that live outside their
wrapper module: the oracles the CPU tests hold against the JAX package
and that ``chip_smoke.py`` holds the CUDA kernels against on the card.
They keep the layouts and signatures of the JAX package's
``repro/kernels/ref.py``."""

from __future__ import annotations

import numpy as np
import torch


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: [B,H,S,dh]; k,v: [B,K,T,dh] (GQA: H % K == 0) -> [B,H,S,dh].

    f32 scores, softmax and P.V; masked scores are ``-inf`` (a row with no
    valid key comes out NaN); the result in q's dtype."""
    b, h, s, dh = q.shape
    kh, t = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.float().reshape(b, kh, g, s, dh)
    scores = torch.einsum("bkgsd,bktd->bkgst", qf, k.float()) \
        / float(np.sqrt(dh))
    iq = torch.arange(s, device=q.device)[:, None]
    jk = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = jk <= iq
        if window:
            mask = mask & (jk > iq - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    return out.reshape(b, h, s, dh).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths, starts=None):
    """q: [B,H,dh]; caches: [B,K,T,dh]; lengths: [B]; starts: [B] or None
    (zeros) -> [B,H,dh].

    Row b's valid slots are the ring run ``(starts[b] + j) mod T`` for
    ``j < lengths[b]`` (a prefix when ``starts[b] == 0``); f32
    throughout, masked scores ``-inf``; the result in q's dtype."""
    b, h, dh = q.shape
    kh, t = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qf = q.float().reshape(b, kh, g, dh)
    scores = torch.einsum("bkgd,bktd->bkgt", qf, k_cache.float()) \
        / float(np.sqrt(dh))
    slot = torch.arange(t, device=q.device)[None, :]
    if starts is not None:
        slot = torch.remainder(slot - starts.to(q.device)[:, None], t)
    valid = slot < lengths.to(q.device)[:, None]                 # [B,T]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (not ``F.softplus``, which
    switches to ``x`` above 20 and rounds differently below)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_scan_ref(a, x, h0=None):
    """``h_t = a_t * h_{t-1} + x_t`` per (batch, channel), a time loop in
    f32 (the product, then the sum).  a, x: [B,S,R]; h0: [B,R] f32 or
    None (zeros) -> h [B,S,R] in a's dtype."""
    af, xf = a.float(), x.float()
    h = torch.zeros_like(af[:, 0]) if h0 is None else h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + xf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def mlstm_scan_ref(q, k, v, i_gate, f_gate, carry=None):
    """Stabilized mLSTM recurrence (the model's semantics), in f32.

    q,k,v: [B,H,S,dh] (k pre-scaled); gates: [B,H,S]; carry
    ``(C [B,H,dh,dh], n [B,H,dh], m [B,H])`` or None for zeros and
    ``m = -1e30``.  -> (h [B,H,S,dh] in q's dtype, final (C, n, m)).
    """
    b, h, s, dh = q.shape
    if carry is None:
        C = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
        m = torch.full((b, h), -1e30, dtype=torch.float32, device=q.device)
    else:
        C, n, m = (t.float() for t in carry)
    qf, kf, vf = q.float(), k.float(), v.float()
    ig, fg = i_gate.float(), f_gate.float()
    hs = []
    for t in range(s):
        qt, kt, vt = qf[:, :, t], kf[:, :, t], vf[:, :, t]
        it, ft = ig[:, :, t], fg[:, :, t]
        log_f = -softplus(-ft)
        m_new = torch.maximum(log_f + m, it)
        i_p = torch.exp(it - m_new)[..., None]
        f_p = torch.exp(log_f + m - m_new)[..., None]
        C = f_p[..., None] * C + i_p[..., None] * (vt[..., :, None]
                                                   * kt[..., None, :])
        n = f_p * n + i_p * kt
        num = torch.einsum("bhij,bhj->bhi", C, qt)
        den = torch.abs(torch.einsum("bhj,bhj->bh", n, qt))[..., None]
        hs.append(num / torch.clamp_min(den, 1.0))
        m = m_new
    return torch.stack(hs, dim=2).to(q.dtype), (C, n, m)
