"""Plain PyTorch versions of the port's kernels that live outside their
wrapper module: the oracles the CPU tests hold against the JAX package
and that ``chip_smoke.py`` holds the CUDA kernels against on the card."""

from __future__ import annotations

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (not ``F.softplus``, which
    switches to ``x`` above 20 and rounds differently below)."""
    return torch.logaddexp(x, torch.zeros_like(x))


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
