"""Plain PyTorch versions of the port's kernels that live outside their
wrapper module: the oracles the CPU tests hold against the JAX package
and that ``chip_smoke.py`` holds the CUDA kernels against on the card.
They keep the layouts and signatures of the JAX package's
``repro/kernels/ref.py``."""

from __future__ import annotations

import numpy as np
import torch


def attention_mask(s: int, t: int, causal: bool, window: int, device):
    """[S, T] bool: key j is visible to query i (all of them unless
    ``causal``: ``j <= i`` and, with a ``window``, ``j > i - window``)."""
    iq = torch.arange(s, device=device)[:, None]
    jk = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask = jk <= iq
        if window:
            mask = mask & (jk > iq - window)
    return mask


def _masked_scores(q, k, causal, window, row0=0):
    """f32 scores [B,K,g,S,T] (GQA groups written out), ``-inf`` where
    masked; q's rows are the queries from ``row0`` on."""
    b, h, s, dh = q.shape
    kh, t = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, kh, h // kh, s, dh)
    scores = torch.einsum("bkgsd,bktd->bkgst", qf, k.float()) \
        / float(np.sqrt(dh))
    mask = attention_mask(row0 + s, t, causal, window, q.device)[row0:]
    return scores.masked_fill(~mask, float("-inf"))


# The most f32 scores the plain attention holds at once (1 GiB).  A call
# with more (llava-next-mistral-7b's prefill, 8 x 32 heads x 3,008^2: 9.3
# GB) runs in blocks of query rows, each row's arithmetic unchanged.
SCORE_BLOCK = 1 << 28


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: [B,H,S,dh]; k,v: [B,K,T,dh] (GQA: H % K == 0) -> [B,H,S,dh].

    f32 scores, softmax and P.V; masked scores are ``-inf`` (a row with no
    valid key comes out NaN); the result in q's dtype.  Over
    ``SCORE_BLOCK`` scores, in blocks of query rows."""
    b, h, s, _ = q.shape
    rows = max(1, SCORE_BLOCK // (b * h * k.shape[2]))
    if rows < s:
        return torch.cat([
            _flash_rows(q[:, :, i:i + rows], k, v, causal, window, i)
            for i in range(0, s, rows)], dim=2)
    return _flash_rows(q, k, v, causal, window, 0)


def _flash_rows(q, k, v, causal, window, row0):
    """:func:`flash_attention_ref` of the queries from ``row0`` on."""
    b, h, s, dh = q.shape
    scores = _masked_scores(q, k, causal, window, row0)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    return out.reshape(b, h, s, dh).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal=True, window=0):
    """The softmax's log-sum-exp rows [B,H,S] f32 of the scaled, masked
    scores (the training forward's second output); ``+inf`` for a row
    that no key may see, so that every probability of it is 0."""
    b, h, s, _ = q.shape
    lse = torch.logsumexp(_masked_scores(q, k, causal, window), dim=-1)
    lse = lse.masked_fill(lse == float("-inf"), float("inf"))
    return lse.reshape(b, h, s)


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal=True,
                            window=0):
    """(dq [B,H,S,dh] in q's dtype, dk, dv [B,K,T,dh] in k's) of
    attention, step by step in f32 as the TPU kernels compute them
    (``repro/kernels/flash_attention_bwd.py:162-222``), over the expanded
    heads and group-summed at the end: ``delta = rowsum(o * do)``,
    ``p = exp(s - lse)`` under the mask, ``ds = p (do v^T - delta)
    scale``, ``dq = ds k``, ``dk = ds^T q``, ``dv = p^T do``."""
    b, h, s, dh = q.shape
    kh, t = k.shape[1], k.shape[2]
    g = h // kh
    scale = float(1.0 / np.sqrt(dh))
    qf, dof = q.float(), do.float()
    kx = k.float().repeat_interleave(g, dim=1)
    vx = v.float().repeat_interleave(g, dim=1)
    delta = torch.sum(out.float() * dof, dim=-1)                 # [B,H,S]
    scores = torch.einsum("bhsd,bhtd->bhst", qf, kx) * scale
    mask = attention_mask(s, t, causal, window, q.device)
    p = torch.where(mask, torch.exp(scores - lse[..., None]),
                    torch.zeros((), device=q.device))
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vx)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kx)
    dkh = torch.einsum("bhst,bhsd->bhtd", ds, qf)
    dvh = torch.einsum("bhst,bhsd->bhtd", p, dof)
    dk = dkh.reshape(b, kh, g, t, dh).sum(dim=2)
    dv = dvh.reshape(b, kh, g, t, dh).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def decode_split_ranges(lengths, t: int, splits: int):
    """(j0, j1) [B, splits] int64: the run positions ``[j0, j1)`` each
    split of row b takes in ``csrc/decode_attention.cu``, ``per =
    ceil(len / splits)`` of them from ``split x per``, len clamped to
    ``[0, t]``."""
    n = torch.clamp(lengths.long(), 0, t)[:, None]
    per = (n + splits - 1) // splits
    j0 = torch.minimum(n, torch.arange(splits, device=n.device) * per)
    return j0, torch.minimum(n, j0 + per)


def decode_attention_split_ref(q, k_cache, v_cache, lengths, starts=None,
                               *, splits: int):
    """:func:`decode_attention_ref` as ``csrc/decode_attention.cu``
    computes it.  Each row's run is split ``splits`` ways
    (:func:`decode_split_ranges`); per split s, in f32, the max ``m_s`` of
    the scaled scores over its positions, ``l_s = sum exp(s - m_s)`` and
    ``acc_s = sum exp(s - m_s) v`` (a split with no position: ``m_s =
    -1e30``, ``l_s = 0``, ``acc_s = 0``); then the merge in split order,
    ``o = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30)`` with ``w_s =
    exp(m_s - max_s m_s)``.  A row of length 0 gives zeros."""
    b, h, dh = q.shape
    kh, t = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    j0, j1 = decode_split_ranges(lengths.to(q.device), t, splits)
    qf = q.float().reshape(b, kh, g, dh)
    scores = torch.einsum("bkgd,bktd->bkgt", qf, k_cache.float()) \
        / float(np.sqrt(dh))
    pos = torch.arange(t, device=q.device)[None, :]              # slot
    if starts is not None:
        pos = torch.remainder(pos - starts.to(q.device)[:, None], t)
    # [B,1,S,1,T]: the slot is one of split s's run positions
    take = ((pos[:, None, :] >= j0[:, :, None])
            & (pos[:, None, :] < j1[:, :, None]))[:, None, :, None, :]
    s = scores[:, :, None].masked_fill(~take, -1e30)            # [B,K,S,g,T]
    m = s.amax(dim=-1)                                           # [B,K,S,g]
    p = torch.exp(s - m[..., None]) * take
    acc = torch.einsum("bksgt,bktd->bksgd", p, v_cache.float())
    l = p.sum(dim=-1)
    w = torch.exp(m - m.amax(dim=2, keepdim=True))
    big_l = torch.zeros_like(m[:, :, 0])
    out = torch.zeros_like(acc[:, :, 0])
    for i in range(splits):
        big_l = big_l + w[:, :, i] * l[:, :, i]
        out = out + w[:, :, i, :, None] * acc[:, :, i]
    out = out / torch.clamp_min(big_l, 1e-30)[..., None]
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


def rglru_scan_bwd_ref(a, h, dh, h0=None):
    """The VJP of :func:`rglru_scan_ref` as a reverse time loop in f32:
    ``g_t = dh_t + a_{t+1} g_{t+1}`` (the product, then the sum), then
    ``dx_t = g_t``, ``da_t = g_t h_{t-1}`` (``h_{-1}`` = h0, or 0) and
    ``dh0 = a_0 g_0``.  a, h, dh: [B,S,R] (h the forward's output); h0:
    [B,R] f32 or None -> (da, dx in a's dtype, dh0 f32 or None)."""
    af, hf, gf = a.float(), h.float(), dh.float()
    s = a.shape[1]
    g = gf[:, s - 1]
    gs = [g]
    for t in range(s - 2, -1, -1):
        g = af[:, t + 1] * g + gf[:, t]
        gs.append(g)
    g = torch.stack(gs[::-1], dim=1)
    first = torch.zeros_like(hf[:, :1]) if h0 is None \
        else h0.float()[:, None]
    h_prev = torch.cat([first, hf[:, :-1]], dim=1)
    da = (g * h_prev).to(a.dtype)
    dh0 = None if h0 is None else af[:, 0] * g[:, 0]
    return da, g.to(a.dtype), dh0


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


def _adjacent_pairs(p: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (a power of two long) in adjacent pairs, level by
    level: the order of shuffles xor 1, 2, 4, ... across lanes."""
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def _in_order(terms) -> torch.Tensor:
    """Left-to-right sum of the products in ``terms``, one rounding each."""
    acc = None
    for t in terms:
        acc = t if acc is None else acc + t
    return acc


def mlstm_scan_rows_ref(q, k, v, i_gate, f_gate, carry=None, *,
                        row_block=32, col_groups=4):
    """:func:`mlstm_scan_ref` as ``csrc/mlstm_scan.cu`` computes it.  Each
    head's rows are split into blocks of ``row_block``; each block runs the
    gates' scalars and all of n itself and updates its rows of C in the
    reference's order (f32, each product and sum rounded on its own).  The
    two sums take the kernel's order:

    * ``(C q)_i``: lane g of ``col_groups`` keeps four partial sums
      ``p_e``, each over its columns ``4 G c + 4 g + e`` in the order of c,
      and adds them as ``(p0 + p1) + (p2 + p3)``; the lanes then combine in
      adjacent pairs.
    * ``n . q``: lane l of 32 sums ``n_j q_j`` over ``j = l, l + 32, ...``;
      the 32 lanes then combine in adjacent pairs.

    Shapes and carry as :func:`mlstm_scan_ref`; dh a multiple of 32, of
    ``row_block`` and of ``4 col_groups``."""
    b, h, s, dh = q.shape
    g = col_groups
    if dh % 32 or dh % row_block or dh % (4 * g):
        raise ValueError(f"head_dim {dh} does not split into blocks of "
                         f"{row_block} rows and {g} groups of 4 columns")
    if carry is None:
        C0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
        n0 = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
        m0 = torch.full((b, h), -1e30, dtype=torch.float32, device=q.device)
    else:
        C0, n0, m0 = (t.float() for t in carry)
    qf, kf, vf = q.float(), k.float(), v.float()
    ig, fg = i_gate.float(), f_gate.float()
    hs = torch.empty((b, h, s, dh), dtype=torch.float32, device=q.device)
    C_out = torch.empty_like(C0)
    for r0 in range(0, dh, row_block):
        rows = slice(r0, r0 + row_block)
        C, n, m = C0[:, :, rows], n0, m0
        for t in range(s):
            qt, kt, vt = qf[:, :, t], kf[:, :, t], vf[:, :, t]
            log_f = -softplus(-fg[:, :, t])
            m_new = torch.maximum(log_f + m, ig[:, :, t])
            i_p = torch.exp(ig[:, :, t] - m_new)[..., None]
            f_p = torch.exp(log_f + m - m_new)[..., None]
            C = f_p[..., None] * C + i_p[..., None] * (
                vt[..., rows, None] * kt[..., None, :])
            n = f_p * n + i_p * kt
            # [B,H,rows,dh/(4G),G,4] and [B,H,1,dh/(4G),G,4]: lane g's
            # columns, in its order.
            Cg = C.reshape(b, h, row_block, dh // (4 * g), g, 4)
            qg = qt.reshape(b, h, 1, dh // (4 * g), g, 4)
            p = [_in_order(Cg[..., c, :, e] * qg[..., c, :, e]
                           for c in range(dh // (4 * g))) for e in range(4)]
            num = _adjacent_pairs((p[0] + p[1]) + (p[2] + p[3]))
            nl, ql = n.reshape(b, h, dh // 32, 32), qt.reshape(b, h,
                                                               dh // 32, 32)
            den = torch.abs(_adjacent_pairs(_in_order(
                nl[..., j, :] * ql[..., j, :] for j in range(dh // 32))))
            hs[:, :, t, rows] = num / torch.clamp_min(den, 1.0)[..., None]
            m = m_new
        C_out[:, :, rows] = C
    return hs.to(q.dtype), (C_out, n, m)
