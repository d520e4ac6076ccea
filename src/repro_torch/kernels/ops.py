"""Dispatch of the model layers to the port's kernels.

Each entry point takes the JAX package's layout and sends its tensors to
the kernel's wrapper, which launches the CUDA kernel on CUDA tensors (for
every shape the kernel takes: unlike the reference's dispatch there is no
small-shape detour to the oracle) and runs the plain version on CPU
tensors.  The mLSTM block calls :func:`mlstm_scan`; the RG-LRU block
:func:`rglru_scan`; the attention layers call :func:`flash_attention`
(prefill and training) and :func:`decode_attention` (decode).

When grad mode is on and an input requires grad (training),
:func:`flash_attention` and :func:`rglru_scan` go through their
``torch.autograd.Function`` (:class:`~.flash_attention_bwd.
FlashAttentionFn`, :class:`~.rglru_scan.RGLRUScanFn`), whose backward is
a kernel too; otherwise, as in serving, straight to the kernel wrappers.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import mlstm_scan as _mlstm
from repro_torch.kernels import rglru_scan as _rglru


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: [B,H,S,dh]; k,v: [B,K,T,dh] -> [B,H,S,dh], laid out like q.
    Strided views are taken as they are (the head dim contiguous): the
    model's [B,S,H,dh] tensors arrive transposed, not copied."""
    if _needs_grad(q, k, v):
        return _flash_bwd.FlashAttentionFn.apply(q, k, v, causal, window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def decode_attention(q, k_cache, v_cache, lengths, starts=None):
    """q: [B,H,dh]; caches: [B,K,T,dh] (strided views taken as they are);
    lengths: [B] and starts: [B] or None (zeros): row b's valid slots are
    ``(starts[b] + j) mod T`` for ``j < lengths[b]`` -> [B,H,dh]."""
    if starts is not None:
        starts = starts.to(torch.int32)
    return _decode.decode_attention(q, k_cache, v_cache,
                                    lengths.to(torch.int32), starts)


def mlstm_scan(q, k, v, i_gate, f_gate, carry=None):
    """q,k,v: [B,H,S,dh]; gates: [B,H,S] -> (h [B,H,S,dh], (C, n, m)).
    Strided views are taken as they are (the head dim contiguous): the
    model's [B,S,H,dh] q, k, v and [B,S,H] gates arrive transposed, not
    copied.  Gates and the carry are taken in f32, the carry contiguous."""
    i_gate, f_gate = i_gate.float(), f_gate.float()
    if carry is not None:
        carry = tuple(t.float().contiguous() for t in carry)
    return _mlstm.mlstm_scan(q, k, v, i_gate, f_gate, carry)


def rglru_scan(a, x, h0=None):
    """a, x: [B,S,R]; h0: [B,R] or None -> h [B,S,R] in a's dtype.  The
    carry is taken in f32 and every operand contiguous, as the kernel
    takes them."""
    a, x = a.contiguous(), x.contiguous()
    if h0 is not None:
        h0 = h0.float().contiguous()
    if _needs_grad(a, x, h0):
        return _rglru.RGLRUScanFn.apply(a, x, h0)
    return _rglru.rglru_scan(a, x, h0)
