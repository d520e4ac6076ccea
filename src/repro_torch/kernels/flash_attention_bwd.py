"""Backward flash attention: one call computes (dq, dk, dv) of every
(batch, head) of a training forward, and :class:`FlashAttentionFn` makes
the forward kernel differentiable with it.

Replaces the TPU kernel
``repro/kernels/flash_attention_bwd.py::flash_attention_bwd`` (its
``_dq_kernel`` and ``_dkv_kernel``) with CUDA kernels written for Hopper
(``csrc/flash_attention_bwd.cu``; its header says what bounds them and how
the design answers that).  The semantics are the plain PyTorch version
:func:`flash_attention_bwd_ref` (``kernels/ref.py``).

:func:`flash_attention_bwd` launches the kernels on CUDA tensors, for
every ``S, T >= 1`` (ragged ones included), and raises on anything they
do not take; it never falls back.  The route is the inputs' type: bf16
runs the tensor-core kernels (``wgmma`` products fed by TMA; p rounded to
bf16 before dv, ds before dq and dk), f32 the f32 kernels.  On CPU tensors
it runs :func:`flash_attention_bwd_ref`.  ``flash_attention_bwd.launches``
counts the calls that launched the kernels (each launches a delta, a dq
and a dk/dv kernel, and on the bf16 route, when the dk/dv blocks split
their work, a pass that sums the splits), ``flash_attention_bwd.
launches_tc`` those of the tensor-core route.

:class:`FlashAttentionFn` runs the forward kernel with its log-sum-exp
rows and saves q, k, v, the output and the rows; its backward is
:func:`flash_attention_bwd`, inside the profiler range
``repro_torch.flash_attention_bwd``.  An incoming gradient whose head dim
is not contiguous, or (on CUDA) whose base or strides break the TMA rule,
is copied first; ``FlashAttentionFn.do_copies`` counts those copies.  On the CPU the same Function runs
the plain forward and the plain backward, so the CPU tests hold the plain
backward, not PyTorch's autograd of the plain forward, against JAX.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _DTYPES, _check, \
    flash_attention, tma_ok, tma_strides
from repro_torch.kernels.ref import flash_attention_bwd_ref

__all__ = ["flash_attention_bwd", "flash_attention_bwd_ref",
           "FlashAttentionFn", "HEAD_DIMS"]

# The head dims the kernels are built for: the forward's but 80, whose
# backward (hubert-xlarge's training) is not written yet.
HEAD_DIMS = (32, 64, 128, 256)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_bwd(q, k, v, out, lse, do) -> None:
    """Raise on anything the kernels do not take."""
    _check(q, k, v)
    b, h, s, _ = q.shape
    for name, x in (("out", out), ("do", do)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {x.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, "
                             f"got {tuple(x.shape)}")
    if lse.device != q.device or lse.dtype != torch.float32 or \
            tuple(lse.shape) != (b, h, s):
        raise ValueError(f"lse must be [{b},{h},{s}] float32 on {q.device}, "
                         f"got {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}")


def _empty_like(x) -> torch.Tensor:
    """An output laid out like ``x`` (a transposed view stays one), with
    the head dim contiguous."""
    y = torch.empty_like(x)
    return y if y.stride(3) == 1 else torch.empty(x.shape, dtype=x.dtype,
                                                  device=x.device)


def dkv_splits(b, kh, t, sms) -> int:
    """How many blocks share each kv tile's dk/dv work on the bf16 route:
    enough to put a block on each of ``sms`` SMs when the T / 64 x K x B
    tiles are fewer (at most 5), else 1."""
    blocks = -(-t // 64) * kh * b
    return max(1, min(5, sms // blocks))


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=True, window=0):
    """q, out, do: [B,H,S,dh]; k, v: [B,K,T,dh] (GQA: H % K == 0); lse:
    [B,H,S] f32, the forward's -> (dq [B,H,S,dh] in q's dtype, laid out
    like q; dk, dv [B,K,T,dh] in k's dtype, laid out like k, v).  f32 or
    bf16; any strides with the head dim contiguous, and for bf16 the bases
    and strides of q, k, v and do at multiples of 16 bytes.

    CUDA tensors launch the kernels (or raise); CPU tensors run
    :func:`flash_attention_bwd_ref`."""
    _check_bwd(q, k, v, out, lse, do)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                       window=window)
    if dev.type != "cuda":
        raise ValueError(f"the flash_attention_bwd kernels run on CUDA "
                         f"tensors, not {dev}")
    b, h, s, dh = q.shape
    kh, t = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash_attention_bwd kernels take head dims "
                         f"{HEAD_DIMS}, got {dh}")
    if any(x.stride(3) != 1 for x in (q, k, v, out, do)):
        raise ValueError("the head dim of q, k, v, out and do must be "
                         "contiguous")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    dq, dk, dv = _empty_like(q), _empty_like(k), _empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    tc = q.dtype == torch.bfloat16
    outer = [[x.stride(i) for i in range(3)] for x in
             (q, k, v, out, do, dq, dk, dv)]
    part, splits = None, 1
    if tc:
        for i, name in ((0, "q"), (1, "k"), (2, "v"), (4, "do")):
            outer[i] = tma_strides((q, k, v, out, do)[i], name)
        splits = dkv_splits(b, kh, t, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        if splits > 1:
            part = torch.empty((2, splits, b, kh, t, dh),
                               dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 24)(*(st for x in outer for st in x))
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    lib = _lib()
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(), splits, b, h, kh, s, t,
        dh, strides,
        float(1.0 / np.sqrt(dh)), int(bool(causal)), int(window),
        _DTYPES[q.dtype], index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention_bwd kernel launch failed: "
                           + lib.flash_attention_bwd_error_string(err)
                           .decode())
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_tc += tc
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_tc = 0


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable attention: ``FlashAttentionFn.apply(q, k, v, causal,
    window)`` -> out, as :func:`flash_attention`; the backward is
    :func:`flash_attention_bwd` (dq in q's dtype, dk and dv in k's)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        with record_function("repro_torch.flash_attention_bwd"):
            if do.stride(3) != 1 or (do.is_cuda and not tma_ok(do)):
                do = do.contiguous()
                FlashAttentionFn.do_copies += 1
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                             do.to(q.dtype),
                                             causal=ctx.causal,
                                             window=ctx.window)
        return dq, dk, dv, None, None


FlashAttentionFn.do_copies = 0
