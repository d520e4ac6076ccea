"""Forward flash attention: one launch attends every (batch, q head) of
a prefill.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
with CUDA kernels written for Hopper (``csrc/flash_attention.cu``; its
header says what bounds them and how the design answers that).  The
semantics are the plain PyTorch version :func:`flash_attention_ref`
(``kernels/ref.py``).

:func:`flash_attention` launches a kernel on CUDA tensors, for every
``S, T >= 1`` (ragged ones included), and raises on anything the kernels
do not take; it never falls back.  The route is the inputs' type: bf16
runs the tensor-core kernel (``wgmma`` products fed by TMA; the
probabilities rounded to bf16 before p.v, as the JAX model rounds them),
f32 the f32 kernel (tensor cores would mean TF32).  On CPU tensors it runs
:func:`flash_attention_ref`.  ``flash_attention.launches`` counts the
kernel launches and ``flash_attention.launches_tc`` those of the
tensor-core route.  With ``return_lse=True`` it also returns the rows'
log-sum-exp (the training forward's, which the backward kernels take);
the CPU computes it with :func:`flash_attention_lse_ref`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_lse_ref, \
    flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_lse_ref",
           "HEAD_DIMS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128, 256)   # the head dims the kernel is built for


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be [B,H,S,dh] and k, v [B,K,T,dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, dh = q.shape
    kh, t = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {x.dtype}")
    if tuple(k.shape) != (b, kh, t, dh) or tuple(v.shape) != (b, kh, t, dh):
        raise ValueError(f"k and v must both be [{b},K,T,{dh}], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if kh < 1 or h % kh:
        raise ValueError(f"{h} q heads are not a multiple of {kh} kv heads")
    if min(b, h, s, t) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def tma_strides(x, name) -> list:
    """The three outer element strides of a bf16 [B, heads, rows, dh]
    operand that the tensor-core kernels read through TMA, which needs its
    base and strides at multiples of 16 bytes; a dimension of size 1 gets
    the dense stride (its index is always 0).  Raises on the rest."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start at a multiple of 16 bytes for "
                         f"the tensor-core kernels (TMA)")
    out, dense = [], x.shape[3]
    for i in (2, 1, 0):
        if x.shape[i] == 1:
            out.append(dense)
        elif (x.stride(i) * x.element_size()) % 16:
            raise ValueError(f"{name}'s stride {x.stride(i)} of dim {i} is "
                             f"not a multiple of 16 bytes, which the "
                             f"tensor-core kernels (TMA) need")
        else:
            out.append(x.stride(i))
        dense *= x.shape[i]
    return out[::-1]


def tma_ok(x) -> bool:
    """Whether :func:`tma_strides` takes ``x``."""
    try:
        tma_strides(x, "x")
    except ValueError:
        return False
    return True


def flash_attention(q, k, v, *, causal=True, window=0, return_lse=False):
    """q: [B,H,S,dh]; k,v: [B,K,T,dh] (GQA: H % K == 0) -> [B,H,S,dh] in
    q's dtype, laid out like q.  f32 or bf16; any strides with the head
    dim contiguous (the model passes transposed views), and for bf16 the
    bases and strides of q, k, v at multiples of 16 bytes.  With
    ``return_lse`` -> (out, lse [B,H,S] f32): each row's log-sum-exp of
    its scaled, masked scores, +inf for a row that no key may see.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`flash_attention_ref` (and :func:`flash_attention_lse_ref`)."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        out = flash_attention_ref(q, k, v, causal=causal, window=window)
        if not return_lse:
            return out
        return out, flash_attention_lse_ref(q, k, causal=causal,
                                            window=window)
    if dev.type != "cuda":
        raise ValueError(f"the flash_attention kernel runs on CUDA tensors, "
                         f"not {dev}")
    b, h, s, dh = q.shape
    kh, t = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {dh}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    out = torch.empty_like(q)
    if out.stride(3) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) \
        if return_lse else None
    if q.dtype == torch.bfloat16:
        outer = [tma_strides(x, name) for x, name in ((q, "q"), (k, "k"),
                                                       (v, "v"))]
    else:
        outer = [[x.stride(i) for i in range(3)] for x in (q, k, v)]
    outer.append([out.stride(i) for i in range(3)])
    strides = (ctypes.c_longlong * 12)(*(st for x in outer for st in x))
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, kh, s, t, dh,
        strides, float(1.0 / np.sqrt(dh)), int(bool(causal)), int(window),
        _DTYPES[q.dtype], index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    flash_attention.launches_tc += q.dtype == torch.bfloat16
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_tc = 0
