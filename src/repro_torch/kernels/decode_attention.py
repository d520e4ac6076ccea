"""Single-token decode attention: one launch attends every (batch, kv
head) of a decode step against its KV cache.

Replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention`` with a CUDA kernel
written for Hopper (``csrc/decode_attention.cu``; its header says what
bounds it and how the design answers that).  The semantics are the plain
PyTorch version :func:`decode_attention_ref` (``kernels/ref.py``): row
``b``'s valid slots are the ring run ``(starts[b] + j) mod T`` for
``j < lengths[b]``, a prefix when ``starts`` is None or zero.

:func:`decode_attention` launches the kernel on CUDA tensors, for every
``T >= 1`` and every length, and raises on anything the kernel does not
take; it never falls back.  On CPU tensors it runs
:func:`decode_attention_ref`.  ``decode_attention.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref", "HEAD_DIMS",
           "MAX_OUTPUTS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)       # the head dims the kernel is built for
MAX_OUTPUTS = 4096                   # g * dh one block holds (16 x 256)
_SMEM_LIMIT = 232_448                # dynamic shared memory of one block


def smem_bytes(g: int, dh: int) -> int:
    """Shared memory of one block: the group's q rows, one k tile (rows
    padded to dh + 1) and one v tile of 64 rows, the tile's scores and
    three per-row floats (f32)."""
    return 4 * (g * dh + 64 * (dh + 1) + 64 * dh + 64 * g + 3 * g)


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_cache, v_cache, lengths, starts) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(f"q must be [B,H,dh] and the caches [B,K,T,dh], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, h, dh = q.shape
    kh, t = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q and the caches must be float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {x.dtype}")
        if tuple(x.shape) != (b, kh, t, dh):
            raise ValueError(f"{name} must be [{b},{kh},{t},{dh}], got "
                             f"{tuple(x.shape)}")
    if kh < 1 or h % kh:
        raise ValueError(f"{h} q heads are not a multiple of {kh} kv heads")
    if min(b, t) < 1:
        raise ValueError(f"empty decode: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}")
    for name, x in (("lengths", lengths), ("starts", starts)):
        if x is not None and (x.device != q.device or x.dtype != torch.int32
                              or tuple(x.shape) != (b,)):
            raise ValueError(f"{name} must be int32 [{b}] on {q.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")


def decode_attention(q, k_cache, v_cache, lengths, starts=None):
    """q: [B,H,dh]; caches: [B,K,T,dh] (GQA: H % K == 0); lengths, starts:
    [B] int32 (starts None: zeros), row b's valid slots
    ``(starts[b] + j) mod T`` for ``j < lengths[b]`` -> [B,H,dh] in q's
    dtype.  f32 or bf16; any strides with the head dim contiguous (the
    model passes its [B,T,K,dh] caches as transposed views).

    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`decode_attention_ref`."""
    _check(q, k_cache, v_cache, lengths, starts)
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths, starts)
    if dev.type != "cuda":
        raise ValueError(f"the decode_attention kernel runs on CUDA tensors, "
                         f"not {dev}")
    b, h, dh = q.shape
    kh, t = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    if dh not in HEAD_DIMS:
        raise ValueError(f"the decode_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {dh}")
    if g * dh > MAX_OUTPUTS or smem_bytes(g, dh) > _SMEM_LIMIT:
        raise ValueError(f"a GQA group of {g} heads of {dh} is over the "
                         f"kernel's {MAX_OUTPUTS} outputs per block")
    if any(x.stride(-1) != 1 for x in (q, k_cache, v_cache)):
        raise ValueError("the head dim of q and the caches must be "
                         "contiguous")
    lengths = lengths.contiguous()
    if starts is not None:
        starts = starts.contiguous()
    out = torch.empty((b, h, dh), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k_cache.stride()[:3],
        *v_cache.stride()[:3], out.stride(0), out.stride(1))
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    lib = _lib()
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), None if starts is None else starts.data_ptr(),
        out.data_ptr(), b, h, kh, t, dh, strides,
        float(1.0 / np.sqrt(dh)), _DTYPES[q.dtype], index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("decode_attention kernel launch failed: "
                           + lib.decode_attention_error_string(err).decode())
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
