"""Single-token decode attention: one launch attends every (batch, kv
head) of a decode step against its KV cache.

Replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention`` with CUDA kernels
written for Hopper (``csrc/decode_attention.cu``; its header says what
bounds them and how the design answers that).  The semantics are the
plain PyTorch version :func:`decode_attention_ref` (``kernels/ref.py``):
row ``b``'s valid slots are the ring run ``(starts[b] + j) mod T`` for
``j < lengths[b]``, a prefix when ``starts`` is None or zero.

Each row's run is split over ``splits`` blocks (:func:`plan_splits`,
from T, B x K and the card's SM count, never from the lengths), each
writing an f32 partial that a second kernel merges in order (the
partials' buffer is kept per device, stream and size);
:func:`decode_attention_split_ref` (``kernels/ref.py``) is the plain
form of that arithmetic.

:func:`decode_attention` launches the kernels on CUDA tensors, for every
``T >= 1`` and every length, and raises on anything they do not take; it
never falls back.  On CPU tensors it runs :func:`decode_attention_ref`.
``decode_attention.launches`` counts the calls that launched,
``decode_attention.launches_split`` those that also ran the merge.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.device import sm_count as _sm_count
from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref", "plan_splits",
           "HEAD_DIMS", "MAX_OUTPUTS", "MAX_GROUP"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)       # the head dims the kernel is built for
MAX_OUTPUTS = 4096                   # g * dh of a group, at most
MAX_GROUP = 32                       # g: 4 warps of at most 8 rows
MIN_SPLIT_ROWS = 8                   # cache rows of T per split, at least
MAX_SPLITS = 64


def plan_splits(b: int, kh: int, t: int, g: int, dh: int, esize: int,
                sms: int) -> int:
    """Blocks each (batch, kv head) row's run is split over: enough that
    the grid's ``splits x kh x b`` blocks reach ``sms`` (one per SM), no
    more than ``t / MIN_SPLIT_ROWS`` or ``MAX_SPLITS``, and with the f32
    partials (``b x kh x splits x g x (dh + 2)`` x 4 bytes) within the
    bytes of the caches' ``t`` rows (``2 x b x kh x t x dh x esize``).
    Depends on shapes only, so it costs no synchronisation."""
    want = -(-sms // (b * kh))
    by_rows = max(1, t // MIN_SPLIT_ROWS)
    by_scratch = (2 * t * dh * esize) // (4 * g * (dh + 2))
    return max(1, min(want, by_rows, by_scratch, MAX_SPLITS))


@functools.lru_cache(maxsize=256)
def _layout(index, b, h, kh, t, dh, esize, qs, ks, vs) -> tuple:
    """The kernels' stride array (q, the caches and the dense output, in
    elements) and the planned split count for one shape and layout,
    checked once: raise on anything the kernels do not take."""
    g = h // kh
    if dh not in HEAD_DIMS:
        raise ValueError(f"the decode_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {dh}")
    if g * dh > MAX_OUTPUTS or g > MAX_GROUP:
        raise ValueError(f"a GQA group of {g} heads of {dh} is over the "
                         f"kernel's {MAX_GROUP} heads or {MAX_OUTPUTS} "
                         f"outputs per block")
    if qs[-1] != 1 or ks[-1] != 1 or vs[-1] != 1:
        raise ValueError("the head dim of q and the caches must be "
                         "contiguous")
    st = (*qs[:2], *ks[:3], *vs[:3])
    sizes = (b, h, b, kh, t, b, kh, t)     # a dim of one: stride unused
    if any(x * esize % 16 for x, n in zip(st, sizes) if n > 1):
        raise ValueError("the outer strides of q and the caches must be "
                         "multiples of 16 bytes (cp.async)")
    strides = (ctypes.c_longlong * 10)(*st, h * dh, dh)
    return strides, plan_splits(b, kh, t, g, dh, esize, _sm_count(index))


@functools.lru_cache(maxsize=64)
def _scratch(index: int, stream: int, n: int) -> torch.Tensor:
    """The merge's f32 partials, one buffer per device, stream and size,
    kept across calls: each call's split kernel writes it and its merge
    reads it before the next call's kernels run on the same stream."""
    return torch.empty(n, dtype=torch.float32,
                       device=torch.device("cuda", index))


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
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


def decode_attention(q, k_cache, v_cache, lengths, starts=None, *,
                     splits=None):
    """q: [B,H,dh]; caches: [B,K,T,dh] (GQA: H % K == 0); lengths, starts:
    [B] int32 (starts None: zeros), row b's valid slots
    ``(starts[b] + j) mod T`` for ``j < lengths[b]`` -> [B,H,dh] in q's
    dtype.  f32 or bf16; any strides with the head dim contiguous (the
    model passes its [B,T,K,dh] caches as transposed views); the base
    and outer strides of q and the caches multiples of 16 bytes.

    ``splits`` (None: :func:`plan_splits`) forces the number of blocks
    each row's run is split over; ``chip_smoke.py`` passes 1 to time the
    unsplit kernel against the planned split.

    CUDA tensors launch the kernels (or raise); CPU tensors run
    :func:`decode_attention_ref`."""
    _check(q, k_cache, v_cache, lengths, starts)
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths, starts)
    if dev.type != "cuda":
        raise ValueError(f"the decode_attention kernel runs on CUDA tensors, "
                         f"not {dev}")
    b, h, dh = q.shape
    _, kh, t, _ = k_cache.shape
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    strides, planned = _layout(index, b, h, kh, t, dh, q.element_size(),
                               q.stride(), k_cache.stride(),
                               v_cache.stride())
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("the base addresses of q and the caches must be "
                         "multiples of 16 bytes (cp.async)")
    if splits is None:
        splits = planned
    elif not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be in [1, {MAX_SPLITS}], got "
                         f"{splits}")
    lengths = lengths.contiguous()
    if starts is not None:
        starts = starts.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((b, h, dh), dtype=q.dtype, device=dev)
    part = None if splits == 1 else \
        _scratch(index, stream, b * h * splits * (dh + 2))
    lib = _lib()
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), None if starts is None else starts.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), b, h,
        kh, t, dh, splits, strides, float(1.0 / np.sqrt(dh)),
        _DTYPES[q.dtype], index, stream)
    if err != 0:
        raise RuntimeError("decode_attention kernel launch failed: "
                           + lib.decode_attention_error_string(err).decode())
    decode_attention.launches += 1
    decode_attention.launches_split += splits > 1
    return out


decode_attention.launches = 0
decode_attention.launches_split = 0
