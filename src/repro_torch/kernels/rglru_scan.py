"""The RG-LRU linear recurrence: one launch runs ``S`` steps of every
(batch, channel) lane.

Replaces the TPU kernel ``repro/kernels/rglru_scan.py::rglru_scan`` with a
CUDA kernel written for Hopper (``csrc/rglru_scan.cu``; its header says
what bounds it and how the design answers that).  The semantics are the
plain PyTorch version :func:`rglru_scan_ref` (``kernels/ref.py``), which
the kernel equals bit for bit.

:func:`rglru_scan` launches the kernel on CUDA tensors, for every
``S >= 1`` (decode runs ``S = 1`` from a carry) and every width, and raises
on anything the kernel does not take; it never falls back.  On CPU tensors
it runs :func:`rglru_scan_ref`.  ``rglru_scan.launches`` counts the kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rglru_scan_ref

__all__ = ["rglru_scan", "rglru_scan_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, x, h0) -> None:
    """Raise on anything the kernel does not take."""
    if a.dim() != 3:
        raise ValueError(f"a must be [B,S,R], got shape {tuple(a.shape)}")
    b, s, r = a.shape
    if a.dtype not in _DTYPES:
        raise TypeError(f"a and x must be float32 or bfloat16, got {a.dtype}")
    want = {"x": (x, a.dtype, (b, s, r))}
    if h0 is not None:
        want["h0"] = (h0, torch.float32, (b, r))
    for name, (t, dtype, shape) in want.items():
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
    if min(b, s, r) < 1:
        raise ValueError(f"the scan needs B, S, R >= 1, got {tuple(a.shape)}")


def rglru_scan(a, x, h0=None):
    """a, x: [B,S,R] (f32 or bf16, one type); h0: [B,R] f32 or None
    (zeros) -> h [B,S,R] in a's dtype, every step of
    ``h_t = a_t * h_{t-1} + x_t`` with an f32 carry.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`rglru_scan_ref`."""
    _check(a, x, h0)
    dev = a.device
    if dev.type == "cpu":
        return rglru_scan_ref(a, x, h0)
    if dev.type != "cuda":
        raise ValueError(f"the rglru_scan kernel runs on CUDA tensors, "
                         f"not {dev}")
    if not all(t.is_contiguous() for t in (a, x) + (() if h0 is None
                                                     else (h0,))):
        raise ValueError("a, x and h0 must be contiguous")
    b, s, r = a.shape
    out = torch.empty_like(a)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    lib = _lib()
    err = lib.rglru_scan_launch(
        a.data_ptr(), x.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), b, s, r, _DTYPES[a.dtype], index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("rglru_scan kernel launch failed: "
                           + lib.rglru_scan_error_string(err).decode())
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
