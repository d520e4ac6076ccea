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

:class:`RGLRUScanFn` makes the scan differentiable.  Its VJP is itself a
linear scan run backwards, ``g_t = dh_t + a_{t+1} g_{t+1}``, so the
backward runs the same kernel over reversed and shifted inputs (the flips
and the shift are copies; a kernel that walks backwards would save them),
then ``dx = g``, ``da_t = g_t h_{t-1}`` and ``dh0 = a_0 g_0``, inside the
profiler range ``repro_torch.rglru_scan_bwd``.  On the CPU the backward
runs the plain :func:`rglru_scan_bwd_ref`.
"""

from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from repro_torch.kernels import build
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref

__all__ = ["rglru_scan", "rglru_scan_ref", "rglru_scan_bwd",
           "rglru_scan_bwd_ref", "RGLRUScanFn"]

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


def rglru_scan_bwd(a, h, dh, h0=None):
    """The VJP of :func:`rglru_scan`: a, h, dh [B,S,R] (h the forward's
    output, dh its gradient), h0 [B,R] f32 or None -> (da, dx in a's
    dtype, dh0 f32 or None).

    CUDA tensors run :func:`rglru_scan` (the kernel) once over
    ``flip(a shifted one step left, 0 last)`` and ``flip(dh)``; CPU
    tensors run :func:`rglru_scan_bwd_ref`.  In f32 the two are equal bit
    for bit: the kernel rounds the product and the sum as the plain loop
    does."""
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, h, dh, h0)
    return reverse_scan_vjp(a, h, dh, h0, rglru_scan)


def reverse_scan_vjp(a, h, dh, h0, scan):
    """The VJP of the scan by one forward ``scan`` over reversed inputs:
    ``g = flip(scan(flip(a_next), flip(dh)))`` with ``a_next[t] =
    a[t + 1]`` and 0 last, then ``da_t = g_t h_{t-1}``, ``dx = g``,
    ``dh0 = a_0 g_0``."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    g = scan(a_next.flip(1), dh.to(a.dtype).flip(1)).flip(1)
    first = torch.zeros_like(h[:, :1]) if h0 is None \
        else h0[:, None].to(h.dtype)
    da = g * torch.cat([first, h[:, :-1]], dim=1)
    dh0 = None if h0 is None else a[:, 0].float() * g[:, 0].float()
    return da, g, dh0


class RGLRUScanFn(torch.autograd.Function):
    """Differentiable scan: ``RGLRUScanFn.apply(a, x, h0)`` -> h, as
    :func:`rglru_scan`; the backward is :func:`rglru_scan_bwd`."""

    @staticmethod
    def forward(ctx, a, x, h0):
        h = rglru_scan(a, x, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        with record_function("repro_torch.rglru_scan_bwd"):
            da, dx, dh0 = rglru_scan_bwd(a, h, dh.contiguous(), h0)
        return da, dx, dh0
