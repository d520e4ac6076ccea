"""The RG-LRU linear recurrence: one launch runs ``S`` steps of every
(batch, channel) lane, and one more launch its backward.

Replaces the TPU kernel ``repro/kernels/rglru_scan.py::rglru_scan`` with
CUDA kernels written for Hopper (``csrc/rglru_scan.cu``; its header says
what bounds them and how the design answers that).  The semantics are the
plain PyTorch versions :func:`rglru_scan_ref` and
:func:`rglru_scan_bwd_ref` (``kernels/ref.py``), which the kernels equal
bit for bit in f32 and bf16.

:func:`rglru_scan` launches the forward kernel on CUDA tensors, for every
``S >= 1`` (decode runs ``S = 1`` from a carry) and every width, and
raises on anything the kernel does not take; it never falls back.  On CPU
tensors it runs :func:`rglru_scan_ref`.  A block takes 16 or 32
neighbouring channels of a batch row (:func:`launch_plan`, cached per
shape); ``rglru_scan.launches`` counts the kernel launches and
``rglru_scan.launches_decode`` those with ``S = 1``.

:func:`rglru_scan_bwd` launches the backward kernel, which walks time in
reverse: ``g_t = dh_t + a_{t+1} g_{t+1}``, ``dx = g``, ``da_t = g_t
h_{t-1}`` and ``dh0 = a_0 g_0`` in one pass over a, h and dh as they lie.
``rglru_scan_bwd.launches`` counts its launches.  :class:`RGLRUScanFn`
makes the scan differentiable with it, inside the profiler range
``repro_torch.rglru_scan_bwd``.  On the CPU the backward runs
:func:`rglru_scan_bwd_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref

__all__ = ["rglru_scan", "rglru_scan_ref", "rglru_scan_bwd",
           "rglru_scan_bwd_ref", "RGLRUScanFn", "launch_plan", "Plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHANNELS = (16, 32)         # channels a block, the kernels' instantiations
STAGES = 4                  # csrc/rglru_scan.cu: kStages, ring stages
STEPS = 64                  # csrc/rglru_scan.cu: kTc, time steps a stage


class Plan(NamedTuple):
    """One launch's grid: ``blocks`` of ``channels`` lanes, a ring of
    ``stages`` x ``steps`` time steps of each operand, ``smem`` bytes."""
    channels: int
    blocks: int
    stages: int
    steps: int
    smem: int


def launch_plan(b: int, s: int, r: int, esize: int, sms: int, *,
                backward: bool = False, channels: int | None = None) -> Plan:
    """The grid of one launch at [B, S, R] with ``esize``-byte elements on
    a card of ``sms`` SMs: 32 channels a block where ``B x ceil(R / 32)``
    blocks still give one per SM, else 16 (``channels`` forces one).
    Stages of 64 steps where the grid is at most two blocks an SM (each
    block's chain is long: a deep ring), else of 32 (more blocks fit an
    SM at once); no more stages than chunks.  The ring holds a and x (a,
    dh and h for the ``backward``), each row 16 bytes wider than its
    channels (csrc: ``row_bytes``), then two tiles of h (dx and da) for
    the 16-byte stores (csrc: ``smem_bytes``)."""
    if channels is None:
        channels = 32 if b * -(-r // 32) >= sms else 16
    if channels not in CHANNELS:
        raise ValueError(f"channels must be one of {CHANNELS}, got "
                         f"{channels}")
    blocks = b * -(-r // channels)
    steps = min(STEPS if blocks <= 2 * sms else STEPS // 2, s)
    stages = min(STAGES, -(-s // steps))
    operands, tiles = (3, 2) if backward else (2, 1)
    return Plan(channels, blocks, stages, steps,
                stages * operands * steps * (channels * esize + 16)
                + 2 * tiles * steps * channels * esize)


@functools.lru_cache(maxsize=256)
def _plan(index, b, s, r, esize, backward, channels) -> Plan:
    return launch_plan(b, s, r, esize, sm_count(index), backward=backward,
                       channels=channels)


def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    if lib.rglru_scan_launch.argtypes is None:
        lib.rglru_scan_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.rglru_scan_launch.restype = ctypes.c_int
        lib.rglru_scan_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.rglru_scan_bwd_launch.restype = ctypes.c_int
        lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, h0, **same) -> None:
    """Raise on anything the kernels do not take: a [B,S,R] f32 or bf16,
    each of ``same`` of a's dtype and shape, h0 [B,R] f32 or None, all on
    a's device."""
    if a.dim() != 3:
        raise ValueError(f"a must be [B,S,R], got shape {tuple(a.shape)}")
    b, s, r = a.shape
    if a.dtype not in _DTYPES:
        raise TypeError(f"a and x must be float32 or bfloat16, got {a.dtype}")
    want = {name: (t, a.dtype, (b, s, r)) for name, t in same.items()}
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


def _cuda_operands(dev, h0, *tensors) -> int:
    """The device index; raise unless the device is CUDA, every tensor is
    contiguous and the [B,S,R] ones start on 16 bytes (cp.async)."""
    if dev.type != "cuda":
        raise ValueError(f"the rglru_scan kernels run on CUDA tensors, "
                         f"not {dev}")
    if not all(t.is_contiguous() for t in tensors) or (
            h0 is not None and not h0.is_contiguous()):
        raise ValueError("the scan's operands and h0 must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the scan's [B,S,R] operands must start on a "
                         "multiple of 16 bytes (cp.async)")
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _raise_on(lib, err) -> None:
    if err != 0:
        raise RuntimeError("rglru_scan kernel launch failed: "
                           + lib.rglru_scan_error_string(err).decode())


def rglru_scan(a, x, h0=None, *, channels=None):
    """a, x: [B,S,R] (f32 or bf16, one type); h0: [B,R] f32 or None
    (zeros) -> h [B,S,R] in a's dtype, every step of
    ``h_t = a_t * h_{t-1} + x_t`` with an f32 carry.

    ``channels`` (None: :func:`launch_plan`'s) forces 16 or 32 channels a
    block; ``chip_smoke.py`` times both.  CUDA tensors launch the kernel
    (or raise); CPU tensors run :func:`rglru_scan_ref`."""
    _check(a, h0, x=x)
    dev = a.device
    if dev.type == "cpu":
        return rglru_scan_ref(a, x, h0)
    index = _cuda_operands(dev, h0, a, x)
    b, s, r = a.shape
    plan = _plan(index, b, s, r, a.element_size(), False, channels)
    out = torch.empty_like(a)
    lib = _lib()
    _raise_on(lib, lib.rglru_scan_launch(
        a.data_ptr(), x.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), b, s, r, _DTYPES[a.dtype], plan.channels,
        plan.steps, index,
        torch.cuda.current_stream(dev).cuda_stream))
    rglru_scan.launches += 1
    rglru_scan.launches_decode += s == 1
    return out


rglru_scan.launches = 0
rglru_scan.launches_decode = 0


def rglru_scan_bwd(a, h, dh, h0=None):
    """The VJP of :func:`rglru_scan`: a, h, dh [B,S,R] of one type (h the
    forward's output, dh its gradient), h0 [B,R] f32 or None -> (da, dx in
    a's dtype, dh0 f32 or None).

    CUDA tensors launch the backward kernel once (or raise); CPU tensors
    run :func:`rglru_scan_bwd_ref`.  The two are equal bit for bit: g
    stays in f32 and is rounded only where da and dx are stored."""
    _check(a, h0, h=h, dh=dh)
    dev = a.device
    if dev.type == "cpu":
        return rglru_scan_bwd_ref(a, h, dh, h0)
    index = _cuda_operands(dev, h0, a, h, dh)
    b, s, r = a.shape
    plan = _plan(index, b, s, r, a.element_size(), True, None)
    da, dx = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    lib = _lib()
    _raise_on(lib, lib.rglru_scan_bwd_launch(
        a.data_ptr(), h.data_ptr(), dh.data_ptr(),
        None if h0 is None else h0.data_ptr(), da.data_ptr(), dx.data_ptr(),
        None if dh0 is None else dh0.data_ptr(), b, s, r, _DTYPES[a.dtype],
        plan.channels, plan.steps, index,
        torch.cuda.current_stream(dev).cuda_stream))
    rglru_scan_bwd.launches += 1
    return da, dx, dh0


rglru_scan_bwd.launches = 0


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
