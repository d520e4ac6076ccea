"""The mLSTM matrix-memory scan: one launch runs ``S`` steps of every
(batch, head).

Replaces the TPU kernel ``repro/kernels/mlstm_scan.py::mlstm_scan`` with a
CUDA kernel written for Hopper (``csrc/mlstm_scan.cu``; its header says
what bounds it and how the design answers that).  The semantics are the
model's cell (``repro_torch/models/xlstm.py``) and its plain PyTorch
version :func:`mlstm_scan_ref` (``kernels/ref.py``);
:func:`mlstm_scan_rows_ref` is the plain form of the kernel's own order of
summation.

Each head's rows of C are split over ``dh / 32`` blocks
(:func:`launch_plan`), each holding its rows in registers.  q, k, v and
the gates are read through their strides (the head dim contiguous), so
the model's ``[B,S,H,dh]`` tensors arrive as transposed views, not
copies, and h is written in q's layout.

:func:`mlstm_scan` launches the kernel on CUDA tensors, for every
``S >= 1`` (decode runs ``S = 1``), and raises on anything the kernel does
not take; it never falls back.  On CPU tensors it runs
:func:`mlstm_scan_ref`.  ``mlstm_scan.launches`` counts the kernel
launches and ``mlstm_scan.launches_decode`` those with ``S = 1``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mlstm_scan_ref, mlstm_scan_rows_ref

__all__ = ["mlstm_scan", "mlstm_scan_ref", "mlstm_scan_rows_ref",
           "launch_plan", "Plan", "HEAD_DIMS"]

_QKV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 192, 256)   # the head dims the kernel is built for
ROWS = 32                   # csrc/mlstm_scan.cu: kRows, rows of C a block
COL_GROUPS = 4              # kGroups: lanes a row
THREADS = 128
STAGES = 2                  # kStages
STEPS = 16                  # kTc, steps a ring stage
SMEM_LIMIT = 232_448        # dynamic shared memory one H100 block may use


class Plan(NamedTuple):
    """One launch's grid: ``blocks`` of ``threads``, each ``rows`` rows of
    one head's C, and a ring of ``stages`` x ``steps`` steps in ``smem``
    bytes (with each warp's h for a chunk)."""
    blocks: int
    threads: int
    rows: int
    stages: int
    steps: int
    smem: int


def launch_plan(b: int, h: int, s: int, dh: int, esize: int) -> Plan:
    """The grid at q [B,H,S,dh] with ``esize``-byte q/k/v: ``dh / 32``
    blocks a head; a ring stage holds k and q rows, the block's v slice
    (``esize`` each) and the two f32 gates for ``min(16, S)`` steps
    (csrc: ``smem_bytes``)."""
    steps = min(STEPS, s)
    stage = steps * (2 * dh + ROWS) * esize + (2 * steps * 4 + 15) // 16 * 16
    smem = STAGES * stage + THREADS // 32 * steps * 8 * esize
    return Plan(b * h * (dh // ROWS), THREADS, ROWS, STAGES, steps, smem)


def _lib() -> ctypes.CDLL:
    lib = build.load("mlstm_scan")
    fn = lib.mlstm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mlstm_scan_error_string.argtypes = [ctypes.c_int]
        lib.mlstm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, i_gate, f_gate, carry) -> None:
    """Raise on anything the kernel does not take (on any device: the
    head dim of q, k, v contiguous, the carry contiguous)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B,H,S,dh], got shape {tuple(q.shape)}")
    b, h, s, dh = q.shape
    if q.dtype not in _QKV_DTYPES:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    want = {"q": (q, q.dtype, (b, h, s, dh)), "k": (k, q.dtype, (b, h, s, dh)),
            "v": (v, q.dtype, (b, h, s, dh)),
            "i_gate": (i_gate, torch.float32, (b, h, s)),
            "f_gate": (f_gate, torch.float32, (b, h, s))}
    if carry is not None:
        C, n, m = carry
        want.update({"C": (C, torch.float32, (b, h, dh, dh)),
                     "n": (n, torch.float32, (b, h, dh)),
                     "m": (m, torch.float32, (b, h))})
    for name, (x, dtype, shape) in want.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(x.shape)}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    if carry is not None and not all(x.is_contiguous() for x in carry):
        raise ValueError("the carry (C, n, m) must be contiguous")
    if s < 1 or b * h < 1:
        raise ValueError(f"the scan needs S >= 1 and B*H >= 1, got "
                         f"{tuple(q.shape)}")


@functools.lru_cache(maxsize=256)
def _layout(b, h, s, dh, esize, qs, ks, vs, hs, gi, gf) -> ctypes.Array:
    """The kernel's stride array ((batch, head, step) strides of q, k, v,
    h and the two gates, in elements) for one shape and layout, checked
    once: raise on anything the kernel does not take."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"the mlstm_scan kernel takes head dims "
                         f"{HEAD_DIMS}, got {dh}")
    st = (*qs[:3], *ks[:3], *vs[:3], *hs[:3])
    sizes = (b, h, s) * 4                   # a dim of one: stride unused
    if any(x * esize % 16 for x, n in zip(st, sizes) if n > 1):
        raise ValueError("the outer strides of q, k, v must be multiples "
                         "of 16 bytes (cp.async)")
    if launch_plan(b, h, s, dh, esize).smem > SMEM_LIMIT:
        raise ValueError(f"head_dim {dh} needs more than {SMEM_LIMIT} B of "
                         f"shared memory a block")
    return (ctypes.c_longlong * 18)(*st, *gi[:3], *gf[:3])


def mlstm_scan(q, k, v, i_gate, f_gate, carry=None):
    """q,k,v: [B,H,S,dh] (f32 or bf16, k pre-scaled; any strides with the
    head dim contiguous); gates: [B,H,S] f32 (any strides); carry
    ``(C, n, m)`` f32 contiguous or None.  -> (h [B,H,S,dh] in q's dtype,
    laid out like q; final (C [B,H,dh,dh], n [B,H,dh], m [B,H]) in f32).

    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`mlstm_scan_ref`."""
    _check(q, k, v, i_gate, f_gate, carry)
    dev = q.device
    if dev.type == "cpu":
        return mlstm_scan_ref(q, k, v, i_gate, f_gate, carry)
    if dev.type != "cuda":
        raise ValueError(f"the mlstm_scan kernel runs on CUDA tensors, "
                         f"not {dev}")
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    strides = _layout(b, h, s, dh, q.element_size(), q.stride(), k.stride(),
                      v.stride(), out.stride(), i_gate.stride(),
                      f_gate.stride())
    ptrs = [x.data_ptr() for x in (q, k, v, out)]
    if carry is not None:
        ptrs.append(carry[0].data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("the bases of q, k, v and the carry's C must be "
                         "multiples of 16 bytes (cp.async)")
    cT = torch.empty((b, h, dh, dh), dtype=torch.float32, device=dev)
    nT = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    mT = torch.empty((b, h), dtype=torch.float32, device=dev)
    c0, n0, m0 = (None, None, None) if carry is None else \
        (t.data_ptr() for t in carry)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    lib = _lib()
    err = lib.mlstm_scan_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
        f_gate.data_ptr(), c0, n0, m0, out.data_ptr(), cT.data_ptr(),
        nT.data_ptr(), mT.data_ptr(), b, h, s, dh, strides,
        _QKV_DTYPES[q.dtype], index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("mlstm_scan kernel launch failed: "
                           + lib.mlstm_scan_error_string(err).decode())
    mlstm_scan.launches += 1
    mlstm_scan.launches_decode += s == 1
    return out, (cT, nT, mT)


mlstm_scan.launches = 0
mlstm_scan.launches_decode = 0
