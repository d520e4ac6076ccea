"""The mLSTM matrix-memory scan: one launch runs ``S`` steps of every
(batch, head).

Replaces the TPU kernel ``repro/kernels/mlstm_scan.py::mlstm_scan`` with a
CUDA kernel written for Hopper (``csrc/mlstm_scan.cu``; its header says
what bounds it and how the design answers that).  The semantics are the
model's cell (``repro_torch/models/xlstm.py``) and its plain PyTorch
version :func:`mlstm_scan_ref` (``kernels/ref.py``).

:func:`mlstm_scan` launches the kernel on CUDA tensors, for every
``S >= 1`` (decode runs ``S = 1``), and raises on anything the kernel does
not take; it never falls back.  On CPU tensors it runs
:func:`mlstm_scan_ref`.  ``mlstm_scan.launches`` counts the kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mlstm_scan_ref

__all__ = ["mlstm_scan", "mlstm_scan_ref", "smem_bytes"]

_QKV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448        # dynamic shared memory one H100 block may use
_MAX_WARPS = 32


def smem_bytes(dh: int) -> int:
    """Shared memory of one block: C with rows padded to ``dh + 1``, the
    double-buffered k / q rows and the reduction partials (f32)."""
    return 4 * (dh * (dh + 1) + 4 * dh + 2 * _MAX_WARPS)


def _lib() -> ctypes.CDLL:
    lib = build.load("mlstm_scan")
    fn = lib.mlstm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mlstm_scan_error_string.argtypes = [ctypes.c_int]
        lib.mlstm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, i_gate, f_gate, carry) -> None:
    """Raise on anything the kernel does not take."""
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
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if s < 1 or b * h < 1:
        raise ValueError(f"the scan needs S >= 1 and B*H >= 1, got "
                         f"{tuple(q.shape)}")
    if smem_bytes(dh) > _SMEM_LIMIT:
        raise ValueError(f"head_dim {dh} needs {smem_bytes(dh)} B of shared "
                         f"memory per block, over the {_SMEM_LIMIT} B limit")


def mlstm_scan(q, k, v, i_gate, f_gate, carry=None):
    """q,k,v: [B,H,S,dh] (f32 or bf16, k pre-scaled); gates: [B,H,S] f32;
    carry ``(C, n, m)`` f32 or None.  -> (h [B,H,S,dh] in q's dtype,
    final (C [B,H,dh,dh], n [B,H,dh], m [B,H]) in f32).

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
    lib = _lib()
    out = torch.empty_like(q)
    cT = torch.empty((b, h, dh, dh), dtype=torch.float32, device=dev)
    nT = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    mT = torch.empty((b, h), dtype=torch.float32, device=dev)
    c0, n0, m0 = (None, None, None) if carry is None else \
        (t.data_ptr() for t in carry)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    err = lib.mlstm_scan_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
        f_gate.data_ptr(), c0, n0, m0, out.data_ptr(), cT.data_ptr(),
        nT.data_ptr(), mT.data_ptr(), b * h, s, dh, _QKV_DTYPES[q.dtype],
        index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("mlstm_scan kernel launch failed: "
                           + lib.mlstm_scan_error_string(err).decode())
    mlstm_scan.launches += 1
    return out, (cT, nT, mT)


mlstm_scan.launches = 0
