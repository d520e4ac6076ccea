"""The simulator's event-loop kernel: ``chunk`` events per launch.

Replaces the TPU kernel ``repro/kernels/simstep.py::fused_chunk`` with a
CUDA kernel written for Hopper (``csrc/simstep.cu``; its header says what
bounds it and how the design answers that).  One launch advances every
sweep cell of a batched ``(SimTables, SimParams, SimState)`` by up to
``chunk`` events of the masked step, updating the state tensors in place
(the latency rings are large, so no copy is made).

:func:`fused_chunk` launches the kernel on CUDA tensors and raises on
anything the kernel does not take; it never falls back.  On CPU tensors it
runs :func:`fused_chunk_ref`, the plain PyTorch version, which applies the
port's masked step ``chunk`` times.  ``fused_chunk.launches`` counts the
kernel launches.

:func:`bind` checks the operands once and returns a function that
launches one chunk with them: ``simulate`` uses it, so a sweep's hundreds
of launches are not each checked again.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_TABLES_I32 = ("big", "cs_dur", "nc_dur", "inter", "seg_lock")
_STATE_I32 = ("t", "phase", "t_ready", "seg", "epoch_start", "attempt_t",
              "q", "q_head", "q_tail", "holder", "prop_ctr", "ep_cnt",
              "cs_cnt", "events")
_STATE_F32 = ("window", "unit", "ep_lat", "cs_lat")
_POLICY_IDS = {"fifo": 0, "tas": 1, "prop": 2, "libasl": 3}
_MAX_CORES = 32


def fused_chunk_ref(tables, params, state, chunk: int, cfg):
    """Plain PyTorch version: ``chunk`` masked steps, in place."""
    from repro_torch.core.simlock import _step
    for _ in range(max(int(chunk), 1)):
        _step(cfg, tables, params, state)
    return state


def _operands(tables, params, state, cfg) -> tuple:
    """Check what the kernel takes; return its tensors and sizes."""
    b, n = state.t_ready.shape
    s = tables.cs_dur.shape[2]
    l = state.holder.shape[1]
    cap = state.ep_lat.shape[2]
    shapes = {
        "big": (b, n), "cs_dur": (b, n, s), "nc_dur": (b, n, s),
        "inter": (b, n), "seg_lock": (b, s), "slo_scale": (b, n),
        "slo": (b,), "w_big": (b,), "prop_n": (b,), "horizon": (b,),
        "t": (b,), "key": (b, 2), "phase": (b, n), "t_ready": (b, n),
        "seg": (b, n), "epoch_start": (b, n), "attempt_t": (b, n),
        "window": (b, n), "unit": (b, n), "q": (b, l, 2, n),
        "q_head": (b, l, 2), "q_tail": (b, l, 2), "holder": (b, l),
        "prop_ctr": (b, l), "ep_lat": (b, n, cap), "ep_cnt": (b, n),
        "cs_lat": (b, n, cap), "cs_cnt": (b, n), "events": (b,)}
    ts = {k: getattr(tables, k) for k in _TABLES_I32}
    ts["slo_scale"] = tables.col["slo_scale"]
    ts.update({k: getattr(params, k)
               for k in ("slo", "w_big", "prop_n", "horizon")})
    ts.update({k: getattr(state, k)
               for k in _STATE_I32 + _STATE_F32 + ("key",)})
    dev = state.t.device
    for k, x in ts.items():
        want = (torch.int64 if k == "key" else
                torch.float32 if k in _STATE_F32 + ("slo_scale", "slo",
                                                    "w_big")
                else torch.int32)
        if x.device != dev:
            raise ValueError(f"{k} is on {x.device}, the state on {dev}")
        if x.dtype != want:
            raise TypeError(f"{k} must be {want}, got {x.dtype}")
        if tuple(x.shape) != shapes[k]:
            raise ValueError(f"{k} must have shape {shapes[k]}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{k} must be contiguous")
    return ts, (b, n, s, l, cap)


_ORDER = ("big", "cs_dur", "nc_dur", "inter", "seg_lock", "slo_scale",
          "slo", "w_big", "prop_n", "horizon", "t", "key", "phase",
          "t_ready", "seg", "epoch_start", "attempt_t", "window", "unit",
          "q", "q_head", "q_tail", "holder", "prop_ctr", "ep_lat", "ep_cnt",
          "cs_lat", "cs_cnt", "events")


_SMEM_LIMIT = 232_448                # dynamic shared memory of one block


def cell_bytes(n: int, s: int, l: int) -> int:
    """Shared memory one cell takes in the kernel (``csrc/simstep.cu``:
    its per-core state and tables, queues, holders and 32 pick weights),
    for ``n`` cores, ``s`` segments and ``l`` locks."""
    return 4 * (12 * n + 2 * n * s + s + 2 * l * n + 6 * l + 32)


def _lib() -> ctypes.CDLL:
    lib = build.load("simstep")
    fn = lib.simstep_fused_chunk
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.simstep_error_string.argtypes = [ctypes.c_int]
        lib.simstep_error_string.restype = ctypes.c_char_p
    return lib


def bind(tables, params, state, chunk: int, cfg):
    """Check the operands once; return a function of no arguments that
    advances every cell of ``state`` by up to ``chunk`` events, in place:
    the kernel on CUDA tensors (on the stream current now), the plain
    version on CPU tensors.  Raises on anything the kernel does not
    take."""
    ts, (b, n, s, l, cap) = _operands(tables, params, state, cfg)
    dev = state.t.device
    if dev.type == "cpu":
        return lambda: fused_chunk_ref(tables, params, state, chunk, cfg)
    if dev.type != "cuda":
        raise ValueError(f"the simstep kernel runs on CUDA tensors, "
                         f"not {dev}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if cfg.policy not in _POLICY_IDS:
        raise ValueError(f"the simstep kernel runs {sorted(_POLICY_IDS)}, "
                         f"not {cfg.policy!r}")
    if not 1 <= n <= _MAX_CORES:
        raise ValueError(f"the simstep kernel runs 1..{_MAX_CORES} cores "
                         f"per cell (one warp lane each), got {n}")
    if cell_bytes(n, s, l) > _SMEM_LIMIT:
        raise ValueError(f"a cell of {n} cores, {s} segments and {l} locks "
                         f"takes {cell_bytes(n, s, l)} bytes of shared "
                         f"memory, over one block's {_SMEM_LIMIT}")
    from repro_torch.core.aimd import unit_factor
    from repro_torch.core.policies.base import ticks
    lib = _lib()
    fn = lib.simstep_fused_chunk
    ptrs = (ctypes.c_void_p * len(_ORDER))(*(ts[k].data_ptr()
                                             for k in _ORDER))
    ints = (ctypes.c_int * 8)(b, n, s, l, cap, _POLICY_IDS[cfg.policy],
                              int(chunk), int(cfg.max_events))
    # The two f32 constants of Algorithm 2: the unit factor and the cap.
    floats = (ctypes.c_float * 2)(float(unit_factor(cfg.pct)),
                                  float(ticks(cfg.max_window_us)))
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = fn(ptrs, ints, floats, index, stream)
        if err != 0:
            raise RuntimeError("simstep kernel launch failed: "
                               + lib.simstep_error_string(err).decode())
        fused_chunk.launches += 1

    return launch


def fused_chunk(tables, params, state, chunk: int, cfg):
    """Advance every cell of ``state`` by up to ``chunk`` events, in place.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`fused_chunk_ref`.  Every call checks its operands.  Returns
    ``state``."""
    bind(tables, params, state, chunk, cfg)()
    return state


fused_chunk.launches = 0
