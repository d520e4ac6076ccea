"""The simulator's event-loop kernel: ``chunk`` events per launch.

Replaces the TPU kernel ``repro/kernels/simstep.py::fused_chunk`` with a
CUDA kernel written for Hopper (``csrc/simstep.cu``; its header says what
bounds it and how the design answers that).  One launch advances every
sweep cell of a batched ``(SimTables, SimParams, SimState)`` by up to
``chunk`` events of the masked step, updating the state tensors in place
(the latency rings and histograms are large, so no copy is made).  A
config with a workload, histogram, fault or key gate on
(:func:`stochastic`) runs its policy's stochastic instantiation; the
others compile none of that code.

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

from repro_torch.core import simlock
from repro_torch.core.aimd import unit_factor
from repro_torch.core.policies import policy_ids
from repro_torch.core.policies.base import ticks
from repro_torch.kernels import build

# The kernel's operands in its order (csrc/simstep.cu, enum Operand):
# tables, params, state, as (name, dtype).
_I32, _F32, _I64 = torch.int32, torch.float32, torch.int64
_COLUMNS = ("slo_scale", "dvfs", "race_w", "p_cs", "p_spin", "p_park",
            "p_idle")
# The stochastic instantiation's operands: tables, params, state.
_STOCH_TABLES = (("wl_service_col", _I32), ("ft_mask", _F32),
                 ("hist_log2_lo", _F32), ("hist_inv_log2g", _F32))
_STOCH_PARAMS = (
    ("seed", _I32), ("wl_process", _I32), ("wl_service", _I32),
    ("wl_rate", _F32), ("wl_cv", _F32), ("wl_mix", _F32),
    ("wl_mix_scale", _F32), ("wl_burst", _F32), ("wl_burst_len", _F32),
    ("wl_amp", _F32), ("wl_period", _F32), ("preempt_rate", _F32),
    ("preempt_scale", _F32), ("churn_rate", _F32), ("churn_period", _I32),
    ("straggle_rate", _F32), ("straggle_scale", _F32),
    ("hist_warmup", _I32))
_STOCH_STATE = (("svc_scale", _F32), ("wl_on", _I32), ("arr_t", _I32),
                ("ep_hist", _I32), ("cs_hist", _I32))
# The keyed operands (csrc/simstep.cu, enum KeyOperand), after the others:
# the cells' Zipf params, the ks_* policies' knobs, the state.
_KEY_PARAMS = (("ks_keys", _I32), ("ks_theta", _F32), ("ks_zeta", _F32),
               ("ks_eta", _F32), ("ks_alpha", _F32), ("ks_locks", _I32))
_KEY_KNOBS = (("erew_bound", _I32), ("crew_wfrac", _F32),
              ("crew_bound", _I32), ("jbsq_k", _I32))
_KEY_STATE = (("cur_lock", _I32), ("cur_rw", _F32), ("erew_ctr", _I32),
              ("crew_ctr", _I32), ("jbsq_ctr", _I32))
_KEYED = _KEY_PARAMS + _KEY_KNOBS + _KEY_STATE
# Operands a launch passes only where its gates or policies read them
# (null pointers otherwise), so the fig1 main path passes the 29 it reads
# of the 88.
_OPTIONAL = frozenset((
    "pol_id", "long_prob", "long_scale", "scale", "wakeup", "dvfs",
    "race_w", "p_cs", "p_spin", "p_park", "p_idle", "n_active", "energy",
    "shfl_bound", "shfl_ctr", "race_bound", "race_ctr")) | frozenset(
    k for k, _ in _STOCH_TABLES + _STOCH_PARAMS + _STOCH_STATE + _KEYED)
_ORDER = (
    ("big", _I32), ("cs_dur", _I32), ("nc_dur", _I32), ("inter", _I32),
    ("seg_lock", _I32), ("slo_scale", _F32), ("dvfs", _F32),
    ("race_w", _F32), ("p_cs", _F32), ("p_spin", _F32), ("p_park", _F32),
    ("p_idle", _F32),
    ("slo", _F32), ("pol_id", _I32), ("w_big", _F32), ("prop_n", _I32),
    ("n_active", _I32), ("horizon", _I32), ("long_prob", _F32),
    ("long_scale", _F32), ("wakeup", _I32), ("shfl_bound", _I32),
    ("race_bound", _I32),
    ("t", _I32), ("key", _I64), ("phase", _I32), ("t_ready", _I32),
    ("seg", _I32), ("epoch_start", _I32), ("attempt_t", _I32),
    ("window", _F32), ("unit", _F32), ("scale", _F32), ("q", _I32),
    ("q_head", _I32), ("q_tail", _I32), ("holder", _I32),
    ("prop_ctr", _I32), ("shfl_ctr", _I32), ("race_ctr", _I32),
    ("ep_lat", _F32), ("ep_cnt", _I32), ("cs_lat", _F32), ("cs_cnt", _I32),
    ("events", _I32), ("energy", _F32)) + _STOCH_TABLES + _STOCH_PARAMS + \
    _STOCH_STATE + _KEYED
_MERGED = -1                         # the merged sets' instantiation
_MAX_CORES = 32


def fused_chunk_ref(tables, params, state, chunk: int, cfg):
    """Plain PyTorch version: ``chunk`` masked steps, in place."""
    for _ in range(max(int(chunk), 1)):
        simlock._step(cfg, tables, params, state)
    return state


_TABLE_FIELDS = frozenset(("big", "cs_dur", "nc_dur", "inter", "seg_lock",
                           "hist_log2_lo", "hist_inv_log2g"))
_PARAM_FIELDS = frozenset(("slo", "pol_id", "w_big", "prop_n", "n_active",
                           "horizon", "long_prob", "long_scale", "wakeup")
                          + tuple(k for k, _ in _STOCH_PARAMS + _KEY_PARAMS))
_POL_PARAMS = ("shfl_bound", "race_bound") + tuple(k for k, _ in _KEY_KNOBS)
_POL_STATE = ("shfl_ctr", "race_ctr", "erew_ctr", "crew_ctr", "jbsq_ctr")
# Each operand's shape, by its sizes' names (B cells, N cores, S
# segments, L locks, C ring slots, H histogram buckets); [B, N] unless
# listed.
_SHAPES = {"cs_dur": "bns", "nc_dur": "bns", "seg_lock": "bs", "key": "b2",
           "q": "bl2n", "q_head": "bl2", "q_tail": "bl2", "holder": "bl",
           "prop_ctr": "bl", "ep_lat": "bnc", "cs_lat": "bnc",
           "hist_log2_lo": "b", "hist_inv_log2g": "b", "ep_hist": "bnh",
           "cs_hist": "bnh", **{k: "bl" for k in _POL_STATE}}
# Operands named apart from their field: the wl_service column (the
# params have a wl_service too).
_FIELD = {"wl_service_col": "wl_service"}


def _source(k: str) -> tuple:
    """(where operand ``k`` lives, the names of its sizes)."""
    where = ("col" if k in _COLUMNS + ("ft_mask", "wl_service_col") else
             "pm.pol" if k in _POL_PARAMS else
             "st.pol" if k in _POL_STATE else
             "tables" if k in _TABLE_FIELDS else
             "params" if k in _PARAM_FIELDS else "state")
    dims = _SHAPES.get(k, "b" if where in ("params", "pm.pol")
                       or k in ("t", "events") else "bn")
    return where, dims


def _needs(cfg) -> frozenset:
    """The optional operands a launch under ``cfg`` reads."""
    names = cfg.policy_set or (cfg.policy,)
    need = set()
    if cfg.policy_set:
        need.add("pol_id")
    if cfg.long_epoch_prob > 0.0:
        need |= {"long_prob", "long_scale", "scale"}
    if cfg.wakeup_us > 0.0:
        need.add("wakeup")
    if simlock._energy_on(cfg):
        need |= {"dvfs", "p_cs", "p_spin", "p_park", "p_idle", "n_active",
                 "energy"}
    if "dvfs_race" in names:
        need |= {"dvfs", "race_w", "race_bound", "race_ctr"}
    if "shfl" in names:
        need |= {"shfl_bound", "shfl_ctr"}
    if simlock._wl_on(cfg):
        need |= {"seed", "wl_service_col", "scale", "svc_scale", "wl_on",
                 "wl_process", "wl_service", "wl_rate", "wl_cv", "wl_mix",
                 "wl_mix_scale", "wl_burst", "wl_burst_len", "wl_amp",
                 "wl_period"}
    if cfg.wl_open:
        need.add("arr_t")
    if cfg.hist:
        need |= {"hist_log2_lo", "hist_inv_log2g", "hist_warmup", "ep_hist",
                 "cs_hist"}
    for rate, own in (("preempt", ("preempt_scale",)),
                      ("churn", ("churn_period",)),
                      ("straggle", ("straggle_scale",))):
        if getattr(cfg, f"{rate}_rate") > 0.0:
            need |= {"seed", "ft_mask", f"{rate}_rate", *own}
    if "ks_erew" in names or "ks_crew" in names:
        need.add("n_active")        # the owner map
    for pol, own in (("ks_erew", ("erew_bound", "erew_ctr")),
                     ("ks_crew", ("crew_wfrac", "crew_bound", "crew_ctr",
                                  "cur_rw")),
                     ("ks_jbsq", ("jbsq_k", "jbsq_ctr"))):
        if pol in names:
            need |= set(own)
    if simlock._ks_on(cfg):
        need |= {"seed", "cur_lock"} | {k for k, _ in _KEY_PARAMS}
    return frozenset(need)


def stochastic(cfg) -> bool:
    """Does ``cfg`` run the kernel's stochastic instantiation (a workload,
    histogram, fault or key gate on)?"""
    return bool(simlock._wl_on(cfg) or cfg.hist or cfg.preempt_rate > 0.0
                or cfg.churn_rate > 0.0 or cfg.straggle_rate > 0.0
                or simlock._ks_on(cfg))


_KS_POLICIES = frozenset(("ks_erew", "ks_crew", "ks_jbsq"))


def keyed(cfg) -> bool:
    """Does a launch under ``cfg`` run a keyed instantiation (``ArgsK``:
    keys on, or a ks_* policy in the set)?  The others compile as they
    did before keyed traffic was ported."""
    return bool(simlock._ks_on(cfg) or _KS_POLICIES.intersection(
        cfg.policy_set or (cfg.policy,)))


# (name, dtype, where, sizes) of every operand, in the kernel's order.
_SOURCES = tuple((k, want) + _source(k) for k, want in _ORDER)
_INDEX = {k: i for i, (k, _) in enumerate(_ORDER)}
_PTRS = ctypes.c_void_p * len(_ORDER)


def _operands(tables, params, state, cfg) -> tuple:
    """Check what the kernel takes; return its tensors by name (only the
    operands ``cfg``'s gates and policies read) and sizes."""
    b, n = state.t_ready.shape
    s = tables.cs_dur.shape[2]
    l = state.holder.shape[1]
    cap = state.ep_lat.shape[2]
    size = {"b": b, "n": n, "s": s, "l": l, "c": cap, "2": 2,
            "h": state.ep_hist.shape[2]}
    shapes = {}
    src = {"col": tables.col, "pm.pol": params.pol, "st.pol": state.pol,
           "tables": tables, "params": params, "state": state}
    need = _needs(cfg)
    dev = state.t.get_device()
    ts = {}
    for k, want, where, dims in _SOURCES:
        if k in _OPTIONAL and k not in need:
            continue
        x = src[where]
        f = _FIELD.get(k, k)
        x = x.get(f) if isinstance(x, dict) else getattr(x, f)
        if x is None:
            raise ValueError(f"{cfg.policy!r} needs the pol slot {k}")
        shape = shapes.get(dims)
        if shape is None:
            shape = shapes[dims] = tuple(size[d] for d in dims)
        if not (x.dtype == want and x.get_device() == dev
                and x.shape == shape and x.is_contiguous()):
            if x.device != state.t.device:
                raise ValueError(f"{k} is on {x.device}, the state on "
                                 f"{state.t.device}")
            if x.dtype != want:
                raise TypeError(f"{k} must be {want}, got {x.dtype}")
            if tuple(x.shape) != shape:
                raise ValueError(f"{k} must have shape {shape}, "
                                 f"got {tuple(x.shape)}")
            raise ValueError(f"{k} must be contiguous")
        ts[k] = x
    return ts, (b, n, s, l, cap)


_SMEM_LIMIT = 232_448                # dynamic shared memory of one block


def cell_bytes(n: int, s: int, l: int, stoch: bool = False,
               keyed: bool = False) -> int:
    """Shared memory one cell takes in the kernel (``csrc/simstep.cu``:
    its per-core state and tables, queues, holders, the policies'
    per-lock counters and 32 pick weights; the stochastic instantiation's
    per-core service scale, phase bit, arrival, service id and fault
    mask; with the keyed operands each core's read/write uniform and two
    stream keys, the ks_* per-lock counters and 11 keyed params), for
    ``n`` cores, ``s`` segments and ``l`` locks."""
    return 4 * (13 * n + 2 * n * s + s + 2 * l * n + 8 * l + 32
                + (5 * n if stoch else 0)
                + (5 * n + 3 * l + 11 if keyed else 0))


def instantiation(cfg) -> int:
    """The kernel instantiation a config runs: its policy's registry id,
    or ``-1`` (the merged sets', which reads each cell's id)."""
    if cfg.policy_set:
        return _MERGED
    return policy_ids()[cfg.policy]


def instantiation_name(cfg) -> str:
    """The instantiation a launch under ``cfg`` runs, readable:
    ``"libasl"``, ``"merged stochastic"``, ``"ks_crew stochastic keyed"``."""
    return ("merged" if cfg.policy_set else cfg.policy) + (
        " stochastic" if stochastic(cfg) else "") + (
        " keyed" if keyed(cfg) else "")


def signature(tables, params, state, cfg) -> tuple:
    """What makes a launch another executable: its instantiation
    (:func:`instantiation`, :func:`stochastic`, :func:`keyed`), the
    operands it passes with their shapes and dtypes, and the device."""
    ts, _ = _operands(tables, params, state, cfg)
    return (instantiation(cfg), stochastic(cfg), keyed(cfg),
            str(state.t.device),
            tuple((k, tuple(x.shape), str(x.dtype)) for k, x in ts.items()))


def launch_bytes(tables, params, before, after, cfg, launches: int) -> float:
    """Bytes one of ``launches`` launches must move, on average, to take
    the cells from ``before`` to ``after`` (``before=None``: from the
    initial state, whose counters are all 0): in each launch every cell
    that retires an event reads the kernel's tables, params and state
    (rings and histograms excepted) once and writes its state once; each
    recorded latency writes one 4-byte ring sample, and each histogram
    sample reads and writes one 4-byte count."""
    ts, _ = _operands(tables, params, after, cfg)
    state = set(simlock.SimState._fields) | set(_POL_STATE)
    skip = {"ep_lat", "cs_lat", "ep_hist", "cs_hist"}
    if not (cfg.p_cs or cfg.p_spin or cfg.p_park or cfg.p_idle):
        skip |= {"energy", "p_cs", "p_spin", "p_park", "p_idle"}
    if not cfg.long_epoch_prob > 0.0:
        state.discard("scale")           # read, not written back
    per_cell = sum((2 if k in state else 1) * x[0].numel() * x.element_size()
                   for k, x in ts.items() if k not in skip)

    def grown(name):
        a = getattr(after, name).long()
        return a if before is None else a - getattr(before, name).long()

    samples = int(grown("ep_cnt").sum() + grown("cs_cnt").sum())
    counts = int(grown("ep_hist").sum() + grown("cs_hist").sum())
    return int((grown("events") > 0).sum()) * per_cell + (
        4 * samples + 8 * counts) / launches


# (policy id or 10 for a merged set, stochastic, keyed) -> its library.
_GROUP = {inst: g for g, group in enumerate(build.SIMSTEP_GROUPS)
          for inst in group}


def part(cfg) -> int:
    """The library of ``csrc/simstep.cu`` (``build.SIMSTEP_GROUPS``) that
    holds the instantiation a launch under ``cfg`` runs."""
    p = instantiation(cfg)
    return _GROUP[(10 if p == _MERGED else p, stochastic(cfg), keyed(cfg))]


def _lib(cfg) -> ctypes.CDLL:
    lib = build.load("simstep", part(cfg))
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
    if not 1 <= n <= _MAX_CORES:
        raise ValueError(f"the simstep kernel runs 1..{_MAX_CORES} cores "
                         f"per cell (one warp lane each), got {n}")
    stoch = stochastic(cfg)
    size = cell_bytes(n, s, l, stoch, keyed(cfg))
    if size > _SMEM_LIMIT:
        raise ValueError(f"a cell of {n} cores, {s} segments and {l} locks "
                         f"takes {size} bytes of shared memory, over one "
                         f"block's {_SMEM_LIMIT}")
    lib = _lib(cfg)
    fn = lib.simstep_fused_chunk
    ptrs = _PTRS()                       # null where not passed
    for k, x in ts.items():
        ptrs[_INDEX[k]] = x.data_ptr()
    ints = (ctypes.c_int * 21)(
        b, n, s, l, cap, instantiation(cfg), int(chunk),
        int(cfg.max_events), int(cfg.long_epoch_prob > 0.0),
        int(cfg.wakeup_us > 0.0), int(simlock._energy_on(cfg)), int(stoch),
        int(simlock._wl_on(cfg)), int(cfg.wl_open), int(cfg.hist),
        state.ep_hist.shape[2], int(cfg.preempt_rate > 0.0),
        int(cfg.churn_rate > 0.0), int(cfg.straggle_rate > 0.0),
        int(simlock._ks_on(cfg)), int(keyed(cfg)))
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
