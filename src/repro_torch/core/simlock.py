"""Discrete-event AMP lock simulator — the PyTorch/CUDA port of
``repro.core.simlock`` (closed-loop slice).

``N`` cores with per-core speed factors run (non-critical section ->
acquire -> critical section -> release) loops against ``L`` shared locks
under a pluggable lock policy.  One pending event per core; the phase of
the core at the head of the event clock selects the handler:

  NONCRIT end  -> acquire attempt (policy hook)
  STANDBY end  -> reorder window expired (policy hook; libasl only)
  HOLDER end   -> release: record latencies, advance epoch, pick next holder
QUEUED / SPIN cores carry ``t_ready = INF`` and are woken by the releaser.

Every sweep cell is one row of a batch: ``SimTables``, ``SimParams`` and
``SimState`` are NamedTuples of tensors with a leading cell axis, and the
step is the branchless masked form of the reference (every handler runs
in every cell under its phase mask).  On a CUDA device the event loop runs
in the hand-written kernel :func:`repro_torch.kernels.simstep.fused_chunk`
(``chunk`` events per launch, launched until no cell is live); on the CPU
the same wrapper runs :func:`_step`, the plain PyTorch version.

Scope of this slice: the paper's closed-loop experiments for ``fifo``,
``tas``, ``prop`` and ``libasl``.  Every ``SimState`` leaf is bit-identical
to the JAX package's for the same config (``tests/test_torch_simlock.py``).
A config that needs a feature outside the slice raises
``NotImplementedError`` naming it.  Entry points take ``device=None``,
which means the CUDA device; pass ``device="cpu"`` for the plain version.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import aimd, policies, stats
from repro_torch.core import columns as colreg
from repro_torch.core import energy as _energy
from repro_torch.core.policies.base import (HOLDER, INF, NONCRIT, QUEUED,
                                            SPIN, STANDBY, US, lock_of, put,
                                            rows, ticks)
from repro_torch.workloads import ARRIVALS, SERVICES
from repro_torch.workloads import keys as wlk
from repro_torch.workloads.generators import PRNGKey
from repro_torch import faults as _faults  # noqa: F401  (ft_mask column)
from repro_torch.device import resolve as _device

POLICIES = policies.policy_ids()

# Policies of the JAX package that this port does not run yet.
_LATER_POLICIES = ("edf", "shfl", "dvfs_race", "ks_erew", "ks_crew",
                   "ks_jbsq")


def _validate_config(cfg) -> None:
    """Reject NaN / negative / out-of-range fields and unknown policy
    names at construction — the reference's checks, field for field."""
    if cfg.policy in _LATER_POLICIES:
        raise NotImplementedError(
            f"lock policy {cfg.policy!r} is not ported to repro_torch yet; "
            f"ported: {sorted(POLICIES)}")
    if cfg.policy not in POLICIES:
        import difflib
        hint = difflib.get_close_matches(cfg.policy, POLICIES, n=1)
        raise ValueError(
            f"unknown lock policy {cfg.policy!r}; registered: "
            f"{sorted(POLICIES)}"
            + (f" -- did you mean {hint[0]!r}?" if hint else ""))

    def chk(name, lo=None, hi=None, lo_open=False):
        v = getattr(cfg, name)
        if v != v:  # NaN (ints compare equal to themselves)
            raise ValueError(f"SimConfig.{name} is NaN")
        if lo is not None and (v < lo or (lo_open and v == lo)):
            raise ValueError(f"SimConfig.{name} must be "
                             f"{'>' if lo_open else '>='} {lo}, got {v!r}")
        if hi is not None and v > hi:
            raise ValueError(f"SimConfig.{name} must be <= {hi}, got {v!r}")

    for name in ("long_epoch_prob", "wl_mix", "wl_amp",
                 "preempt_rate", "churn_rate", "straggle_rate"):
        chk(name, 0.0, 1.0)
    for name in ("inter_epoch_us", "wakeup_us", "default_window_us",
                 "max_window_us", "w_big", "wl_cv", "wl_period_us",
                 "preempt_scale_us", "long_epoch_scale"):
        chk(name, 0.0)
    for name in ("sim_time_us", "wl_rate", "wl_burst", "wl_mix_scale",
                 "churn_period_us"):
        chk(name, 0.0, lo_open=True)
    chk("wl_burst_len", 0.0)
    chk("straggle_scale", 1.0)
    chk("pct", 0.0, 100.0, lo_open=True)
    for name in ("n_cores", "n_locks", "epcap", "max_events", "chunk",
                 "prop_n"):
        chk(name, 1)
    chk("n_keys", 0)
    chk("hist_buckets", 4)
    chk("hist_lo_us", 0.0, lo_open=True)
    chk("hist_warmup", 0)
    if not cfg.hist_hi_us > cfg.hist_lo_us:
        raise ValueError(
            f"SimConfig.hist_hi_us must be > hist_lo_us, got "
            f"hi={cfg.hist_hi_us!r} lo={cfg.hist_lo_us!r}")
    if not math.isfinite(cfg.zipf_theta) or cfg.zipf_theta < 0.0:
        raise ValueError("SimConfig.zipf_theta must be finite and >= 0, "
                         f"got {cfg.zipf_theta!r}")
    if 0 < cfg.n_keys < cfg.n_locks:
        raise ValueError(
            f"SimConfig.n_keys={cfg.n_keys} is smaller than "
            f"n_locks={cfg.n_locks}: every lock needs at least one key "
            f"(raise n_keys or lower n_locks)")
    if len(cfg.seg_cs_us) != len(cfg.seg_noncrit_us) or \
            len(cfg.seg_cs_us) != len(cfg.seg_lock):
        raise ValueError("seg_noncrit_us / seg_cs_us / seg_lock must have "
                         "equal lengths")
    if not cfg.seg_cs_us:
        raise ValueError("epoch program needs at least one segment")
    for name in ("seg_noncrit_us", "seg_cs_us", "big", "speed_cs",
                 "speed_nc"):
        vals = getattr(cfg, name)
        if any(v != v or v < 0 for v in vals):
            raise ValueError(f"SimConfig.{name} has a NaN/negative entry: "
                             f"{vals!r}")
    for name, _ in cfg.columns:
        spec = colreg.lookup(name)      # did-you-mean on unknown names
        if spec.field:
            raise ValueError(
                f"column {name!r} has a dedicated SimConfig field "
                f"{spec.field!r}; set that instead")
    for spec in colreg.COLUMNS.values():
        if not spec.numeric:
            continue
        vals = spec.raw_values(cfg)
        if any(v != v or v < 0 for v in vals):
            raise ValueError(f"SimConfig.{spec.axis} has a NaN/negative "
                             f"entry: {vals!r}")
        if spec.positive and any(v == 0 for v in vals):
            raise ValueError(f"SimConfig.{spec.axis} entries must be "
                             f"> 0, got {vals!r}")
    for name in ("big", "speed_cs", "speed_nc"):
        if len(getattr(cfg, name)) < cfg.n_cores:
            raise ValueError(f"SimConfig.{name} has "
                             f"{len(getattr(cfg, name))} entries for "
                             f"{cfg.n_cores} cores")
    if any(not 0 <= l < cfg.n_locks for l in cfg.seg_lock):
        raise ValueError(f"seg_lock ids must be in [0, {cfg.n_locks}), "
                         f"got {cfg.seg_lock!r}")


def _check_slice(cfg) -> None:
    """Name every feature of ``cfg`` that this port does not run yet."""
    later = []
    if cfg.policy_set:
        later.append("policy_set (merged multi-policy executables)")
    if cfg.wl:
        later.append("wl (stochastic workloads)")
    if cfg.wl_open:
        later.append("wl_open (open-loop arrivals)")
    if cfg.long_epoch_prob > 0.0:
        later.append("long_epoch_prob > 0 (long epochs)")
    if cfg.wakeup_us > 0.0:
        later.append("wakeup_us > 0 (blocking-lock wakeup cost)")
    for rate in ("preempt_rate", "churn_rate", "straggle_rate"):
        if getattr(cfg, rate) > 0.0:
            later.append(f"{rate} > 0 (fault injection)")
    if cfg.n_keys > 0:
        later.append("n_keys > 0 (key-sharded traffic)")
    if cfg.hist:
        later.append("hist (streaming latency histograms)")
    if any(getattr(cfg, p) for p in _energy.POWER_COLUMNS):
        later.append("power tables p_cs/p_spin/p_park/p_idle (energy model)")
    if later:
        raise NotImplementedError(
            "repro_torch does not run these SimConfig features yet: "
            + "; ".join(later))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulator configuration — the reference's fields, so a config
    written for the JAX package constructs unchanged.  ``n_cores`` is the
    padded core count; cells may activate fewer (``n_cores`` sweep axis).
    ``use_pallas`` is accepted and has no effect: on a CUDA device the
    port always runs its kernel."""

    policy: str = "fifo"
    policy_set: tuple = ()
    use_pallas: bool = False
    n_cores: int = 8
    big: tuple = (1, 1, 1, 1, 0, 0, 0, 0)          # 4 big + 4 little (M1)
    speed_cs: tuple = (1.0,) * 4 + (3.75,) * 4     # CS slowdown (Sysbench gap)
    speed_nc: tuple = (1.0,) * 4 + (1.8,) * 4      # non-CS slowdown (NOP gap)
    # Epoch program: S segments of (noncrit_us, cs_us, lock_id)
    seg_noncrit_us: tuple = (1.0,)
    seg_cs_us: tuple = (3.0,)
    seg_lock: tuple = (0,)
    inter_epoch_us: float = 5.0
    n_locks: int = 1
    n_keys: int = 0
    zipf_theta: float = 0.99
    pct: float = 99.0
    w_big: float = 1.0            # TAS affinity weight
    prop_n: int = 10              # proportional policy ratio
    default_window_us: float = 10.0
    max_window_us: float = 100_000.0   # 100 ms upper bound (starvation-free)
    sim_time_us: float = 100_000.0
    epcap: int = 8192             # latency ring size
    hist: bool = False
    hist_buckets: int = 512
    hist_lo_us: float = 0.1
    hist_hi_us: float = 1e6
    hist_warmup: int = 32
    max_events: int = 5_000_000
    long_epoch_prob: float = 0.0
    long_epoch_scale: float = 100.0
    wakeup_us: float = 0.0
    preempt_rate: float = 0.0
    preempt_scale_us: float = 50.0
    churn_rate: float = 0.0
    churn_period_us: float = 500.0
    straggle_rate: float = 0.0
    straggle_scale: float = 10.0
    fault_mask: tuple = ()
    dvfs: tuple = ()
    p_cs: tuple = ()
    p_spin: tuple = ()
    p_park: tuple = ()
    p_idle: tuple = ()
    wl: bool = False
    wl_process: str = "poisson"
    wl_service: str = "det"
    wl_open: bool = False
    wl_service_per_core: tuple = ()
    wl_rate: float = 1.0
    wl_cv: float = 1.0
    wl_mix: float = 0.0
    wl_mix_scale: float = 10.0
    wl_burst: float = 1.0
    wl_burst_len: float = 8.0
    wl_amp: float = 0.0
    wl_period_us: float = 0.0
    slo_scale: tuple = ()
    policy_kw: tuple = ()
    columns: tuple = ()
    # Events retired per kernel launch (per plain-step chunk on the CPU);
    # results are chunk-invariant.
    chunk: int = 128

    def __post_init__(self):
        _validate_config(self)
        _check_slice(self)

    @property
    def policy_id(self) -> int:
        return POLICIES[self.policy]


class SimTables(NamedTuple):
    """Per-program arrays (leading cell axis ``B``)."""

    big: torch.Tensor       # i32[B,N] 1 = big core
    cs_dur: torch.Tensor    # i32[B,N,S] CS ticks per (core, segment)
    nc_dur: torch.Tensor    # i32[B,N,S] non-CS ticks per (core, segment)
    inter: torch.Tensor     # i32[B,N] inter-epoch ticks per core
    seg_lock: torch.Tensor  # i32[B,S] lock id per segment
    hist_log2_lo: torch.Tensor    # f32[B]
    hist_inv_log2g: torch.Tensor  # f32[B]
    col: dict               # registered per-core columns, name -> [B,N]


class SimParams(NamedTuple):
    """Per-cell scalars (``[B]`` each) — the reference's fields."""

    slo: torch.Tensor
    pol_id: torch.Tensor
    w_big: torch.Tensor
    prop_n: torch.Tensor
    n_active: torch.Tensor
    seed: torch.Tensor
    horizon: torch.Tensor
    long_prob: torch.Tensor
    long_scale: torch.Tensor
    wakeup: torch.Tensor
    unit0: torch.Tensor
    wl_process: torch.Tensor
    wl_service: torch.Tensor
    wl_rate: torch.Tensor
    wl_cv: torch.Tensor
    wl_mix: torch.Tensor
    wl_mix_scale: torch.Tensor
    wl_burst: torch.Tensor
    wl_burst_len: torch.Tensor
    wl_amp: torch.Tensor
    wl_period: torch.Tensor
    preempt_rate: torch.Tensor
    preempt_scale: torch.Tensor
    churn_rate: torch.Tensor
    churn_period: torch.Tensor
    straggle_rate: torch.Tensor
    straggle_scale: torch.Tensor
    ks_keys: torch.Tensor
    ks_theta: torch.Tensor
    ks_zeta: torch.Tensor
    ks_eta: torch.Tensor
    ks_alpha: torch.Tensor
    ks_locks: torch.Tensor
    hist_warmup: torch.Tensor
    pol: dict


_I32_PARAMS = ("pol_id", "prop_n", "n_active", "seed", "horizon", "wakeup",
               "wl_process", "wl_service", "churn_period", "ks_keys",
               "ks_locks", "hist_warmup")


class SimState(NamedTuple):
    """The reference's leaves, in its order, each with a leading cell axis.
    ``key`` is int64 ``[B,2]`` holding two u32 words; ``ep_hist`` /
    ``cs_hist`` are i32 ``[B,N,1]`` placeholders (u32 bits) while the
    histogram gate is not ported."""

    t: torch.Tensor
    key: torch.Tensor
    phase: torch.Tensor        # i32[B,N]
    t_ready: torch.Tensor      # i32[B,N]
    seg: torch.Tensor          # i32[B,N]
    epoch_start: torch.Tensor  # i32[B,N]
    attempt_t: torch.Tensor    # i32[B,N]
    window: torch.Tensor       # f32[B,N] (ticks)
    unit: torch.Tensor         # f32[B,N]
    scale: torch.Tensor        # f32[B,N]
    svc_scale: torch.Tensor    # f32[B,N]
    wl_on: torch.Tensor        # i32[B,N]
    q: torch.Tensor            # i32[B,L,2,N] rings (0=main/big, 1=little)
    q_head: torch.Tensor       # i32[B,L,2]
    q_tail: torch.Tensor       # i32[B,L,2]
    holder: torch.Tensor       # i32[B,L]
    prop_ctr: torch.Tensor     # i32[B,L]
    ep_lat: torch.Tensor       # f32[B,N,EPCAP] epoch latencies (ticks)
    ep_cnt: torch.Tensor       # i32[B,N]
    cs_lat: torch.Tensor       # f32[B,N,EPCAP] acquire->release latencies
    cs_cnt: torch.Tensor       # i32[B,N]
    events: torch.Tensor       # i32[B]
    arr_t: torch.Tensor        # i32[B,N]
    energy: torch.Tensor       # f32[B,N]
    cur_lock: torch.Tensor     # i32[B,N]
    cur_rw: torch.Tensor       # f32[B,N]
    ep_hist: torch.Tensor      # i32[B,N,1]
    cs_hist: torch.Tensor      # i32[B,N,1]
    pol: dict


# --------------------------------------------------------------------------
# Host-side construction (Python arithmetic, as in the reference: tick
# rounding is Python's round-half-to-even and stays off the device).
# --------------------------------------------------------------------------

def _tables_host(cfg: SimConfig) -> dict:
    n = cfg.n_cores
    s = len(cfg.seg_cs_us)
    f = colreg.COLUMNS["dvfs"].host_values(cfg, n)
    col = {spec.name: np.asarray(
        spec.host_values(cfg, n),
        np.int32 if spec.dtype == "i32" else np.float32)
        for spec in colreg.COLUMNS.values()}
    h_log2_lo, h_inv_log2g = stats.layout(
        cfg.hist_lo_us * US, cfg.hist_hi_us * US, max(cfg.hist_buckets, 4))
    return dict(
        big=np.asarray(cfg.big[:n], np.int32),
        cs_dur=np.asarray(
            [[ticks(cfg.seg_cs_us[j] * cfg.speed_cs[c] / f[c])
              for j in range(s)] for c in range(n)], np.int32),
        nc_dur=np.asarray(
            [[ticks(cfg.seg_noncrit_us[j] * cfg.speed_nc[c] / f[c])
              for j in range(s)] for c in range(n)], np.int32),
        inter=np.asarray(
            [ticks(cfg.inter_epoch_us * cfg.speed_nc[c]) for c in range(n)],
            np.int32),
        seg_lock=np.asarray(cfg.seg_lock, np.int32),
        hist_log2_lo=np.float32(h_log2_lo),
        hist_inv_log2g=np.float32(h_inv_log2g),
        col=col)


def _param_values(cfg: SimConfig, slo_us, seed=0, n_active=None) -> dict:
    """One cell's SimParams as numpy scalars (the reference's rounding)."""
    if cfg.policy_kw:
        raise ValueError(
            f"unknown policy_kw {sorted(dict(cfg.policy_kw))} for policy "
            f"{cfg.policy!r}; known knobs: []")
    slo = (slo_us * US).astype(np.float32) if hasattr(slo_us, "astype") \
        else np.float32(ticks(slo_us))
    ks_theta, ks_zeta, ks_eta, ks_alpha = wlk.zipf_consts(
        max(cfg.n_keys, 1), cfg.zipf_theta)
    f32, i32 = np.float32, np.int32
    return dict(
        slo=slo,
        pol_id=i32(POLICIES[cfg.policy]),
        w_big=f32(cfg.w_big),
        prop_n=i32(cfg.prop_n),
        n_active=i32(cfg.n_cores if n_active is None else n_active),
        seed=i32(seed) if not hasattr(seed, "dtype")
        else np.asarray(seed).astype(i32),
        horizon=i32(ticks(cfg.sim_time_us)),
        long_prob=f32(cfg.long_epoch_prob),
        long_scale=f32(cfg.long_epoch_scale),
        wakeup=i32(ticks(cfg.wakeup_us)),
        unit0=f32(aimd.unit_for(ticks(cfg.default_window_us), cfg.pct)),
        wl_process=i32(ARRIVALS[cfg.wl_process]),
        wl_service=i32(SERVICES[cfg.wl_service]),
        wl_rate=f32(cfg.wl_rate),
        wl_cv=f32(cfg.wl_cv),
        wl_mix=f32(cfg.wl_mix),
        wl_mix_scale=f32(cfg.wl_mix_scale),
        wl_burst=f32(cfg.wl_burst),
        wl_burst_len=f32(cfg.wl_burst_len),
        wl_amp=f32(cfg.wl_amp),
        wl_period=f32(ticks(cfg.wl_period_us if cfg.wl_period_us > 0.0
                            else cfg.sim_time_us)),
        preempt_rate=f32(cfg.preempt_rate),
        preempt_scale=f32(ticks(cfg.preempt_scale_us)),
        churn_rate=f32(cfg.churn_rate),
        churn_period=i32(max(ticks(cfg.churn_period_us), 1)),
        straggle_rate=f32(cfg.straggle_rate),
        straggle_scale=f32(cfg.straggle_scale),
        ks_keys=i32(cfg.n_keys),
        ks_theta=f32(ks_theta),
        ks_zeta=f32(ks_zeta),
        ks_eta=f32(ks_eta),
        ks_alpha=f32(ks_alpha),
        ks_locks=i32(cfg.n_locks),
        hist_warmup=i32(cfg.hist_warmup))


def _tensor(a, device) -> torch.Tensor:
    """A contiguous copy of a numpy value (0-d stays 0-d) on ``device``."""
    return torch.tensor(np.asarray(a), device=device)


def build_tables(cfg: SimConfig, device=None) -> SimTables:
    """The per-(core, segment) duration tables and the registered columns
    of one config (no cell axis), on ``device``."""
    dev = _device(device)
    h = _tables_host(cfg)
    h["col"] = {k: _tensor(v, dev) for k, v in h["col"].items()}
    return SimTables(**{k: v if k == "col" else _tensor(v, dev)
                        for k, v in h.items()})


def build_params(cfg: SimConfig, slo_us, seed=0, n_active=None,
                 device=None) -> SimParams:
    """SimParams of one run (0-d tensors) from config defaults."""
    dev = _device(device)
    vals = _param_values(cfg, slo_us, seed, n_active)
    return SimParams(**{k: _tensor(v, dev) for k, v in vals.items()},
                     pol={})


def _default_windows(cfg: SimConfig) -> np.ndarray:
    return np.full(cfg.n_cores, ticks(cfg.default_window_us), np.float32)


def _init_state(cfg: SimConfig, tb: SimTables, pm: SimParams,
                windows0: torch.Tensor) -> SimState:
    b, n, l, cap = pm.slo.shape[0], cfg.n_cores, cfg.n_locks, cfg.epcap
    dev = pm.slo.device
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    core = torch.arange(n, **i32)
    active = core[None, :] < pm.n_active[:, None]
    # Stagger initial arrivals slightly so ties don't all collapse to core 0.
    ready0 = torch.where(active, tb.nc_dur[:, :, 0] + core[None, :],
                         torch.tensor(INF, **i32))
    zeros = torch.zeros((b, n), **i32)
    return SimState(
        t=torch.zeros(b, **i32),
        key=PRNGKey(pm.seed),
        phase=zeros.clone(),
        t_ready=ready0.contiguous(),
        seg=zeros.clone(),
        epoch_start=zeros.clone(),
        attempt_t=zeros.clone(),
        window=windows0.to(**f32).contiguous(),
        unit=pm.unit0[:, None].expand(b, n).contiguous(),
        scale=torch.ones((b, n), **f32),
        svc_scale=torch.ones((b, n), **f32),
        wl_on=zeros.clone(),
        q=torch.full((b, l, 2, n), -1, **i32),
        q_head=torch.zeros((b, l, 2), **i32),
        q_tail=torch.zeros((b, l, 2), **i32),
        holder=torch.full((b, l), -1, **i32),
        prop_ctr=torch.zeros((b, l), **i32),
        ep_lat=torch.zeros((b, n, cap), **f32),
        ep_cnt=zeros.clone(),
        cs_lat=torch.zeros((b, n, cap), **f32),
        cs_cnt=zeros.clone(),
        events=torch.zeros(b, **i32),
        arr_t=zeros.clone(),
        energy=torch.zeros((b, n), **f32),
        cur_lock=zeros.clone(),
        cur_rw=torch.ones((b, n), **f32),
        ep_hist=torch.zeros((b, n, 1), **i32),
        cs_hist=torch.zeros((b, n, 1), **i32),
        pol={})


# --------------------------------------------------------------------------
# Event handlers — the plain PyTorch version of the kernel's step.  Each is
# fully conditional: it commits nothing in a cell whose ``cond`` is false.
# --------------------------------------------------------------------------

def _handle_acquire(st, cfg, tb, pm, c, t, cond) -> None:
    """A core's non-critical section ended: record the attempt time and
    let the policy decide grab / queue / standby / spin."""
    put(st.attempt_t, (c,), t, cond)
    policies.get(cfg.policy).on_acquire(st, cfg, tb, pm, c, t, cond)


def _record(buf, cnt, c, value, cond) -> None:
    """Write one latency sample into core ``c``'s ring at ``cnt % cap``."""
    r = rows(cnt)
    n = cnt[r, c]
    put(buf, (c, (n % buf.shape[2]).long()), value, cond)
    cnt[r, c] = n + cond.to(torch.int32)


def _handle_release(st, cfg, tb, pm, c, t, cond) -> None:
    pol = policies.get(cfg.policy)
    r = rows(c)
    s = st.seg[r, c]
    l = lock_of(st, tb, c)
    n_seg = len(cfg.seg_cs_us)

    # acquire->release latency (paper Figure 1 metric)
    _record(st.cs_lat, st.cs_cnt, c,
            (t - st.attempt_t[r, c]).to(torch.float32), cond)
    last = s == n_seg - 1
    # Epoch end: record latency; the policy runs its feedback.
    ep_latency = (t - st.epoch_start[r, c]).to(torch.float32)
    _record(st.ep_lat, st.ep_cnt, c, ep_latency, last & cond)
    pol.on_release(st, cfg, tb, pm, c, t, ep_latency, last, cond)

    # Advance the program: next segment, or — epoch done — the closed-loop
    # think gap (inter-epoch + segment-0 noncrit).
    nxt = torch.clamp_max(s + 1, n_seg - 1).long()
    inter = tb.inter[r, c]
    ep_start = torch.where(last, t + inter, st.epoch_start[r, c])
    ready = torch.where(last, t + inter + tb.nc_dur[r, c, 0],
                        t + tb.nc_dur[r, c, nxt])
    put(st.seg, (c,), torch.where(last, 0, s + 1), cond)
    put(st.epoch_start, (c,), ep_start, cond)
    put(st.phase, (c,), NONCRIT, cond)
    put(st.t_ready, (c,), ready, cond)

    # Hand the lock over.
    put(st.holder, (l,), -1, cond)
    pol.pick_next(st, cfg, tb, pm, l, t, cond)


def _step(cfg: SimConfig, tb: SimTables, pm: SimParams,
          st: SimState) -> None:
    """One event in every cell, in place — or nothing in a cell that is
    past its horizon or event cap (the ``live`` guard, which lets a
    fixed-size chunk retire a partial tail).  The core at the head of the
    clock is the lowest index among the minimal ``t_ready``, as
    ``jnp.argmin`` picks it."""
    r = rows(st.t)
    c = torch.argmin(st.t_ready, dim=1)
    t = st.t_ready[r, c]
    live = (t < pm.horizon) & (st.events < cfg.max_events)
    st.t.copy_(torch.where(live, t, st.t))
    st.events.add_(live.to(torch.int32))
    ph = st.phase[r, c]
    pol = policies.get(cfg.policy)
    handlers = [(NONCRIT, _handle_acquire), (HOLDER, _handle_release)]
    if pol.uses_standby:
        handlers.append((STANDBY, pol.on_standby_expiry))
    for phase, fn in handlers:
        cond = live & (ph == phase)
        # A handler commits nothing where cond is false: skip it when no
        # cell runs it.
        if bool(cond.any()):
            fn(st, cfg, tb, pm, c, t, cond)
    # QUEUED/SPIN at the head of the clock: defensive re-park.
    put(st.t_ready, (c,), INF, live & ((ph == QUEUED) | (ph == SPIN)))


def _live_cells(cfg: SimConfig, pm: SimParams, st: SimState) -> torch.Tensor:
    """Cells whose next event is before the horizon and under the cap."""
    return (st.t_ready.amin(dim=1) < pm.horizon) & \
        (st.events < cfg.max_events)


def simulate(cfg: SimConfig, tb: SimTables, pm: SimParams, st: SimState,
             chunk_fn=None) -> SimState:
    """Run every cell to its end, ``cfg.chunk`` events per call of
    ``chunk_fn`` (default: the kernel wrapper, which takes the plain
    version on CPU tensors).  Updates ``st`` in place and returns it."""
    if chunk_fn is None:
        from repro_torch.kernels import simstep
        chunk_fn = simstep.fused_chunk
    while bool(_live_cells(cfg, pm, st).any()):
        chunk_fn(tb, pm, st, cfg.chunk, cfg)
    return st


# --------------------------------------------------------------------------
# Sweeps: one batch of cells for a whole figure
# --------------------------------------------------------------------------

#: Axes this port sweeps.  Policy ids and axis names are the reference's.
SWEEPABLE = ("slo_us", "w_big", "prop_n", "seed", "n_cores", "window0_us",
             "sim_time_us")
#: The reference's other axes, which need features not ported yet.
_LATER_AXES = (
    "long_epoch_prob", "long_epoch_scale", "wakeup_us", "arrival_rate",
    "cv", "mix", "mix_scale", "burstiness", "burst_len", "preempt_rate",
    "preempt_scale", "churn_rate", "straggle_rate", "straggle_scale",
    "n_keys", "zipf_theta", "n_locks", "policy", "seg_noncrit_us",
    "seg_cs_us", "seg_lock", "inter_epoch_us", "big", "speed_cs",
    "speed_nc")


def _cell_params(cfg: SimConfig, cell: dict, slo_us, seed) -> dict:
    pm = _param_values(cfg, cell.get("slo_us", slo_us),
                       cell.get("seed", seed),
                       n_active=cell.get("n_cores", cfg.n_cores))
    if "sim_time_us" in cell:
        pm["horizon"] = np.int32(ticks(cell["sim_time_us"]))
    if "w_big" in cell:
        pm["w_big"] = np.float32(cell["w_big"])
    if "prop_n" in cell:
        pm["prop_n"] = np.int32(cell["prop_n"])
    if "window0_us" in cell:
        # A swept initial window plays the role of default_window_us, so
        # the unit floor follows it.
        pm["unit0"] = np.float32(
            aimd.unit_for(ticks(cell["window0_us"]), cfg.pct))
    return pm


def _grid_cells(cfg: SimConfig, axes: dict, product: bool) -> list:
    if not axes:
        raise ValueError("empty sweep: pass at least one axis")
    table_axes = tuple(colreg.axis_to_spec())
    for name in axes:
        if name in _LATER_AXES or name in table_axes:
            raise NotImplementedError(
                f"sweep axis {name!r} is not ported to repro_torch yet; "
                f"sweepable: {SWEEPABLE}")
        if name not in SWEEPABLE:
            raise ValueError(f"unknown sweep axis {name!r}; "
                             f"sweepable: {SWEEPABLE}")
    names = list(axes)
    vals = [list(axes[k]) for k in names]
    if product:
        idx = list(itertools.product(*(range(len(v)) for v in vals)))
    else:
        if len({len(v) for v in vals}) > 1:
            raise ValueError("product=False requires equal-length axes")
        idx = [(i,) * len(vals) for i in range(len(vals[0]))]
    cells = [{k: vals[j][ii[j]] for j, k in enumerate(names)} for ii in idx]
    if not cells:
        raise ValueError("empty sweep")
    if "n_cores" in axes and max(axes["n_cores"]) > cfg.n_cores:
        raise ValueError("n_cores axis exceeds the padded cfg.n_cores")
    return cells


def init_sweep(cfg: SimConfig, axes: dict, *, slo_us=1e9, seed=0,
               windows0=None, product: bool = True, device=None):
    """Tables, params and initial state of a sweep's cells, on ``device``.
    Returns ``(tb, pm, st, grid)``; :func:`simulate` runs them."""
    dev = _device(device)
    cells = _grid_cells(cfg, axes, product)
    b = len(cells)
    h = _tables_host(cfg)

    def rep(a):
        return _tensor(np.broadcast_to(a, (b,) + np.shape(a)), dev)

    tb = SimTables(**{k: {c: rep(v) for c, v in h["col"].items()}
                      if k == "col" else rep(v) for k, v in h.items()})
    per = [_cell_params(cfg, cell, slo_us, seed) for cell in cells]
    pm = SimParams(**{k: _tensor(np.asarray(
        [p[k] for p in per], np.int32 if k in _I32_PARAMS else np.float32),
        dev) for k in per[0]}, pol={})
    base_w = _default_windows(cfg) if windows0 is None else \
        np.asarray(windows0, np.float32)
    w0 = np.stack([
        np.full(cfg.n_cores, ticks(cell["window0_us"]), np.float32)
        if "window0_us" in cell else base_w for cell in cells])
    st = _init_state(cfg, tb, pm, _tensor(w0, dev))
    grid = {k: np.asarray([cell[k] for cell in cells]) for k in axes}
    return tb, pm, st, grid


def sweep(cfg: SimConfig, axes: dict, *, slo_us=1e9, seed=0,
          windows0=None, product: bool = True, device=None):
    """Run a whole parameter sweep as one batch of cells.

    ``axes`` maps axis names (see ``SWEEPABLE``) to value lists.  With
    ``product=True`` (default) the grid is the cross-product in the dict's
    key order; with ``product=False`` the lists are zipped.  ``n_cores``
    cells run padded to ``cfg.n_cores`` with an active-core mask.

    Returns ``(state, grid)``: ``state`` leaves have a leading cell axis;
    ``grid`` maps axis name -> np.ndarray of per-cell values.
    """
    tb, pm, st, grid = init_sweep(cfg, axes, slo_us=slo_us, seed=seed,
                                  windows0=windows0, product=product,
                                  device=device)
    return simulate(cfg, tb, pm, st), grid


def _cell(st: SimState, i: int) -> SimState:
    return SimState(**{k: v if k == "pol" else v[i]
                       for k, v in st._asdict().items()})


def run(cfg: SimConfig, slo_us, seed=0, windows0=None,
        device=None) -> SimState:
    """Run one simulation: a sweep of one cell, returned without the cell
    axis (``windows0`` carries AIMD windows across phases)."""
    st, _ = sweep(cfg, {"seed": [seed]}, slo_us=slo_us, windows0=windows0,
                  device=device)
    return _cell(st, 0)


# --------------------------------------------------------------------------
# The carry between the packages: reference pytrees <-> port tensors
# --------------------------------------------------------------------------

def _from_np(x, name: str, batch: bool, dev) -> torch.Tensor:
    a = np.asarray(x)
    if name == "key":
        a = a.astype(np.int64)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    t = _tensor(a, dev)
    return t if batch else t[None]


def from_reference(tb, pm, st, device=None):
    """The JAX package's ``SimTables`` / ``SimParams`` / ``SimState`` (numpy
    or jax arrays, with or without a leading cell axis) as the port's
    tensors on ``device``.  A state without a cell axis gets one of 1."""
    dev = _device(device)
    batch = np.ndim(st.t) == 1

    def conv(nt, cls):
        out = {}
        for k, v in nt._asdict().items():
            if isinstance(v, dict):
                out[k] = {n: _from_np(x, n, batch, dev) for n, x in v.items()}
            else:
                out[k] = _from_np(v, k, batch, dev)
        return cls(**out)

    return conv(tb, SimTables), conv(pm, SimParams), conv(st, SimState)


def _to_np(x: torch.Tensor, name: str) -> np.ndarray:
    a = x.detach().cpu().numpy()
    if name == "key":
        return a.astype(np.uint32)
    if name in ("ep_hist", "cs_hist"):
        return a.view(np.uint32)
    return a


def to_reference(st: SimState) -> SimState:
    """The state as numpy arrays with the reference's leaf names, shapes
    and dtypes (``key`` u32, histogram placeholders u32), so
    ``tests/golden_digests.py::digest_state`` hashes both packages alike."""
    out = {}
    for k, v in st._asdict().items():
        out[k] = {n: _to_np(x, n) for n, x in v.items()} if k == "pol" \
            else _to_np(v, k)
    return SimState(**out)


# --------------------------------------------------------------------------
# Host-side summaries (numpy, as in the reference)
# --------------------------------------------------------------------------

def sweep_summaries(cfg: SimConfig, st: SimState, grid: dict,
                    warmup: int = 32, slo_us=None) -> list:
    """Per-cell summaries of a sweep result (one host transfer)."""
    st_np = to_reference(st) if isinstance(st.t, torch.Tensor) else st
    n_cells = len(next(iter(grid.values()))) if grid else \
        st_np.events.shape[0]
    out = []
    for i in range(n_cells):
        n_act = int(grid["n_cores"][i]) if "n_cores" in grid else None
        cell_slo = float(grid["slo_us"][i]) if "slo_us" in grid else slo_us
        s = summarize(cfg, _cell(st_np, i), warmup, n_active=n_act,
                      slo_us=cell_slo)
        s.update({k: grid[k][i] for k in grid})
        out.append(s)
    return out


def _ring_values(buf: np.ndarray, cnt: int, warmup: int = 32) -> np.ndarray:
    """A core's recorded latency samples minus the first ``warmup``, oldest
    first; empty when ``cnt <= warmup``.  A wrapped ring (``cnt > cap``)
    holds the most recent ``cap`` samples."""
    cap = buf.shape[0]
    if cnt <= cap:
        return buf[min(warmup, cnt):cnt]
    pos = cnt % cap
    vals = np.concatenate([buf[pos:], buf[:pos]])
    return vals[max(0, warmup - (cnt - cap)):]


def summarize(cfg: SimConfig, st: SimState, warmup: int = 32,
              n_active: int = None, slo_us: float = None) -> dict:
    """Throughput + tail latency per core class (all values in us) of one
    cell — the reference's keys and arithmetic.  ``n_active`` slices
    per-core outputs for padded sweep cells; ``slo_us`` adds goodput."""
    if isinstance(st.t, torch.Tensor):
        st = to_reference(st)
    n = cfg.n_cores if n_active is None else int(n_active)
    big = np.asarray(cfg.big[:n], bool)
    ep_lat = np.asarray(st.ep_lat)[:n]
    ep_cnt = np.asarray(st.ep_cnt)[:n]
    cs_lat = np.asarray(st.cs_lat)[:n]
    cs_cnt = np.asarray(st.cs_cnt)[:n]
    t_end = float(np.asarray(st.t)) / US
    sim_s = max(t_end, 1e-9) / 1e6
    cap = ep_lat.shape[1]
    wrapped = bool((ep_cnt > cap).any() or (cs_cnt > cap).any())

    ep_vals = [_ring_values(ep_lat[c], int(ep_cnt[c]), warmup)
               for c in range(n)]
    cs_vals = [_ring_values(cs_lat[c], int(cs_cnt[c]), warmup)
               for c in range(n)]

    def collect(vals, mask):
        sel = [vals[c] for c in range(n) if mask[c]]
        v = np.concatenate(sel) if sel else np.zeros(0)
        return v / US  # -> microseconds

    out = {
        "sim_time_us": t_end,
        "events": int(np.asarray(st.events)),
        "throughput_cs_per_s": float(cs_cnt.sum()) / sim_s,
        "throughput_epochs_per_s": float(ep_cnt.sum()) / sim_s,
        "cs_per_core": cs_cnt.tolist(),
        "epochs_per_core": ep_cnt.tolist(),
    }
    for name, mask in (("all", np.ones_like(big)), ("big", big),
                       ("little", ~big)):
        ep = collect(ep_vals, mask)
        cs = collect(cs_vals, mask)
        out[f"ep_p99_{name}_us"] = stats.percentile(ep, 99)
        out[f"ep_p50_{name}_us"] = stats.percentile(ep, 50)
        out[f"cs_p99_{name}_us"] = stats.percentile(cs, 99)
    if wrapped:
        # A ring overwrote history: the percentiles above only see the
        # most recent `epcap` samples (recency-biased).
        out["tail_truncated"] = True
    out["final_window_us"] = (np.asarray(st.window)[:n] / US).tolist()
    # The energy model is not ported: the accumulator stays zero.
    e_j = np.asarray(st.energy)[:n].astype(float) * 1e-8
    out["energy_per_core_j"] = e_j.tolist()
    out["energy_j"] = float(e_j.sum())
    if slo_us is not None:
        scl = colreg.COLUMNS["slo_scale"].np_values(cfg, n)
        good = tot = 0
        for c in range(n):
            v = ep_vals[c]  # the same samples the percentiles used
            good += int(np.sum(v / US <= slo_us * scl[c]))
            tot += v.size
        frac = good / tot if tot else 0.0
        out["slo_good_frac"] = frac
        out["goodput_eps"] = out["throughput_epochs_per_s"] * frac
    return out
