"""Discrete-event AMP lock simulator — the PyTorch/CUDA port of
``repro.core.simlock``.

``N`` cores with per-core speed factors run (non-critical section ->
acquire -> critical section -> release) loops against ``L`` shared locks
under a pluggable lock policy.  One pending event per core; the phase of
the core at the head of the event clock selects the handler:

  NONCRIT end  -> acquire attempt (policy hook)
  STANDBY end  -> reorder window expired (policy hook; libasl only)
  HOLDER end   -> release: record latencies, advance epoch, pick next holder
  ARRIVAL due  -> open loop (``wl_open``): the next request arrives
QUEUED / SPIN cores carry ``t_ready = INF`` and are woken by the releaser.

Every sweep cell is one row of a batch: ``SimTables``, ``SimParams`` and
``SimState`` are NamedTuples of tensors with a leading cell axis, and the
step is the branchless masked form of the reference (every handler runs
in every cell under its phase mask).  On a CUDA device the event loop runs
in the hand-written kernel :func:`repro_torch.kernels.simstep.fused_chunk`
(``chunk`` events per launch, launched until no cell is live); on the CPU
the same wrapper runs :func:`_step`, the plain PyTorch version.

Scope: the reference's simulator under its ten policies (``fifo``,
``tas``, ``prop``, ``libasl``, ``edf``, ``shfl``, ``dvfs_race`` and the
key-sharded ``ks_erew``, ``ks_crew``, ``ks_jbsq``): merged policy sets (a
``policy`` axis), program and column table axes, long epochs, the
blocking-lock wakeup cost, the energy model, stochastic workloads closed
and open loop (``wl``, ``wl_open``), streaming histograms (``hist``),
fault injection (holder preemption, core churn, straggler spikes) and
key-sharded traffic (``n_keys``: each epoch's lock a Zipf-drawn key's
bucket, the ``n_keys`` / ``zipf_theta`` / ``n_locks`` axes).  The draws
go through XLA's own f32 ``log1p`` / ``exp`` / ``erf_inv`` / ``log2`` and
glibc's ``powf`` (:mod:`repro_torch.core.xla_math`), so every
``SimState`` leaf is bit-identical to the JAX package's for the same
config (``tests/test_torch_simlock*.py``); the diurnal ramp's ``sin``
alone may differ by an ulp.  Entry points take ``device=None``, which
means the CUDA device; pass ``device="cpu"`` for the plain version.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import aimd, policies, stats
from repro_torch.core import columns as colreg
from repro_torch.core import energy as _energy
from repro_torch.core import xla_math as xm
from repro_torch.core.policies.base import (ARRIVAL, HOLDER, INF, NONCRIT,
                                            QUEUED, SPIN, STANDBY, US,
                                            advance_key, lock_of, put, rows,
                                            ticks)
from repro_torch.faults import model as flt
from repro_torch.workloads import ARRIVALS, SERVICES
from repro_torch.workloads import generators as wlg
from repro_torch.workloads import keys as wlk
from repro_torch.workloads.generators import PRNGKey, uniform
from repro_torch.device import resolve as _device
from repro_torch.dist.sharding import row_splits

POLICIES = policies.policy_ids()


def _validate_config(cfg) -> None:
    """Reject NaN / negative / out-of-range fields and unknown policy
    names at construction — the reference's checks, field for field."""
    if cfg.policy not in POLICIES:
        import difflib
        hint = difflib.get_close_matches(cfg.policy, POLICIES, n=1)
        raise ValueError(
            f"unknown lock policy {cfg.policy!r}; registered: "
            f"{sorted(POLICIES)}"
            + (f" -- did you mean {hint[0]!r}?" if hint else ""))
    if cfg.policy_set:
        for p in cfg.policy_set:
            if p not in POLICIES:
                raise ValueError(
                    f"policy_set entry {p!r} is not registered; "
                    f"registered: {sorted(POLICIES)}")
        if len(set(cfg.policy_set)) != len(cfg.policy_set):
            raise ValueError(
                f"policy_set has duplicates: {cfg.policy_set!r}")
        if cfg.policy not in cfg.policy_set:
            raise ValueError(
                f"policy {cfg.policy!r} is not in "
                f"policy_set {cfg.policy_set!r}")

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

    @property
    def policy_id(self) -> int:
        return POLICIES[self.policy]


def _active_policy(cfg: SimConfig):
    """The registered policy, or the cached merged set of
    ``cfg.policy_set`` (each cell runs the member ``SimParams.pol_id``
    names)."""
    if cfg.policy_set:
        return policies.merged(cfg.policy_set)
    return policies.get(cfg.policy)


def _wl_on(cfg: SimConfig) -> bool:
    """The workload gate: per-epoch draws (``wl``; open loop implies it)."""
    return bool(cfg.wl or cfg.wl_open)


def _energy_on(cfg: SimConfig) -> bool:
    """The energy gate: is any per-core power table set?  (All-zero
    tables turn it on too and integrate exact zeros.)"""
    return bool(cfg.p_cs or cfg.p_spin or cfg.p_park or cfg.p_idle)


def _ks_on(cfg: SimConfig) -> bool:
    """The key-shard gate: is each epoch's lock drawn from the Zipf key
    stream (rather than the segment program's)?"""
    return cfg.n_keys > 0


def _rw_draw_gate(cfg: SimConfig, pm):
    """Does a cell draw the per-epoch read/write uniform?  A single policy
    gives its ``uses_rw`` (a Python bool); a merged set a ``[B]`` mask of
    the cells whose member reads it, so a fifo cell beside ks_crew keeps
    ``cur_rw == 1.0`` as under its own policy."""
    if not cfg.policy_set:
        return policies.get(cfg.policy).uses_rw
    ids = _active_policy(cfg).rw_member_ids()
    if not ids:
        return False
    m = pm.pol_id == ids[0]
    for pid in ids[1:]:
        m = m | (pm.pol_id == pid)
    return m


_ZETA2: dict = {}


def _zeta2(pm) -> torch.Tensor:
    """Each cell's ``1 + 0.5 ** theta`` (:func:`keys.zipf_zeta2`), cached
    per ``ks_theta`` tensor: every key draw of a sweep uses it."""
    hit = _ZETA2.get(id(pm.ks_theta))
    if hit is not None and hit[0] is pm.ks_theta:
        return hit[1]
    z = wlk.zipf_zeta2(pm.ks_theta)
    if len(_ZETA2) > 64:
        _ZETA2.clear()
    _ZETA2[id(pm.ks_theta)] = (pm.ks_theta, z)
    return z


def _draw_locks(pm, u) -> torch.Tensor:
    """The lock of each uniform ``u`` (``[B]`` or ``[B, N]``) under its
    cell's Zipf constants: the key's bucket, as the compiled reference
    draws it."""
    def col(x):
        return x if u.dim() == 1 else x[:, None]

    key = wlk.zipf_key(u, col(pm.ks_keys), None, col(pm.ks_zeta),
                       col(pm.ks_eta), col(pm.ks_alpha),
                       zeta2=col(_zeta2(pm)))
    return wlk.key_to_lock(key, col(pm.ks_locks))


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
    ``cs_hist`` hold u32 counts as i32, ``[B,N,hist_buckets]`` when the
    histogram gate is on and ``[B,N,1]`` (all zero) when it is off."""

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
    ep_hist: torch.Tensor      # i32[B,N,H] epoch-latency counts
    cs_hist: torch.Tensor      # i32[B,N,H] acquire->release counts
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
    """One cell's SimParams as numpy scalars (the reference's rounding);
    the policy's own knobs under ``"pol"``."""
    pol = _active_policy(cfg).init_params(cfg)
    unknown = set(dict(cfg.policy_kw)) - set(pol)
    if unknown:
        raise ValueError(
            f"unknown policy_kw {sorted(unknown)} for policy "
            f"{cfg.policy!r}; known knobs: {sorted(pol)}")
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
        hist_warmup=i32(cfg.hist_warmup),
        pol=pol)


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
    pol = {k: _tensor(v, dev) for k, v in vals.pop("pol").items()}
    return SimParams(**{k: _tensor(v, dev) for k, v in vals.items()},
                     pol=pol)


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
    stagger = core[None, :]
    zeros = torch.zeros((b, n), **i32)
    inf = torch.tensor(INF, **i32)
    think0 = scale0 = svc0 = torch.ones((b, n), **f32)   # cloned below
    wl_on0 = zeros.clone()
    nc0 = tb.nc_dur[:, :, 0]
    if _wl_on(cfg):
        # Epoch-0 workload draws, pure in (seed, core, 0).
        def u0(stream):
            keys = wlg.core_keys(pm.seed, stream, n)
            return uniform(wlg.fold_in(keys, 0))

        u_t, u_s, u_p = (u0(wlg.STREAM_THINK), u0(wlg.STREAM_SERVICE),
                         u0(wlg.STREAM_PHASE))
        z_s = wlg.normal_of_uniform(u0(wlg.STREAM_SERVICE ^ 0x40000))
        wl_on0 = (u_p < 0.5).to(torch.int32)

        def col(x):
            return x[:, None]

        think0 = wlg.think_gap(u_t, col(pm.wl_process), col(pm.wl_rate),
                               wl_on0, col(pm.wl_burst),
                               torch.zeros((b, n), **f32), col(pm.wl_amp))
        svc0 = wlg.service_unit(u_s, z_s, _svc_dist(tb, pm),
                                col(pm.wl_cv), col(pm.wl_mix),
                                col(pm.wl_mix_scale))
        if not cfg.wl_open:
            scale0 = think0
            nc0 = (nc0.to(torch.float32) * scale0).to(torch.int32)
    if cfg.wl_open:
        # Every core starts parked on its pending-ARRIVAL event; arrival 0
        # is drawn from the think stream (gap base = the closed-loop
        # think budget inter + noncrit).
        base = (tb.inter + tb.nc_dur[:, :, 0]).to(torch.float32)
        arr0 = torch.clamp_min((base * think0).to(torch.int32), 1) + stagger
        phase0 = torch.full((b, n), ARRIVAL, **i32)
        ready0 = torch.where(active, arr0, inf)
    else:
        arr0 = zeros.clone()
        phase0 = zeros.clone()
        ready0 = torch.where(active, nc0 + stagger, inf)
    cur_lock0 = zeros.clone()
    cur_rw0 = torch.ones((b, n), **f32)
    if _ks_on(cfg):
        # Epoch-0 key (and read/write) draws, pure in (seed, core, 0); an
        # open loop draws index 0 again at its first arrival.
        def u0(stream):
            keys = wlg.core_keys(pm.seed, stream, n)
            return uniform(wlg.fold_in(keys, 0))

        cur_lock0 = _draw_locks(pm, u0(wlg.STREAM_KEY))
        gate = _rw_draw_gate(cfg, pm)
        if gate is not False:
            draws = u0(wlg.STREAM_RW)
            cur_rw0 = draws if gate is True else \
                torch.where(gate[:, None], draws, cur_rw0)
    hb = cfg.hist_buckets if cfg.hist else 1
    return SimState(
        t=torch.zeros(b, **i32),
        key=PRNGKey(pm.seed),
        phase=phase0,
        t_ready=ready0.contiguous(),
        seg=zeros.clone(),
        epoch_start=zeros.clone(),
        attempt_t=zeros.clone(),
        window=windows0.to(**f32).contiguous(),
        unit=pm.unit0[:, None].expand(b, n).contiguous(),
        scale=scale0.clone(),
        svc_scale=svc0.clone(),
        wl_on=wl_on0.contiguous(),
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
        arr_t=arr0.contiguous(),
        energy=torch.zeros((b, n), **f32),
        cur_lock=cur_lock0.contiguous(),
        cur_rw=cur_rw0.contiguous(),
        ep_hist=torch.zeros((b, n, hb), **i32),
        cs_hist=torch.zeros((b, n, hb), **i32),
        pol=_active_policy(cfg).init_state(cfg, b, dev))


# --------------------------------------------------------------------------
# Event handlers — the plain PyTorch version of the kernel's step.  Each is
# fully conditional: it commits nothing in a cell whose ``cond`` is false.
# --------------------------------------------------------------------------

def _svc_dist(tb, pm, c=None) -> torch.Tensor:
    """The SERVICES id in effect: the per-core ``wl_service`` column where
    set (multi-class tenants), else the cell's ``wl_service``; ``[B, N]``,
    or ``[B]`` for core ``c``."""
    if c is None:
        per_core = tb.col["wl_service"]
        return torch.where(per_core >= 0, per_core, pm.wl_service[:, None])
    per_core = tb.col["wl_service"][rows(c), c]
    return torch.where(per_core >= 0, per_core, pm.wl_service)


def _phase01(pm, t) -> torch.Tensor:
    """The diurnal cycle position of tick ``t``: ``mod(t / period, 1)``."""
    return torch.fmod(t.to(torch.float32) / torch.clamp_min(pm.wl_period,
                                                            1.0), 1.0)


def _handle_acquire(st, cfg, tb, pm, c, t, cond) -> None:
    """A core's non-critical section ended: record the attempt time and
    let the policy decide grab / queue / standby / spin.  Under core
    churn, an attempt in an "off" slot bounces to the next slot boundary
    instead (the policy never sees it)."""
    if cfg.churn_rate > 0.0:
        n = st.phase.shape[1]
        off = flt.churn_off(pm.seed, c, t,
                            pm.churn_rate * tb.col["ft_mask"][rows(c), c],
                            pm.churn_period, n)
        put(st.t_ready, (c,), flt.churn_rejoin(t, pm.churn_period),
            cond & off)
        cond = cond & ~off
    put(st.attempt_t, (c,), t, cond)
    _active_policy(cfg).on_acquire(st, cfg, tb, pm, c, t, cond)


def _record(buf, cnt, c, value, cond) -> None:
    """Write one latency sample into core ``c``'s ring at ``cnt % cap``."""
    r = rows(cnt)
    n = cnt[r, c]
    put(buf, (c, (n % buf.shape[2]).long()), value, cond)
    cnt[r, c] = n + cond.to(torch.int32)


#: ``a * b + c`` in f32 with one rounding (:func:`xla_math.fma`).
fma_f32 = xm.fma


def _hist_record(hist, tb, c, value, cond) -> None:
    """One latency sample (ticks) into core ``c``'s log-bucketed histogram
    row where ``cond``: ``1 + floor((log2(max(v, 1e-6)) - log2_lo) *
    inv_log2g)``, clipped, with XLA's f32 log and the fused multiply-add
    the compiled reference makes of ``log2(v) - log2_lo``."""
    if not bool(cond.any()):            # commits nothing
        return
    r = rows(c)
    lg = xm.fma(xm.log(torch.clamp_min(value, _HIST_FLOOR)), xm.LOG2_MUL,
                -tb.hist_log2_lo) * tb.hist_inv_log2g
    idx = torch.clamp(1 + torch.floor(lg).to(torch.int32), 0,
                      hist.shape[2] - 1).long()
    hist[r, c, idx] += cond.to(torch.int32)


_HIST_FLOOR = float(np.float32(1e-6))
# The streams an epoch's draws come from: service u and z, think, phase.
_EPOCH_STREAMS = (wlg.STREAM_SERVICE, wlg.STREAM_SERVICE ^ 0x40000,
                  wlg.STREAM_THINK, wlg.STREAM_PHASE)


def _handle_arrival(st, cfg, tb, pm, c, t, cond) -> None:
    """Open loop (``wl_open``): the pending-ARRIVAL event fired.  The epoch
    begins at its true arrival time ``arr_t[c]`` (in the past when the
    core is backlogged, so the epoch latency includes the queueing), and
    the next arrival's gap is drawn (index: the arrivals so far + 1)."""
    r = rows(c)
    n = st.phase.shape[1]
    a = st.arr_t[r, c]
    u = wlg.event_uniforms(pm.seed, _EPOCH_STREAMS[2:], c,
                           st.ep_cnt[r, c] + 1, n)
    on = wlg.phase_flip(u[:, 1], st.wl_on[r, c], pm.wl_burst_len)
    gap = wlg.think_gap(u[:, 0], pm.wl_process, pm.wl_rate, on, pm.wl_burst,
                        _phase01(pm, t), pm.wl_amp)
    base = (tb.inter[r, c] + tb.nc_dur[r, c, 0]).to(torch.float32)
    nxt = a + torch.clamp_min((base * gap).to(torch.int32), 1)
    nc0 = (tb.nc_dur[r, c, 0].to(torch.float32) * st.scale[r, c]) \
        .to(torch.int32)
    put(st.arr_t, (c,), nxt, cond)
    put(st.wl_on, (c,), on, cond)
    put(st.epoch_start, (c,), a, cond)
    put(st.phase, (c,), NONCRIT, cond)
    put(st.t_ready, (c,), t + nc0, cond)
    if _ks_on(cfg):
        # The epoch this arrival begins (index ep_cnt) draws its key.
        _key_draws(st, cfg, pm, c, st.ep_cnt[r, c], cond)


def _key_draws(st, cfg, pm, c, ep, cond) -> None:
    """Core ``c``'s epoch ``ep``: its lock from the key stream and, where
    the cell's policy reads it, its read/write uniform (where ``cond``)."""
    gate = _rw_draw_gate(cfg, pm)
    streams = (wlg.STREAM_KEY,) if gate is False else \
        (wlg.STREAM_KEY, wlg.STREAM_RW)
    u = wlg.event_uniforms(pm.seed, streams, c, ep, st.phase.shape[1])
    put(st.cur_lock, (c,), _draw_locks(pm, u[:, 0]), cond)
    if gate is not False:
        put(st.cur_rw, (c,), u[:, 1], cond if gate is True else cond & gate)


def _power_draw(tb, pm, st) -> torch.Tensor:
    """``[B, N]`` watts by phase: computing (NONCRIT / HOLDER) and
    busy-waiting (SPIN / STANDBY) scale with ``dvfs^3``; parked (QUEUED)
    and idle draw their floor; inactive padded cores draw idle."""
    ph = st.phase
    f = tb.col["dvfs"]
    f3 = (f * f) * f                  # jnp's integer_pow(f, 3)
    p_idle = tb.col["p_idle"]
    p = torch.where(
        (ph == NONCRIT) | (ph == HOLDER), tb.col["p_cs"] * f3,
        torch.where((ph == SPIN) | (ph == STANDBY), tb.col["p_spin"] * f3,
                    torch.where(ph == QUEUED, tb.col["p_park"], p_idle)))
    core = torch.arange(ph.shape[1], device=ph.device)
    return torch.where(core[None, :] < pm.n_active[:, None], p, p_idle)


def _handle_release(st, cfg, tb, pm, c, t, cond) -> None:
    pol = _active_policy(cfg)
    r = rows(c)
    s = st.seg[r, c]
    l = lock_of(st, cfg, tb, c)
    n_seg = len(cfg.seg_cs_us)

    # acquire->release latency (paper Figure 1 metric).  The histograms
    # count a sample whose index (the count before it) is past the warmup.
    cs_latency = (t - st.attempt_t[r, c]).to(torch.float32)
    if cfg.hist:
        _hist_record(st.cs_hist, tb, c, cs_latency,
                     cond & (st.cs_cnt[r, c] >= pm.hist_warmup))
    _record(st.cs_lat, st.cs_cnt, c, cs_latency, cond)
    last = s == n_seg - 1
    # Epoch end: record latency; the policy runs its feedback.
    ep_latency = (t - st.epoch_start[r, c]).to(torch.float32)
    if cfg.hist:
        _hist_record(st.ep_hist, tb, c, ep_latency,
                     last & cond & (st.ep_cnt[r, c] >= pm.hist_warmup))
    _record(st.ep_lat, st.ep_cnt, c, ep_latency, last & cond)
    pol.on_release(st, cfg, tb, pm, c, t, ep_latency, last, cond)

    # The next epoch's workload.  Bench-3's long epochs: every release
    # splits the key, and an epoch end draws the scale of its
    # non-critical work.  ``wl``: counter draws by (seed, core, the next
    # epoch's index) set its service scale and (closed loop) its think
    # scale and MMPP phase.
    upd = last & cond
    new_scale = None
    if cfg.long_epoch_prob > 0.0:
        u = uniform(advance_key(st, cond))
        new_scale = torch.where(u < pm.long_prob, pm.long_scale, 1.0)
    if _wl_on(cfg) and bool(upd.any()):
        streams = _EPOCH_STREAMS[:2 if cfg.wl_open else 4]
        u = wlg.event_uniforms(pm.seed, streams, c, st.ep_cnt[r, c],
                               st.phase.shape[1])
        svc = wlg.service_unit(u[:, 0], wlg.normal_of_uniform(u[:, 1]),
                               _svc_dist(tb, pm, c), pm.wl_cv, pm.wl_mix,
                               pm.wl_mix_scale)
        put(st.svc_scale, (c,), svc, upd)
        if not cfg.wl_open:
            u_t, u_p = u[:, 2], u[:, 3]
            on = wlg.phase_flip(u_p, st.wl_on[r, c], pm.wl_burst_len)
            think = wlg.think_gap(u_t, pm.wl_process, pm.wl_rate, on,
                                  pm.wl_burst, _phase01(pm, t), pm.wl_amp)
            new_scale = think if new_scale is None else new_scale * think
            put(st.wl_on, (c,), on, upd)
    elif _wl_on(cfg) and not cfg.wl_open and new_scale is None:
        # No cell ends an epoch (the draws would commit nothing): the
        # durations keep the current epoch's think scale.
        new_scale = st.scale[r, c]
    if new_scale is not None:
        scale_c = torch.where(upd, new_scale, st.scale[r, c])
        st.scale[r, c] = scale_c

        def _sc(d):
            return (d.to(torch.float32) * scale_c).to(torch.int32)
    else:
        def _sc(d):
            return d

    if _ks_on(cfg) and not cfg.wl_open and bool(upd.any()):
        # Closed loop: the next epoch's key (ep_cnt counts it now).  The
        # releaser's old lock ``l`` is already read, and pick_next's scans
        # never include the releaser.
        _key_draws(st, cfg, pm, c, st.ep_cnt[r, c], upd)

    # Advance the program: next segment, or (epoch done) the closed-loop
    # think gap (inter-epoch + segment-0 noncrit), or the open-loop
    # pending-ARRIVAL event at the next arrival (possibly already past).
    nxt = torch.clamp_max(s + 1, n_seg - 1).long()
    mid_ready = t + _sc(tb.nc_dur[r, c, nxt])
    if cfg.wl_open:
        ep_start = st.epoch_start[r, c]
        ready = torch.where(last, torch.maximum(t, st.arr_t[r, c]),
                            mid_ready)
        phase_next = torch.where(last, ARRIVAL, NONCRIT).to(torch.int32)
    else:
        inter = _sc(tb.inter[r, c])
        ep_start = torch.where(last, t + inter, st.epoch_start[r, c])
        ready = torch.where(last, t + inter + _sc(tb.nc_dur[r, c, 0]),
                            mid_ready)
        phase_next = NONCRIT
    put(st.seg, (c,), torch.where(last, 0, s + 1), cond)
    put(st.epoch_start, (c,), ep_start, cond)
    put(st.phase, (c,), phase_next, cond)
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
    if _energy_on(cfg):
        # Every core spends the clock's advance in its current phase.
        # The compiled reference contracts this multiply-add into one
        # FMA (one rounding); fma_f32 gives its bits.
        dt = torch.where(live, (t - st.t).to(torch.float32), 0.0)
        st.energy.copy_(fma_f32(dt[:, None], _power_draw(tb, pm, st),
                                st.energy))
    st.t.copy_(torch.where(live, t, st.t))
    st.events.add_(live.to(torch.int32))
    ph = st.phase[r, c]
    pol = _active_policy(cfg)
    handlers = [(NONCRIT, _handle_acquire), (HOLDER, _handle_release)]
    if pol.uses_standby:
        handlers.append((STANDBY, pol.on_standby_expiry))
    if cfg.wl_open:
        handlers.append((ARRIVAL, _handle_arrival))
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


#: Kernel launches between two liveness checks on the host (CUDA tensors).
#: Each check synchronises the host with the card; a launch after every
#: cell has finished changes nothing (the kernel's per-cell guard), so up
#: to LIVENESS_GROUP - 1 launches past the end cost only their latency.
LIVENESS_GROUP = 16


def run_chunks(cfg: SimConfig, pm: SimParams, st: SimState, launch,
               group: int = 1) -> int:
    """Call ``launch()`` (one chunk of every cell) until no cell is live,
    checking on the host once per ``group`` calls; -> the calls made."""
    return _run_blocks(cfg, [(pm, st, launch, group)])[0]


def _run_blocks(cfg: SimConfig, blocks: list) -> list:
    """:func:`run_chunks` over several blocks of cells, each
    ``(pm, st, launch, group)``, their groups of launches interleaved (a
    split sweep's blocks on their devices); -> the calls made a block."""
    calls = [0] * len(blocks)
    live = list(range(len(blocks)))
    while True:
        live = [i for i in live
                if bool(_live_cells(cfg, *blocks[i][:2]).any())]
        if not live:
            return calls
        for i in live:
            launch, group = blocks[i][2:]
            for _ in range(group):
                launch()
            calls[i] += group


def _launcher(cfg: SimConfig, tb: SimTables, pm: SimParams, st: SimState,
              chunk_fn=None) -> tuple:
    """(one chunk of every cell of ``st``, launches a liveness check)."""
    if chunk_fn is not None:
        return (lambda: chunk_fn(tb, pm, st, cfg.chunk, cfg)), 1
    from repro_torch.kernels import simstep
    return simstep.bind(tb, pm, st, cfg.chunk, cfg), \
        LIVENESS_GROUP if st.t.device.type == "cuda" else 1


def simulate(cfg: SimConfig, tb: SimTables, pm: SimParams, st: SimState,
             chunk_fn=None) -> SimState:
    """Run every cell to its end, ``cfg.chunk`` events per call of
    ``chunk_fn`` (default: the kernel wrapper, which takes the plain
    version on CPU tensors).  Updates ``st`` in place and returns it.

    By default the operands are checked once (``simstep.bind``) and, on
    CUDA tensors, liveness once per ``LIVENESS_GROUP`` launches; on CPU
    tensors, and with a given ``chunk_fn``, after every chunk."""
    run_chunks(cfg, pm, st, *_launcher(cfg, tb, pm, st, chunk_fn))
    return st


# --------------------------------------------------------------------------
# Sweeps: one batch of cells for a whole figure
# --------------------------------------------------------------------------

#: The stochastic-workload axes and the SimParams field each sets.
_WL_AXES = {"arrival_rate": "wl_rate", "cv": "wl_cv", "mix": "wl_mix",
            "mix_scale": "wl_mix_scale", "burstiness": "wl_burst",
            "burst_len": "wl_burst_len"}
#: The fault axes that set their SimParams field as given (f32).
_FAULT_AXES = ("preempt_rate", "churn_rate", "straggle_rate",
               "straggle_scale")
#: The key-shard axes: each cell's Zipf constants and active lock count
#: (``n_locks`` cells run against the padded ``cfg.n_locks`` locks).
_KS_AXES = ("n_keys", "zipf_theta", "n_locks")
#: Axes that set one SimParams field per cell (``_cell_params``).
_PARAM_AXES = ("slo_us", "w_big", "prop_n", "seed", "n_cores",
               "long_epoch_prob", "long_epoch_scale", "wakeup_us") + \
    tuple(_WL_AXES) + _FAULT_AXES + ("preempt_scale",) + _KS_AXES
#: Gated features: sweeping the axis turns the gate on in the template.
_GATE_AXES = ("long_epoch_prob", "wakeup_us", "preempt_rate",
              "churn_rate", "straggle_rate")
#: Program axes: SimConfig fields rebuilt into each cell's tables.
_PROGRAM_AXES = ("seg_noncrit_us", "seg_cs_us", "seg_lock",
                 "inter_epoch_us", "big", "speed_cs", "speed_nc")


def table_axes() -> tuple:
    """Axes that rebuild ``SimTables`` per cell: the program axes and
    every registered sweepable column's axis."""
    return _PROGRAM_AXES + tuple(colreg.axis_to_spec())


def _sweepable() -> tuple:
    return _PARAM_AXES + table_axes() + (
        "window0_us", "policy", "sim_time_us")


#: Axes this port sweeps (names are the reference's).
SWEEPABLE = _sweepable()


def sweepable_axes(cfg: SimConfig) -> tuple:
    """All sweep axes valid for ``cfg``: the engine's and the policy's
    own (``shfl_bound``, ``race_bound``)."""
    base = _sweepable()
    return base + tuple(
        a for a in _active_policy(cfg).sweep_axes if a not in base)


def table_columns(cfg: SimConfig) -> dict:
    """Every registered column as ``build_tables`` materializes it
    (encoded and padded), keyed by column name."""
    return {spec.name: spec.host_values(cfg, cfg.n_cores)
            for spec in colreg.COLUMNS.values()}


def with_columns(cfg: SimConfig, **cols) -> SimConfig:
    """Set registered per-core columns by column name: dedicated-field
    columns go to their SimConfig field, the others into
    ``cfg.columns``.  Unknown names raise with a did-you-mean."""
    for name, vals in cols.items():
        spec = colreg.lookup(name)
        if spec.field:
            cfg = dataclasses.replace(cfg, **{spec.field: tuple(vals)})
        else:
            d = dict(cfg.columns)
            d[name] = tuple(vals)
            cfg = dataclasses.replace(cfg, columns=tuple(sorted(d.items())))
    return cfg


def _cell_tables_cfg(cfg: SimConfig, cell: dict, table_keys) -> SimConfig:
    """A cell's table-axis values applied to the template config."""
    by_axis = colreg.axis_to_spec()
    for k in table_keys:
        if k in _PROGRAM_AXES:
            cfg = dataclasses.replace(cfg, **{k: cell[k]})
        else:
            cfg = with_columns(cfg, **{by_axis[k].name: tuple(cell[k])})
    return cfg


def _cell_params(cfg: SimConfig, cell: dict, slo_us, seed) -> dict:
    pm = _param_values(cfg, cell.get("slo_us", slo_us),
                       cell.get("seed", seed),
                       n_active=cell.get("n_cores", cfg.n_cores))
    if "policy" in cell:
        pm["pol_id"] = np.int32(POLICIES[cell["policy"]])
    if "sim_time_us" in cell:
        pm["horizon"] = np.int32(ticks(cell["sim_time_us"]))
    if "w_big" in cell:
        pm["w_big"] = np.float32(cell["w_big"])
    if "prop_n" in cell:
        pm["prop_n"] = np.int32(cell["prop_n"])
    if "long_epoch_prob" in cell:
        pm["long_prob"] = np.float32(cell["long_epoch_prob"])
    if "long_epoch_scale" in cell:
        pm["long_scale"] = np.float32(cell["long_epoch_scale"])
    if "wakeup_us" in cell:
        pm["wakeup"] = np.int32(ticks(cell["wakeup_us"]))
    for axis, field in _WL_AXES.items():
        if axis in cell:
            pm[field] = np.float32(cell[axis])
    for axis in _FAULT_AXES:
        if axis in cell:
            pm[axis] = np.float32(cell[axis])
    if "preempt_scale" in cell:
        pm["preempt_scale"] = np.float32(ticks(cell["preempt_scale"]))
    if any(a in cell for a in _KS_AXES):
        # The Zipf constants are host-derived from (n_keys, theta): rebuild
        # them all, as build_params would for this cell's config.
        nk = int(cell.get("n_keys", cfg.n_keys))
        th, ze, et, al = wlk.zipf_consts(
            max(nk, 1), float(cell.get("zipf_theta", cfg.zipf_theta)))
        pm.update(ks_keys=np.int32(nk), ks_theta=np.float32(th),
                  ks_zeta=np.float32(ze), ks_eta=np.float32(et),
                  ks_alpha=np.float32(al),
                  ks_locks=np.int32(cell.get("n_locks", cfg.n_locks)))
    if "window0_us" in cell:
        # A swept initial window plays the role of default_window_us, so
        # the unit floor follows it.
        pm["unit0"] = np.float32(
            aimd.unit_for(ticks(cell["window0_us"]), cfg.pct))
    for axis, slot in _active_policy(cfg).sweep_axes.items():
        if axis in cell and slot in pm["pol"]:
            pm["pol"] = dict(pm["pol"], **{slot: np.asarray(
                cell[axis], pm["pol"][slot].dtype)})
    return pm


def sweep_config(cfg: SimConfig, axes: dict) -> SimConfig:
    """The config a sweep over ``axes`` runs under, as the reference's
    ``sweep`` derives it: a ``policy`` axis grows ``policy_set`` (each
    cell's member rides in ``SimParams.pol_id``), and a swept gated
    feature (long epochs, wakeup, the fault rates, a workload axis,
    watts, ``n_keys``) turns its gate on.
    :func:`init_sweep` and :func:`simulate` take this config."""
    if not axes:
        raise ValueError("empty sweep: pass at least one axis")
    if "policy" in axes:
        if not axes["policy"]:
            raise ValueError("policy axis needs at least one name")
        pset = tuple(dict.fromkeys(
            tuple(cfg.policy_set) + tuple(axes["policy"])))
        cfg = dataclasses.replace(cfg, policy_set=pset, policy=pset[0])
    allowed = sweepable_axes(cfg)
    for name in axes:
        if name not in allowed:
            raise ValueError(f"unknown sweep axis {name!r}; "
                             f"sweepable: {allowed}")
    for gate in _GATE_AXES:
        if gate in axes and max(axes[gate]) > 0.0:
            cfg = dataclasses.replace(cfg, **{gate: max(axes[gate])})
    if not cfg.wl and any(a in axes for a in _WL_AXES):
        cfg = dataclasses.replace(cfg, wl=True)
    # An n_keys axis turns the key-shard gate on; the other key axes need
    # it on.
    if "n_keys" in axes:
        if any(int(v) < 1 for v in axes["n_keys"]):
            raise ValueError("n_keys axis values must be >= 1")
        if not _ks_on(cfg):
            cfg = dataclasses.replace(
                cfg, n_keys=int(max(int(v) for v in axes["n_keys"])))
    if not _ks_on(cfg) and any(a in axes for a in _KS_AXES):
        bad = [a for a in _KS_AXES if a in axes]
        raise ValueError(
            f"sweep axes {bad} need the key-shard gate on: set "
            f"SimConfig.n_keys > 0 (or include an n_keys axis)")
    if "n_locks" in axes:
        if any(not 1 <= int(v) <= cfg.n_locks for v in axes["n_locks"]):
            raise ValueError(
                f"n_locks axis values must lie in [1, cfg.n_locks="
                f"{cfg.n_locks}] (the padded lock-vector size)")
    # Swept watts turn the energy gate on ((0.0,) pads to all-zero
    # tables, so cells that do not sweep a power column are unchanged).
    if not _energy_on(cfg) and any(
            a in axes and any(any(float(x) != 0.0 for x in v)
                              for v in axes[a])
            for a in _energy.POWER_COLUMNS):
        cfg = dataclasses.replace(cfg, p_idle=(0.0,))
    return cfg


def _grid_cells(cfg: SimConfig, axes: dict, product: bool) -> list:
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
    if any(a in axes for a in _KS_AXES):
        for cell in cells:
            nk = int(cell.get("n_keys", cfg.n_keys))
            nl = int(cell.get("n_locks", cfg.n_locks))
            if nk < nl:
                raise ValueError(
                    f"sweep cell pairs n_keys={nk} with n_locks={nl}: "
                    f"every lock needs at least one key")
    return cells


def _host_windows(windows0) -> np.ndarray:
    """A ``windows0`` (numpy, list, or a tensor on any device) as f32."""
    if isinstance(windows0, torch.Tensor):
        windows0 = windows0.detach().cpu().numpy()
    return np.asarray(windows0, np.float32)


def _host_cells(cfg: SimConfig, cells: list, names, slo_us, seed,
                windows0) -> tuple:
    """The host values of ``cells``, each with a leading cell axis, in
    numpy: ``(tables, params, windows)`` (``tables["col"]`` and
    ``params["pol"]`` dicts of arrays), as ``init_sweep`` uploads them.
    ``names`` are the sweep's axes."""
    b = len(cells)
    tbl_axes = table_axes()
    table_keys = [k for k in names if k in tbl_axes]
    if table_keys:
        hs = [_tables_host(_cell_tables_cfg(cfg, cell, table_keys))
              for cell in cells]

        def cat(get):
            return np.stack([get(h) for h in hs])
    else:
        h1 = _tables_host(cfg)

        def cat(get):
            a = get(h1)
            return np.broadcast_to(a, (b,) + np.shape(a))
    tables = {k: {c: cat(lambda h, c=c: h["col"][c]) for c in colreg.COLUMNS}
              if k == "col" else cat(lambda h, k=k: h[k])
              for k in SimTables._fields}
    per = [_cell_params(cfg, cell, slo_us, seed) for cell in cells]
    params = {k: np.asarray([p[k] for p in per], np.int32
                            if k in _I32_PARAMS else np.float32)
              for k in per[0] if k != "pol"}
    params["pol"] = {k: np.stack([p["pol"][k] for p in per])
                     for k in per[0]["pol"]}
    base_w = _default_windows(cfg) if windows0 is None else \
        _host_windows(windows0)
    w0 = np.stack([
        np.full(cfg.n_cores, ticks(cell["window0_us"]), np.float32)
        if "window0_us" in cell else base_w for cell in cells])
    return tables, params, w0


def _upload(cfg: SimConfig, host: tuple, lo: int, hi: int, dev) -> tuple:
    """Cells ``lo:hi`` of :func:`_host_cells`' values on ``dev``:
    ``(tb, pm, st)``, the state initial."""
    tables, params, w0 = host

    def up(x):
        return {k: _tensor(v[lo:hi], dev) for k, v in x.items()} \
            if isinstance(x, dict) else _tensor(x[lo:hi], dev)

    tb = SimTables(**{k: up(v) for k, v in tables.items()})
    pm = SimParams(**{k: up(v) for k, v in params.items()})
    return tb, pm, _init_state(cfg, tb, pm, _tensor(w0[lo:hi], dev))


def _grid(cells: list, names) -> dict:
    tbl_axes = table_axes()
    return {k: np.asarray([cell[k] for cell in cells], dtype=object)
            if k in tbl_axes else np.asarray([cell[k] for cell in cells])
            for k in names}


def init_sweep(cfg: SimConfig, axes: dict, *, slo_us=1e9, seed=0,
               windows0=None, product: bool = True, device=None):
    """Tables, params and initial state of a sweep's cells, on ``device``.
    Returns ``(tb, pm, st, grid)``; :func:`simulate` runs them.  ``cfg``
    must be ``sweep_config(cfg, axes)`` (raises otherwise), the config
    :func:`simulate` then takes."""
    dev = _device(device)
    if sweep_config(cfg, axes) != cfg:
        raise ValueError("these axes need the config sweep_config(cfg, "
                         "axes) gives; pass that to init_sweep and "
                         "simulate")
    cells = _grid_cells(cfg, axes, product)
    host = _host_cells(cfg, cells, axes, slo_us, seed, windows0)
    return (*_upload(cfg, host, 0, len(cells), dev), _grid(cells, axes))


def init_state(cfg: SimConfig, seed: int = 0, windows0=None,
               device=None) -> SimState:
    """One run's initial state, without the cell axis (as :func:`run`
    returns its state): params at SLO 0, as the reference's
    ``init_state`` builds them."""
    host = _host_cells(cfg, [{}], (), 0.0, seed, windows0)
    return _cell(_upload(cfg, host, 0, 1, _device(device))[2], 0)


# --------------------------------------------------------------------------
# Sweep accounting: one record per sweep call, and the executables loaded
# --------------------------------------------------------------------------

_BATCH_EXECS: dict = {}          # signature -> the first call's record
_BATCH_LOCK = threading.Lock()   # the dict and the log
_SWEEP_LOG: list = []
MAX_SWEEP_LOG = 4096


def _account(cfg: SimConfig, blocks: list, calls: list, devices: list,
             n_cells: int) -> dict:
    """Record a sweep call (or one resumed slice) whose ``blocks`` of
    ``(tb, pm, st)`` ran to their end in ``calls`` launches each, and
    register its executable; -> the record."""
    from repro_torch.kernels import simstep
    tb, pm, st = blocks[0]
    key = (simstep.signature(tb, pm, st, cfg),
           tuple(str(d) for d in devices))
    launches = sum(calls)
    moved = sum(simstep.launch_bytes(tb, pm, None, st, cfg, n) * n
                for (tb, pm, st), n in zip(blocks, calls) if n)
    rec = {"instantiation": simstep.instantiation_name(cfg),
           "n_cells": n_cells, "devices": len(devices),
           "launches": launches,
           "events": sum(int(b[2].events.sum()) for b in blocks),
           "launch_bytes": moved / launches if launches else 0.0}
    with _BATCH_LOCK:
        _BATCH_EXECS.setdefault(key, rec)
        _SWEEP_LOG.append(rec)
        if len(_SWEEP_LOG) > MAX_SWEEP_LOG:  # bound long-lived processes
            del _SWEEP_LOG[:-MAX_SWEEP_LOG]
    return rec


def n_batch_executables() -> int:
    """Distinct executables loaded so far: a ``fused_chunk`` instantiation
    (``simstep.instantiation``; deterministic or stochastic, keyed or
    not) at one operand signature (the operands it passes, their shapes
    and dtypes, the devices).  The perf protocol: fig1's registered
    policies give one each."""
    return len(_BATCH_EXECS)


def executable_records() -> list:
    """Per-executable records in load order, each the record of the
    first sweep call that ran it (:func:`sweep_log`'s keys).

    The reference's records hold XLA's cost analysis (``flops``,
    ``bytes_accessed``) and the collective schedule of a mesh-sharded
    sweep; the port compiles no XLA and fakes none of them.  In their
    place: ``events`` (the work), ``launch_bytes`` (the bytes a launch
    must move, ``simstep.launch_bytes``: every cell that retires an event
    reads its tables, params and state once and writes its state once,
    plus the ring samples and histogram counts) and ``launches``; a split
    sweep gathers its blocks by copies, with no collective."""
    with _BATCH_LOCK:
        return list(_BATCH_EXECS.values())


def sweep_log() -> list:
    """One record per :func:`sweep` call (cache hits included; a
    resumable sweep one per slice it runs): ``instantiation``,
    ``n_cells``, ``devices``, ``launches`` (the calls ``run_chunks``
    made), ``events`` and ``launch_bytes``.  Holds the most recent
    ``MAX_SWEEP_LOG`` calls."""
    with _BATCH_LOCK:
        return list(_SWEEP_LOG)


def _run_cells(cfg: SimConfig, blocks: list, devices: list,
               n_cells: int) -> None:
    """Run ``blocks`` of ``(tb, pm, st)`` to their end and record it."""
    calls = _run_blocks(cfg, [(pm, st, *_launcher(cfg, tb, pm, st))
                              for tb, pm, st in blocks])
    _account(cfg, blocks, calls, devices, n_cells)


def _concat(parts: list, dev, n: int) -> SimState:
    """The states of consecutive blocks of cells as one, on ``dev``,
    its first ``n`` cells."""
    if len(parts) == 1 and parts[0].t.device == dev:
        cat = parts[0]
    else:
        def join(xs):
            return torch.cat([x.to(dev) for x in xs])

        cat = SimState(**{
            k: {n_: join([p.pol[n_] for p in parts]) for n_ in parts[0].pol}
            if k == "pol" else join([getattr(p, k) for p in parts])
            for k in SimState._fields})
    if cat.t.shape[0] == n:
        return cat
    return SimState(**{k: {n_: x[:n] for n_, x in v.items()} if k == "pol"
                       else v[:n] for k, v in cat._asdict().items()})


def _sweep_resumable(cfg: SimConfig, host: tuple, dev, resume_dir,
                     chunk: int) -> SimState:
    """Run the sweep's cells in ``chunk``-cell slices, saving each
    finished slice atomically (``repro_torch.ckpt.checkpointer``), so an
    interrupted sweep resumes from its last saved slice.  Each cell's
    trajectory is its own (the kernel runs a cell a warp and a finished
    cell's launches change nothing), so a slice's cells end as they do in
    the whole sweep, bit for bit."""
    import hashlib
    import json
    from pathlib import Path

    from repro_torch import tree
    from repro_torch.ckpt import checkpointer as ckpt

    n_cells = len(host[2])
    chunk = max(int(chunk), 1)
    bounds = [(lo, min(lo + chunk, n_cells))
              for lo in range(0, n_cells, chunk)]
    first = _upload(cfg, host, *bounds[0], dev)
    # Fingerprint the sweep: resuming into a directory that holds another
    # config or grid (or one the JAX package wrote) would splice unrelated
    # results.  The digest covers every value uploaded; the name lists
    # and the leaves' shapes and dtypes catch what values cannot.
    h = hashlib.sha256()
    for x in tree.leaves(host):
        h.update(np.ascontiguousarray(x).tobytes())
    fp = {"canon": repr(cfg), "n_cells": n_cells, "chunk": chunk,
          "digest": h.hexdigest(),
          "columns": sorted(host[0]["col"]), "pol": sorted(host[1]["pol"]),
          "leaves": [[list(np.shape(x)), np.asarray(x).dtype.name]
                     for x in tree.leaves(host[:2])]
          + [[list(x.shape[1:]), str(x.dtype).removeprefix("torch.")]
             for x in tree.leaves(first[2])]}
    d = Path(resume_dir)
    d.mkdir(parents=True, exist_ok=True)
    fp_path = d / "sweep.json"
    if fp_path.exists():
        if json.loads(fp_path.read_text()) != fp:
            raise ValueError(
                f"resume_dir {str(resume_dir)!r} holds a different sweep "
                f"(config or grid changed); use a fresh directory")
    else:
        fp_path.write_text(json.dumps(fp))
    done = ckpt.latest_step(d)          # slices 0..done are on disk
    parts = []
    for k, (lo, hi) in enumerate(bounds):
        tb, pm, st = first if k == 0 else _upload(cfg, host, lo, hi, dev)
        if done is not None and k <= done:
            parts.append(ckpt.restore(d, k, st))
            continue
        _run_cells(cfg, [(tb, pm, st)], [dev], hi - lo)
        ckpt.save(d, k, st)
        parts.append(st)
    return _concat(parts, dev, n_cells)


def sweep(cfg: SimConfig, axes: dict, *, slo_us=1e9, seed=0,
          windows0=None, product: bool = True, device=None, devices=None,
          resume_dir=None, resume_chunk: int = 8):
    """Run a whole parameter sweep as one batch of cells.

    ``axes`` maps axis names (see ``SWEEPABLE``) to value lists.  With
    ``product=True`` (default) the grid is the cross-product in the dict's
    key order; with ``product=False`` the lists are zipped.  ``n_cores``
    cells run padded to ``cfg.n_cores`` with an active-core mask.

    A ``policy`` axis runs its policies as one merged set, and sweeping
    a gated feature turns it on (:func:`sweep_config`).

    ``devices`` (a sequence of devices, repeats allowed) splits the
    cells over them, the port's counterpart of the reference's ``mesh``
    / ``data_axis`` (a 1-D data mesh): the cells are padded to a multiple
    of the device count by repeating the last cell, each device runs a
    contiguous block of them (``repro_torch.dist.sharding.row_splits``;
    the blocks' launches interleaved from this thread), and the result
    is gathered on ``devices[0]`` and trimmed, bit-identical to the
    unsplit sweep.  ``device`` is then not used.

    ``resume_dir`` makes a long sweep resumable: cells run in
    ``resume_chunk``-cell slices, each saved atomically when it finishes
    (``repro_torch.ckpt.checkpointer``, beside a ``sweep.json``
    fingerprint); the same sweep with the same directory restores the
    saved slices and runs the rest, bit-identical to an uninterrupted
    run.  A directory that holds another sweep raises.  Not composable
    with ``devices``.

    Each call is recorded (:func:`sweep_log`, :func:`executable_records`).

    Returns ``(state, grid)``: ``state`` leaves have a leading cell axis;
    ``grid`` maps axis name -> np.ndarray of per-cell values (object
    arrays for table axes, as the reference gives them).
    """
    if resume_dir is not None and devices is not None:
        raise ValueError("resume_dir does not compose with split sweeps "
                         "(devices=); run chunked-resumable sweeps unsplit")
    cfg = sweep_config(cfg, axes)
    cells = _grid_cells(cfg, axes, product)
    grid, n_cells = _grid(cells, axes), len(cells)
    if devices is None:
        devs = [_device(device)]
    else:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("devices must name at least one device")
        cells = cells + cells[-1:] * ((-n_cells) % len(devs))
    host = _host_cells(cfg, cells, axes, slo_us, seed, windows0)
    if resume_dir is not None:
        return _sweep_resumable(cfg, host, devs[0], resume_dir,
                                resume_chunk), grid
    blocks, lo = [], 0
    for dev, rows in zip(devs, row_splits(len(cells), len(devs))):
        blocks.append(_upload(cfg, host, lo, lo + rows, dev))
        lo += rows
    _run_cells(cfg, blocks, devs, len(cells))
    return _concat([b[2] for b in blocks], devs[0], n_cells), grid


def sweep_slo(cfg: SimConfig, slo_us_values, seed=0,
              device=None) -> SimState:
    """Paper Figure 8b in one call (a thin wrapper over :func:`sweep`)."""
    st, _ = sweep(cfg, {"slo_us": list(np.asarray(slo_us_values, float))},
                  seed=seed, device=device)
    return st


def _cell(st: SimState, i: int) -> SimState:
    return SimState(**{k: {n: x[i] for n, x in v.items()} if k == "pol"
                       else v[i] for k, v in st._asdict().items()})


def run(cfg: SimConfig, slo_us, seed=0, windows0=None,
        device=None) -> SimState:
    """Run one simulation: a sweep of one cell, returned without the cell
    axis (``windows0`` carries AIMD windows across phases, from numpy or
    from a previous run's ``window`` on any device)."""
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


def hist_tail(cfg: SimConfig, ep_hist, cs_hist, slo_us=None,
              slo_scale=None, prefix: str = "hist_") -> dict:
    """Tail metrics from per-core streaming histograms (``cfg.hist``):
    ``ep_hist`` / ``cs_hist`` are ``[n, H]`` u32 counts of the active
    cores, merged across cores by summation.  P50 / P99 / P999 epoch and
    P99 CS latency per core class in microseconds (each within the
    layout's relative-error bound), and the histogram-side SLO-good
    fraction when ``slo_us`` is given."""
    n = ep_hist.shape[0]
    big = np.asarray(cfg.big[:n], bool)
    lo_t, hi_t = cfg.hist_lo_us * US, cfg.hist_hi_us * US
    out = {}
    for name, mask in (("all", np.ones_like(big)), ("big", big),
                       ("little", ~big)):
        he = stats.merge(ep_hist[mask]) if mask.any() else \
            np.zeros(ep_hist.shape[1], np.uint64)
        hc = stats.merge(cs_hist[mask]) if mask.any() else \
            np.zeros(cs_hist.shape[1], np.uint64)
        for q, tag in ((50, "p50"), (99, "p99"), (99.9, "p999")):
            out[f"ep_{tag}_{prefix}{name}_us"] = \
                stats.quantile(he, q, lo_t, hi_t) / US
        out[f"cs_p99_{prefix}{name}_us"] = \
            stats.quantile(hc, 99, lo_t, hi_t) / US
    out[f"{prefix}rel_err_bound"] = stats.rel_err_bound(
        lo_t, hi_t, ep_hist.shape[1])
    if slo_us is not None:
        scl = np.ones(n) if slo_scale is None else np.asarray(slo_scale)
        good = tot = 0.0
        for c in range(n):
            good += stats.good_count(ep_hist[c], slo_us * scl[c] * US,
                                     lo_t, hi_t)
            tot += float(np.asarray(ep_hist[c], np.uint64).sum())
        out[f"slo_good_frac_{prefix.rstrip('_')}"] = \
            good / tot if tot else float("nan")
    return out


def fleet_tail(cfg: SimConfig, st: SimState, slo_us=None) -> dict:
    """Fleet-wide tail metrics of a sweep state: the streaming histograms
    merged over every cell and core (a sum on the state's device, u32 as
    the reference's device-side partial sum), quantiles on the host."""
    if not cfg.hist:
        raise ValueError("fleet_tail needs a cfg with hist=True")

    def merged(h):
        if isinstance(h, torch.Tensor):
            h = h.reshape(-1, h.shape[-1]).to(torch.int64).sum(0)
            return (h.cpu().numpy() & 0xFFFFFFFF).astype(np.uint64)[None]
        h = np.asarray(h, np.uint32).reshape(-1, np.shape(h)[-1])
        return h.sum(0, dtype=np.uint32).astype(np.uint64)[None]

    cfg1 = dataclasses.replace(cfg, n_cores=1, big=(0,), speed_cs=(1.0,),
                               speed_nc=(1.0,))
    return {k: v for k, v in hist_tail(cfg1, merged(st.ep_hist),
                                       merged(st.cs_hist), slo_us).items()
            if "_big_" not in k and "_little_" not in k}


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
    if cfg.hist:
        # Full-history quantiles at bounded relative error; where a ring
        # wrapped they replace the ring's (truncated) percentiles.
        eph = np.asarray(st.ep_hist, np.uint64)[:n]
        csh = np.asarray(st.cs_hist, np.uint64)[:n]
        out.update(hist_tail(cfg, eph, csh))
        if wrapped:
            for name in ("all", "big", "little"):
                out[f"ep_p99_{name}_us"] = out[f"ep_p99_hist_{name}_us"]
                out[f"ep_p50_{name}_us"] = out[f"ep_p50_hist_{name}_us"]
                out[f"cs_p99_{name}_us"] = out[f"cs_p99_hist_{name}_us"]
    out["final_window_us"] = (np.asarray(st.window)[:n] / US).tolist()
    # The accumulator is in watt-ticks; 1 tick = 10 ns, so 1 watt-tick =
    # 10 nJ.  The efficiency keys appear only when energy was modeled.
    e_j = np.asarray(st.energy)[:n].astype(float) * 1e-8
    out["energy_per_core_j"] = e_j.tolist()
    out["energy_j"] = float(e_j.sum())
    if out["energy_j"] > 0.0:
        out["power_w"] = out["energy_j"] / sim_s
        out["tput_per_watt"] = (out["throughput_cs_per_s"]
                                / out["power_w"])
        p50 = out["ep_p50_all_us"]
        # EDP = energy x delay (J*s); delay = the median epoch latency.
        out["edp"] = out["energy_j"] * p50 * 1e-6 if np.isfinite(p50) \
            else float("nan")
    if slo_us is not None:
        scl = colreg.COLUMNS["slo_scale"].np_values(cfg, n)
        good = tot = 0
        for c in range(n):
            v = ep_vals[c]  # the same samples the percentiles used
            good += int(np.sum(v / US <= slo_us * scl[c]))
            tot += v.size
        frac = good / tot if tot else 0.0
        if cfg.hist:
            hg = hist_tail(cfg, eph, csh, slo_us=slo_us, slo_scale=scl)
            out["slo_good_frac_hist"] = hg["slo_good_frac_hist"]
            if wrapped:
                # The ring fraction sees only the most recent epochs.
                frac = out["slo_good_frac_hist"]
        out["slo_good_frac"] = frac
        out["goodput_eps"] = out["throughput_epochs_per_s"] * frac
    return out
