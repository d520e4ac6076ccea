"""The lock-policy contract and the shared simulator vocabulary, on
batched tensors.

Every state leaf carries a leading cell axis ``B`` (one row per sweep
cell), and every per-event quantity is a ``[B]`` vector: the core ``c``
whose event fires, its clock ``t``, and the ``cond`` mask of cells that
run the hook.  A hook commits nothing in a cell whose ``cond`` is false,
exactly as the JAX package's fully conditional hooks do, so the masked
step applies every handler to every cell and stays bit-identical to the
reference.  Hooks update the state tensors in place (one row per cell,
so an advanced-index write never collides).

The CUDA kernel (``repro_torch/kernels/csrc/simstep.cu``) implements the
same hooks per cell, one instantiation per policy and one that switches
on each cell's policy id (merged sets); these hooks are the plain
version it is held against.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.faults import model as flt
from repro_torch.workloads import generators as gen

# Phases == event types (one pending event per core).
NONCRIT, STANDBY, QUEUED, HOLDER, SPIN, ARRIVAL = 0, 1, 2, 3, 4, 5
INF = 1 << 30

# 1 tick = 10 ns
US = 100  # ticks per microsecond


def ticks(us: float) -> int:
    """Microseconds to integer ticks, rounding half to even (Python's
    ``round``, as the reference does — keep this on the host)."""
    return int(round(us * US))


@functools.lru_cache(maxsize=64)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device)


def rows(x: torch.Tensor) -> torch.Tensor:
    """Row index ``0..B-1`` for advanced indexing of a batched leaf."""
    return _arange(x.shape[0], x.device)


def put(x: torch.Tensor, idx: tuple, val, cond: torch.Tensor) -> None:
    """``x[rows, *idx] = val`` in the cells where ``cond`` holds."""
    key = (rows(x),) + idx
    if isinstance(val, torch.Tensor):
        if val.dtype != x.dtype:
            val = val.to(x.dtype)
    elif not (x.dtype.is_floating_point or isinstance(val, int)):
        val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    # (a Python scalar goes to torch.where as it is: no copy to the card)
    x[key] = torch.where(cond, val, x[key])


# --------------------------------------------------------------------------
# Queue helpers (ring buffers ``q[B, L, 2, N]``).  All conditional.
# --------------------------------------------------------------------------

def enq(st, cond, l, b, c) -> None:
    r = rows(st.q)
    n = st.q.shape[-1]
    tail = st.q_tail[r, l, b]
    put(st.q, (l, b, (tail % n).long()), c, cond)
    st.q_tail[r, l, b] = tail + cond.to(torch.int32)


def deq(st, cond, l, b) -> torch.Tensor:
    """Pop the head of queue ``(l, b)`` where ``cond``; returns the core
    (int64), ``-1`` where nothing was popped."""
    r = rows(st.q)
    n = st.q.shape[-1]
    head = st.q_head[r, l, b]
    do = cond & (st.q_tail[r, l, b] > head)
    c = torch.where(do, st.q[r, l, b, (head % n).long()], -1)
    st.q_head[r, l, b] = head + do.to(torch.int32)
    return c.long()


def qlen(st, l, b) -> torch.Tensor:
    r = rows(st.q)
    return st.q_tail[r, l, b] - st.q_head[r, l, b]


def weighted_pick(key: torch.Tensor, weights: torch.Tensor):
    """Draw an index ~ ``weights[B, N]`` with one uniform per cell.

    The prefix sum is taken left to right in f32, one core at a time —
    the order ``jnp.cumsum`` gives on the simulator's weight sets (a
    parallel scan rounds differently).  The total is the last prefix, and
    the pick is the first index whose prefix exceeds ``u * total`` (0 when
    none does).  Returns ``(pick int64[B], total > 0)``."""
    acc = weights[:, 0]
    cum = [acc]
    for j in range(1, weights.shape[1]):
        acc = acc + weights[:, j]
        cum.append(acc)
    cum = torch.stack(cum, dim=1)
    total = cum[:, -1]
    u = gen.uniform(key) * total
    pick = torch.argmax((cum > u[:, None]).to(torch.int32), dim=1)
    return pick, total > 0.0


def lock_of(st, cfg, tb, c) -> torch.Tensor:
    """The lock core ``c`` currently contends: with keyed traffic
    (``cfg.n_keys > 0``) its epoch's Zipf-drawn lock (``st.cur_lock``),
    else its segment's lock."""
    r = rows(st.seg)
    if cfg.n_keys > 0:
        return st.cur_lock[r, c].long()
    return tb.seg_lock[r, st.seg[r, c].long()].long()


def lock_vec(st, cfg, tb) -> torch.Tensor:
    """Per-core lock ids ``[B, N]`` — the vectorized :func:`lock_of`."""
    if cfg.n_keys > 0:
        return st.cur_lock
    return torch.gather(tb.seg_lock, 1, st.seg.long())


def policy_opts(cfg) -> dict:
    """``SimConfig.policy_kw`` as a dict (policy-owned numeric knobs)."""
    return dict(cfg.policy_kw)


def grant(st, cfg, tb, pm, cond, c, t, wakeup: bool = False) -> None:
    """Make core ``c`` (where ``cond``) the holder of its lock and
    schedule its release after its segment's critical section, in the
    reference's order: scaled by the epoch's ``wl`` service draw (at least
    one tick), plus a straggler spike and a preemption stall (drawn by the
    core's critical-section count, the rates times its ``ft_mask``), plus
    the wakeup where ``wakeup`` and the gate is on (only queue-pop
    handoffs pay it, never an acquire's grab, a spinner or a standby)."""
    r = rows(st.seg)
    c_safe = torch.clamp_min(c, 0)
    s = st.seg[r, c_safe].long()
    l = lock_of(st, cfg, tb, c_safe)
    dur = tb.cs_dur[r, c_safe, s]
    if cfg.wl or cfg.wl_open:
        dur = torch.clamp_min(
            (dur.to(torch.float32) * st.svc_scale[r, c_safe])
            .to(torch.int32), 1)
    if cfg.straggle_rate > 0.0 or cfg.preempt_rate > 0.0:
        if not bool(cond.any()):        # commits nothing: skip the draws
            return
        gix = st.cs_cnt[r, c_safe]
        eligible = tb.col["ft_mask"][r, c_safe]
        n = st.phase.shape[1]
    if cfg.straggle_rate > 0.0:
        dur = dur + flt.straggle_extra(
            pm.seed, c_safe, gix, dur, pm.straggle_rate * eligible,
            pm.straggle_scale, n)
    if cfg.preempt_rate > 0.0:
        dur = dur + flt.preempt_extra(
            pm.seed, c_safe, gix, pm.preempt_rate * eligible,
            pm.preempt_scale, n)
    if wakeup and cfg.wakeup_us > 0.0:
        dur = dur + pm.wakeup
    put(st.holder, (l,), c_safe, cond)
    put(st.phase, (c_safe,), HOLDER, cond)
    put(st.t_ready, (c_safe,), t + dur, cond)


def park(st, cond, c, new_phase) -> None:
    """Send core ``c`` (where ``cond``) into a passive phase (QUEUED/SPIN):
    it carries ``t_ready = INF`` until a releaser wakes it."""
    put(st.phase, (c,), new_phase, cond)
    put(st.t_ready, (c,), INF, cond)


def waiting_mask(st, cfg, tb, l, phase=QUEUED) -> torch.Tensor:
    """``[B, N]``: cores parked in ``phase`` on lock ``l`` — the waiter set
    the queue-less policies (edf, shfl, dvfs_race, ks_*) scan at a
    release."""
    return (st.phase == phase) & (lock_vec(st, cfg, tb) == l[:, None])


def queueless_acquire(st, cfg, tb, pm, c, t, cond) -> None:
    """The queue-less acquire (edf, shfl, dvfs_race, ks_*): grab when the
    lock is free and nobody waits on it, else park in QUEUED for the
    releaser's scan."""
    l = lock_of(st, cfg, tb, c)
    free = st.holder[rows(l), l] == -1
    can_grab = free & ~waiting_mask(st, cfg, tb, l).any(dim=1)
    grant(st, cfg, tb, pm, can_grab & cond, c, t)
    park(st, ~can_grab & cond, c, QUEUED)


def advance_key(st, cond):
    """Split every cell's key; keep the new key where ``cond``.  Returns
    the subkeys (drawn in every cell, committed nowhere)."""
    ks = gen.split(st.key)
    st.key.copy_(torch.where(cond[:, None], ks[:, 0], st.key))
    return ks[:, 1]


# --------------------------------------------------------------------------
# The policy contract
# --------------------------------------------------------------------------

class LockPolicy:
    """Base class: one instance per registered policy (stateless — all
    per-run state lives in SimState)."""

    #: registry key; also the ``SimConfig.policy`` value.
    name: str = None
    #: True iff the policy parks cores in STANDBY.
    uses_standby: bool = False
    #: True iff the policy reads the per-epoch read/write uniform
    #: (``SimState.cur_rw``): only then do keyed runs draw it.
    uses_rw: bool = False
    #: SimParams fields this policy reads.
    param_slots: tuple = ()
    #: SimTables slots this policy reads.
    table_slots: tuple = ()
    #: SimState fields this policy owns.
    state_slots: tuple = ()
    #: sweep-axis name -> SimParams field (policy knobs as batch axes).
    sweep_axes: dict = {}
    #: host-side admission-scheduler analogue (a
    #: :mod:`repro_torch.core.asl_schedule` key) and fleet-dispatch
    #: analogue (the reference's ``repro.serving.dispatch`` policy name);
    #: None when the policy has no host counterpart.
    host_scheduler: str = None
    host_dispatch: str = None

    def init_params(self, cfg) -> dict:
        """Policy-owned knobs -> ``SimParams.pol`` (numpy scalars, read
        from ``policy_opts(cfg)``)."""
        return {}

    def init_state(self, cfg, b: int, device) -> dict:
        """Policy-owned per-run state -> ``SimState.pol`` (``b`` cells)."""
        return {}

    def on_acquire(self, st, cfg, tb, pm, c, t, cond) -> None:
        raise NotImplementedError

    def on_standby_expiry(self, st, cfg, tb, pm, c, t, cond) -> None:
        return None

    def on_release(self, st, cfg, tb, pm, c, t, ep_latency, last,
                   cond) -> None:
        return None

    def pick_next(self, st, cfg, tb, pm, l, t, cond) -> None:
        raise NotImplementedError
