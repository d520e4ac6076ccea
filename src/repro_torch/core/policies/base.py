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
same hooks per cell, switching on the policy id; this module is the plain
version it is held against.
"""

from __future__ import annotations

import functools

import torch

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
    if not (isinstance(val, torch.Tensor) and val.dtype == x.dtype):
        val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
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


def lock_of(st, tb, c) -> torch.Tensor:
    """The lock core ``c`` currently contends: its segment's lock."""
    r = rows(st.seg)
    return tb.seg_lock[r, st.seg[r, c].long()].long()


def lock_vec(st, tb) -> torch.Tensor:
    """Per-core lock ids ``[B, N]`` — the vectorized :func:`lock_of`."""
    return torch.gather(tb.seg_lock, 1, st.seg.long())


def grant(st, tb, cond, c, t) -> None:
    """Make core ``c`` (where ``cond``) the holder of its lock and
    schedule its release after its segment's critical section."""
    r = rows(st.seg)
    c_safe = torch.clamp_min(c, 0)
    s = st.seg[r, c_safe].long()
    l = tb.seg_lock[r, s].long()
    dur = tb.cs_dur[r, c_safe, s]
    put(st.holder, (l,), c_safe, cond)
    put(st.phase, (c_safe,), HOLDER, cond)
    put(st.t_ready, (c_safe,), t + dur, cond)


def park(st, cond, c, new_phase) -> None:
    """Send core ``c`` (where ``cond``) into a passive phase (QUEUED/SPIN):
    it carries ``t_ready = INF`` until a releaser wakes it."""
    put(st.phase, (c,), new_phase, cond)
    put(st.t_ready, (c,), INF, cond)


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
    #: SimParams fields this policy reads.
    param_slots: tuple = ()
    #: SimTables slots this policy reads.
    table_slots: tuple = ()
    #: SimState fields this policy owns.
    state_slots: tuple = ()
    #: sweep-axis name -> SimParams field (policy knobs as batch axes).
    sweep_axes: dict = {}
    #: host-side admission-scheduler analogue (a
    #: :mod:`repro_torch.core.asl_schedule` key); None when the policy
    #: has no host counterpart.
    host_scheduler: str = None

    def on_acquire(self, st, cfg, tb, pm, c, t, cond) -> None:
        raise NotImplementedError

    def on_standby_expiry(self, st, cfg, tb, pm, c, t, cond) -> None:
        return None

    def on_release(self, st, cfg, tb, pm, c, t, ep_latency, last,
                   cond) -> None:
        return None

    def pick_next(self, st, cfg, tb, pm, l, t, cond) -> None:
        raise NotImplementedError
