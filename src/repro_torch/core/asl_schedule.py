"""ASL scheduler — the paper's lock ordering as an admission policy.

A copy of the JAX package's numpy-only ``repro/core/asl_schedule.py`` over
the port's AIMD window and lock-policy registry.

A continuous-batching inference engine (and a gradient-commit loop) has the
same structure as the paper's critical section: a serialized *engine slot*
that heterogeneous work items compete for.  Mapping (DESIGN.md §3):

* **big core**  -> work the asymmetric system serves cheaply per unit of
  SLO-credit (decode micro-steps; non-straggler pods),
* **little core** -> long, latency-elastic work (prefill chunks; stragglers),
* **lock order** -> which item the next engine slot admits.

Policies (mirroring the paper's baselines):

* ``FIFOScheduler``   — strict arrival order (MCS analogue): prefill
  head-of-line blocks decode => token-throughput collapse.
* ``GreedyScheduler`` — always prefer the "big" class (TAS big-affinity
  analogue): little-class latency collapse / starvation.
* ``ASLScheduler``    — the paper: big class admitted immediately; little
  items are *standby* for a per-class AIMD reorder window (Algorithm 2
  constants, shared via :mod:`repro_torch.core.aimd`).  An item whose window
  expired enters the FIFO queue and cannot be bypassed further (bounded
  reordering => starvation-free).  Work-conserving: when no big work is
  pending, standby items are admitted at once (the paper's
  ``is_lock_free`` fast path).

The scheduler is clock-agnostic (inject ``clock()``) so benchmarks drive it
with a simulated clock and the live serving engine drives it with
``time.monotonic``.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import typing
from collections import deque

from repro_torch.core.aimd import AIMDWindow, unit_for
from repro_torch.core.policies import REGISTRY


@dataclasses.dataclass
class WorkItem:
    """One admission request competing for the engine slot."""

    payload: typing.Any
    klass: str                 # "big" | "little" (or any registered class)
    epoch_id: int = 0          # SLO class (paper epoch id)
    arrival_t: float = 0.0
    deadline_t: float = 0.0    # arrival + reorder window (standby expiry)
    seq: int = 0               # arrival order tiebreak


class SchedulerBase:
    name = "base"

    def __init__(self, clock=None):
        self._clock = clock if clock is not None else _default_clock
        self._seq = itertools.count()

    def submit(self, payload, klass: str, epoch_id: int = 0) -> WorkItem:
        raise NotImplementedError

    def next_item(self) -> typing.Optional[WorkItem]:
        """Admit the next item to the engine slot (None if nothing pending)."""
        raise NotImplementedError

    def observe_epoch(self, epoch_id: int, latency: float, slo: float):
        """Feedback at request completion (epoch_end). Default: no-op."""

    def pending(self) -> int:
        raise NotImplementedError


def _default_clock() -> float:
    import time

    return time.monotonic()


class FIFOScheduler(SchedulerBase):
    """Strict arrival order — the MCS analogue."""

    name = "fifo"

    def __init__(self, clock=None):
        super().__init__(clock)
        self._q: deque[WorkItem] = deque()

    def submit(self, payload, klass, epoch_id=0):
        it = WorkItem(payload, klass, epoch_id, self._clock(), 0.0,
                      next(self._seq))
        self._q.append(it)
        return it

    def next_item(self):
        return self._q.popleft() if self._q else None

    def pending(self):
        return len(self._q)


class GreedyScheduler(SchedulerBase):
    """Always serve the big class first — the TAS big-affinity analogue."""

    name = "greedy"

    def __init__(self, clock=None, big_class: str = "big"):
        super().__init__(clock)
        self._big: deque[WorkItem] = deque()
        self._rest: deque[WorkItem] = deque()
        self._big_class = big_class

    def submit(self, payload, klass, epoch_id=0):
        it = WorkItem(payload, klass, epoch_id, self._clock(), 0.0,
                      next(self._seq))
        (self._big if klass == self._big_class else self._rest).append(it)
        return it

    def next_item(self):
        if self._big:
            return self._big.popleft()
        return self._rest.popleft() if self._rest else None

    def pending(self):
        return len(self._big) + len(self._rest)


class ASLScheduler(SchedulerBase):
    """The paper's SLO-guided bounded reordering as an admission policy.

    ``submit(klass="big")``      == lock_immediately  (FIFO queue)
    ``submit(klass="little")``   == lock_reorder(window[epoch_id])
    ``observe_epoch``            == epoch_end -> AIMD update (Algorithm 2)

    Beyond-paper extensions (each individually switchable, all OFF by
    default so the default object is paper-faithful):

    * ``warm_start``  — initialize a class window from the first observed
      latency headroom instead of the paper's fixed default (cuts the
      convergence transient).
    * ``mi_factor``   — multiplicative *increase* when latency is far below
      the SLO (paper growth is purely linear; this converges faster after
      load drops while keeping AIMD's violation response).
    """

    name = "asl"

    def __init__(self, clock=None, *, pct: float = 99.0,
                 default_window: float = 0.05, max_window: float = 10.0,
                 big_class: str = "big", warm_start: bool = False,
                 mi_factor: float = 0.0, mi_threshold: float = 0.5):
        super().__init__(clock)
        self._fifo: deque[WorkItem] = deque()      # enqueued (unbypassable)
        # Min-heap of (deadline_t, seq, item): promotion pops expired items
        # in expiry order and the work-conserving pop takes the earliest
        # deadline, both O(log n) (the old list was rescanned/re-sorted on
        # every call).
        self._standby: list[tuple] = []
        self._windows: dict[int, AIMDWindow] = {}
        self._pct = pct
        self._default_window = default_window
        self._max_window = max_window
        self._big_class = big_class
        self._warm_start = warm_start
        self._seen: set[int] = set()
        self._mi_factor = mi_factor
        self._mi_threshold = mi_threshold

    # ------------------------------------------------------------------
    def _win(self, epoch_id: int) -> AIMDWindow:
        if epoch_id not in self._windows:
            self._windows[epoch_id] = AIMDWindow(
                window=self._default_window,
                unit=unit_for(self._default_window, self._pct),
                pct=self._pct, max_window=self._max_window)
        return self._windows[epoch_id]

    def window(self, epoch_id: int) -> float:
        return self._win(epoch_id).window

    def submit(self, payload, klass, epoch_id=0):
        now = self._clock()
        # A standby whose window already expired enqueued at its expiry
        # time — it must precede big work submitted after that (the lock's
        # FIFO order once enqueued is inviolable).
        self._promote_expired(now)
        it = WorkItem(payload, klass, epoch_id, now, 0.0, next(self._seq))
        if klass == self._big_class:
            self._fifo.append(it)           # lock_immediately
        else:
            it.deadline_t = now + self._win(epoch_id).window
            heapq.heappush(self._standby,   # lock_reorder(window)
                           (it.deadline_t, it.seq, it))
        return it

    def _promote_expired(self, now: float):
        """Standby items whose reorder window expired enqueue FIFO (Alg.1).
        Heap order == (deadline_t, seq), so items enqueue in expiry order
        (paper: not arrival order — each standby has its own window)."""
        while self._standby and self._standby[0][0] <= now:
            self._fifo.append(heapq.heappop(self._standby)[2])

    def next_item(self):
        now = self._clock()
        self._promote_expired(now)
        if self._fifo:
            return self._fifo.popleft()
        if self._standby:
            # Queue empty -> the slot is free: work-conserving admission
            # (paper: standby enqueues when the waiting queue is empty);
            # earliest deadline first == the old full-sort's head.
            return heapq.heappop(self._standby)[2]
        return None

    def observe_epoch(self, epoch_id, latency, slo):
        w = self._win(epoch_id)
        if self._warm_start and epoch_id not in self._seen:
            self._seen.add(epoch_id)
            if latency < slo:
                # Beyond-paper: jump to the measured headroom.
                w.window = min(max(slo - latency, w.window), w.max_window)
                w.unit = unit_for(w.window, self._pct)
                return
        self._seen.add(epoch_id)
        before = w.window
        w.update(latency, slo)
        if (self._mi_factor > 0.0 and latency <= self._mi_threshold * slo
                and w.window <= before + w.unit + 1e-12):
            # Beyond-paper: multiplicative increase while far under SLO.
            w.window = min(w.window * (1.0 + self._mi_factor), w.max_window)

    def pending(self):
        return len(self._fifo) + len(self._standby)


# Admission-scheduler names are keyed off the lock-policy registry: each
# LockPolicy with a host analogue declares it as ``host_scheduler``
# (fifo -> fifo, tas big-affinity -> greedy, libasl -> asl), so the
# serving engine, benchmarks and the lock simulator agree on one naming
# scheme.  A new lock policy with a host analogue registers its
# scheduler class here.
_IMPL = {
    "fifo": FIFOScheduler,
    "greedy": GreedyScheduler,
    "asl": ASLScheduler,
}
SCHEDULERS = {p.host_scheduler: _IMPL[p.host_scheduler]
              for p in REGISTRY.values() if p.host_scheduler}
