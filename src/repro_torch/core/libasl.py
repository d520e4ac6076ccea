"""LibASL — Algorithms 2 & 3: epoch annotation API + the asymmetry-aware mutex.

Usage (paper Figure 6)::

    asl = LibASL(is_big_core=lambda: my_role_is_big())
    m = asl.mutex()
    while serving:
        asl.epoch_start(5)
        with m:
            ...critical section...
        asl.epoch_end(5, slo_ns=1000)

* ``epoch_start/epoch_end`` keep **per-thread, per-epoch-id** AIMD window
  state (24 bytes in the paper; a small dataclass here) and support nesting
  via a per-thread stack; the innermost epoch's window governs
  (paper §3.4: nested epochs prioritize the inner one).
* ``mutex()`` returns a drop-in lock: big-core callers take
  ``lock_immediately``; little-core callers take ``lock_reorder`` with the
  current epoch's window (``MAX_WINDOW_NS`` outside any epoch, so
  non-latency-critical apps transparently get maximal-throughput ordering
  without starvation).

The paper redirects ``pthread_mutex_lock`` by weak-symbol interposition;
the Python analogue is this object being a context manager compatible with
``threading.Lock`` call sites.

The port's own copy of the JAX package's ``repro/core/libasl.py`` (it imports
nothing of that package); its behaviour is the reference's.
"""

from __future__ import annotations

import threading
import time

from repro_torch.core.aimd import AIMDWindow, unit_for
from repro_torch.core.reorderable import MAX_WINDOW_NS, ReorderableLock

DEFAULT_WINDOW_NS = 1_000.0


class _EpochTLS(threading.local):
    def __init__(self):
        self.epochs: dict[int, AIMDWindow] = {}
        # Per-epoch-id stack of start timestamps: reentrant same-id
        # nesting pops LIFO, so an inner end measures the inner start.
        self.starts: dict[int, list[int]] = {}
        self.cur_epoch_id: int = -1
        self.stack: list[int] = []


class LibASL:
    """Process-wide LibASL runtime: epoch registry + mutex factory."""

    def __init__(self, is_big_core, *, pct: float = 99.0,
                 clock_ns=time.monotonic_ns, fifo_factory=None,
                 blocking: bool = False):
        self.is_big_core = is_big_core
        self.pct = pct
        self._clock = clock_ns
        self._fifo_factory = fifo_factory
        self._blocking = blocking
        self._tls = _EpochTLS()

    # -- Algorithm 2 -------------------------------------------------------
    def epoch_start(self, epoch_id: int) -> None:
        tls = self._tls
        if tls.cur_epoch_id >= 0:
            tls.stack.append(tls.cur_epoch_id)  # nested epoch support
        tls.cur_epoch_id = epoch_id
        if epoch_id not in tls.epochs:
            tls.epochs[epoch_id] = AIMDWindow(
                window=DEFAULT_WINDOW_NS,
                unit=unit_for(DEFAULT_WINDOW_NS, self.pct), pct=self.pct,
                max_window=MAX_WINDOW_NS)
        tls.starts.setdefault(epoch_id, []).append(self._clock())

    def epoch_end(self, epoch_id: int, slo_ns: float) -> float:
        """Returns the measured epoch latency (ns).

        Raises ``RuntimeError`` for an ``epoch_end`` with no matching
        ``epoch_start`` — silently measuring a ~0 latency here would feed
        a bogus never-violated sample into AIMD and inflate the caller's
        reorder window.  Ending an *outer* epoch while an inner one is
        still open removes it from the nesting stack without disturbing
        the innermost (governing) epoch.
        """
        tls = self._tls
        opens = tls.starts.get(epoch_id)
        if not opens:
            raise RuntimeError(
                f"epoch_end({epoch_id}) without a matching epoch_start")
        latency = self._clock() - opens.pop()
        if not opens:
            del tls.starts[epoch_id]
        if not self.is_big_core():  # paper line 21: big cores skip adjustment
            tls.epochs[epoch_id].update(latency, slo_ns)
        if tls.cur_epoch_id == epoch_id:
            tls.cur_epoch_id = tls.stack.pop() if tls.stack else -1
        elif epoch_id in tls.stack:  # mismatched nesting: drop the outer
            # (innermost occurrence, so reentrant same-id nesting unwinds
            # in order); the governing inner epoch stays current.
            del tls.stack[len(tls.stack) - 1
                          - tls.stack[::-1].index(epoch_id)]
        return latency

    def current_window_ns(self) -> float:
        tls = self._tls
        if tls.cur_epoch_id < 0:
            return MAX_WINDOW_NS  # line 5 of Algorithm 3: default max window
        return tls.epochs[tls.cur_epoch_id].window

    # -- Algorithm 3 -------------------------------------------------------
    def mutex(self) -> "ASLMutex":
        fifo = self._fifo_factory() if self._fifo_factory else None
        return ASLMutex(self, ReorderableLock(fifo, blocking=self._blocking))


class ASLMutex:
    """Drop-in mutex: dispatches per core type (paper Algorithm 3)."""

    def __init__(self, runtime: LibASL, reorderable: ReorderableLock):
        self._rt = runtime
        self._lock = reorderable

    def lock(self) -> None:
        if self._rt.is_big_core():
            self._lock.lock_immediately()
        else:
            self._lock.lock_reorder(self._rt.current_window_ns())

    def unlock(self) -> None:
        self._lock.unlock()

    acquire = lock
    release = unlock

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()
