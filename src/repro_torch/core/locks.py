"""Baseline lock implementations the paper compares against.

These are *real* locks used by the host-side runtime (serving engine,
checkpoint manager) and exercised by the correctness/property tests.  On this
1-core container their wall-clock scaling is meaningless — the performance
reproduction lives in :mod:`repro.core.simlock` (discrete-event AMP
simulator); here the contract is correctness: mutual exclusion, FIFO order
where promised, and the paper's structural behaviors (proportional batching,
TAS unfairness hook).

Primitives: CPython's ``threading.Lock.acquire(blocking=False)`` *is* a
test-and-set, which we use as the atomic; FIFO handoff uses per-waiter
``threading.Event`` (the queue-lock analogue of MCS — each waiter spins/waits
on its own node, the releaser wakes exactly its successor).

The port's own copy of the JAX package's ``repro/core/locks.py`` (it imports
nothing of that package); its behaviour is the reference's.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class FIFOLock:
    """Queue lock with strict FIFO handoff (the MCS-equivalent).

    Each acquirer appends a node carrying a private Event; the releaser hands
    the lock to the head node only (local waiting, single wakeup — the MCS
    property that matters above the hardware level).
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()  # emulates the atomic tail swap
        self._q: deque[threading.Event] = deque()
        self._held = False

    # -- paper interface -------------------------------------------------
    def lock_fifo(self) -> None:
        with self._mu:
            if not self._held and not self._q:
                self._held = True
                return
            ev = threading.Event()
            self._q.append(ev)
        ev.wait()  # FIFO handoff: predecessor sets exactly this event

    def unlock_fifo(self) -> None:
        with self._mu:
            if self._q:
                ev = self._q.popleft()
                ev.set()  # holder transfers ownership; _held stays True
            else:
                self._held = False

    def is_lock_free(self) -> bool:
        # Racy read by design (paper line 7/11: an opportunistic check).
        return not self._held

    # -- stdlib-ish aliases ----------------------------------------------
    lock = lock_fifo
    unlock = unlock_fifo
    acquire = lock_fifo
    release = unlock_fifo

    def __enter__(self):
        self.lock_fifo()
        return self

    def __exit__(self, *exc):
        self.unlock_fifo()


class TASLock:
    """Test-and-set spinlock with optional exponential backoff.

    The winner among concurrent spinners is whoever's TAS lands first —
    unfair by construction (the paper's latency-collapse baseline).
    """

    def __init__(self, backoff: bool = True, max_backoff_s: float = 1e-3):
        self._flag = threading.Lock()
        self._backoff = backoff
        self._max_backoff_s = max_backoff_s

    def lock(self) -> None:
        delay = 1e-6
        while not self._flag.acquire(blocking=False):  # the TAS
            if self._backoff:
                time.sleep(delay)
                delay = min(delay * 2, self._max_backoff_s)
            else:
                time.sleep(0)  # yield; pure spin would livelock under GIL

    def unlock(self) -> None:
        self._flag.release()

    def is_lock_free(self) -> bool:
        return not self._flag.locked()

    acquire = lock
    release = unlock

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()


class TicketLock:
    """FIFO via fetch-and-increment tickets (paper's `ticket` baseline)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._next = 0
        self._serving = 0
        self._cv = threading.Condition(self._mu)

    def lock(self) -> None:
        with self._cv:
            my = self._next
            self._next += 1
            while self._serving != my:
                self._cv.wait()

    def unlock(self) -> None:
        with self._cv:
            self._serving += 1
            self._cv.notify_all()

    def is_lock_free(self) -> bool:
        return self._serving == self._next

    acquire = lock
    release = unlock

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()


class ProportionalLock:
    """The static proportional policy (SHFL-PB10 analogue, paper §4).

    Two FIFO queues (big/little); after every ``proportion`` big-core grants
    one little-core grant is allowed — the static trade-off the paper shows
    cannot meet a latency target (Figure 5).  ``is_big`` classifies the
    calling thread (injected; on real AMP it is a core-id table lookup).
    """

    def __init__(self, is_big, proportion: int = 10):
        self._mu = threading.Lock()
        self._big: deque[threading.Event] = deque()
        self._little: deque[threading.Event] = deque()
        self._held = False
        self._ctr = 0
        self._is_big = is_big
        self._n = proportion

    def lock(self) -> None:
        with self._mu:
            if not self._held and not self._big and not self._little:
                self._held = True
                return
            ev = threading.Event()
            (self._big if self._is_big() else self._little).append(ev)
        ev.wait()

    def unlock(self) -> None:
        with self._mu:
            nxt = None
            if self._big and (self._ctr < self._n or not self._little):
                nxt = self._big.popleft()
                self._ctr += 1
            elif self._little:
                nxt = self._little.popleft()
                self._ctr = 0
            if nxt is not None:
                nxt.set()
            else:
                self._held = False

    def is_lock_free(self) -> bool:
        return not self._held

    acquire = lock
    release = unlock

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()
