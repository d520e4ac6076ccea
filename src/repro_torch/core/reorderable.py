"""Reorderable lock — Algorithm 1 of the paper, verbatim semantics.

Exposes bounded reordering atop a replaceable FIFO lock:

* ``lock_immediately``  — enqueue now (``lock_fifo`` of the underlying lock).
* ``lock_reorder(window)`` — become a *standby* competitor: if the lock is
  observed free, enqueue at once; otherwise poll ``is_lock_free`` with binary
  exponential backoff until the reorder window expires, then enqueue.  Other
  competitors may enqueue (reorder) past a standby during its window — the
  window bounds the reordering.

An upper bound on the window (``MAX_WINDOW_NS``) keeps the lock
starvation-free.  The window is a hint, not a strict order constraint
(paper §3.2): a standby whose window expired still races FIFO-fairly from
``lock_fifo`` onward.

The blocking variant (paper footnote 3 / Bench-6) sleeps during the window
instead of spinning; select with ``blocking=True``.

The port's own copy of the JAX package's ``repro/core/reorderable.py`` (it imports
nothing of that package); its behaviour is the reference's.
"""

from __future__ import annotations

import time

from repro_torch.core.locks import FIFOLock

MAX_WINDOW_NS = 100_000_000  # 100 ms (paper §4 maximum reorder window)


class ReorderableLock:
    """Algorithm 1. ``fifo`` must provide lock_fifo/unlock_fifo/is_lock_free."""

    def __init__(self, fifo=None, *, blocking: bool = False):
        self.fifo = fifo if fifo is not None else FIFOLock()
        self._blocking = blocking

    # -- Algorithm 1, line 1-3 -------------------------------------------
    def lock_immediately(self) -> None:
        self.fifo.lock_fifo()

    # -- Algorithm 1, line 5-17 ------------------------------------------
    def lock_reorder(self, window_ns: float) -> None:
        window_ns = min(window_ns, MAX_WINDOW_NS)
        if window_ns <= 0:
            # Window fully collapsed by AIMD: the standby phase is empty,
            # enqueue FIFO at once — no clock reads, no free-lock poll.
            self.fifo.lock_fifo()
            return
        if self.fifo.is_lock_free():  # line 7 fast path
            self.fifo.lock_fifo()
            return
        window_end = time.monotonic_ns() + window_ns
        cnt, next_check = 0, 1
        while time.monotonic_ns() < window_end:
            cnt += 1
            if cnt == next_check:  # line 10-13: exponential backoff checks
                if self.fifo.is_lock_free():
                    break
                next_check <<= 1
            if self._blocking:
                # Bench-6 variant: yield the core while standing by.
                time.sleep(min(1e-6 * next_check, 1e-3))
        self.fifo.lock_fifo()  # line 16

    # -- Algorithm 1, line 19-21 -------------------------------------------
    def unlock(self) -> None:
        self.fifo.unlock_fifo()

    def is_lock_free(self) -> bool:
        return self.fifo.is_lock_free()
