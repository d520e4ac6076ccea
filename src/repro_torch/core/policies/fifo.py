"""Strict FIFO handoff — the MCS-equivalent baseline (Implication 1)."""

from __future__ import annotations

from repro_torch.core.policies import register
from repro_torch.core.policies.base import (LockPolicy, QUEUED, deq, enq,
                                            grant, lock_of, park, qlen, rows)


@register
class FifoPolicy(LockPolicy):
    name = "fifo"
    host_scheduler = "fifo"
    state_slots = ("q", "q_head", "q_tail")

    def on_acquire(self, st, cfg, tb, pm, c, t, cond):
        l = lock_of(st, tb, c)
        can_grab = (st.holder[rows(l), l] == -1) & (qlen(st, l, 0) == 0)
        wait = ~can_grab & cond
        grant(st, tb, can_grab & cond, c, t)
        enq(st, wait, l, 0, c)
        park(st, wait, c, QUEUED)

    def pick_next(self, st, cfg, tb, pm, l, t, cond):
        nonempty = (qlen(st, l, 0) > 0) & cond
        cq = deq(st, nonempty, l, 0)
        grant(st, tb, nonempty, cq, t)
