"""Static proportional policy (ShflLock-PB analogue, paper Figure 5):
1 little-core grant after every ``prop_n`` big-core grants."""

from __future__ import annotations

import torch

from repro_torch.core.policies import register
from repro_torch.core.policies.base import (LockPolicy, QUEUED, deq, enq,
                                            grant, lock_of,
                                            park, qlen, rows)


@register
class PropPolicy(LockPolicy):
    name = "prop"
    param_slots = ("prop_n",)
    table_slots = ("big",)
    state_slots = ("prop_ctr", "q", "q_head", "q_tail")
    sweep_axes = {"prop_n": "prop_n"}

    def on_acquire(self, st, cfg, tb, pm, c, t, cond):
        r = rows(c)
        l = lock_of(st, cfg, tb, c)
        can_grab = ((st.holder[r, l] == -1) & (qlen(st, l, 0) == 0)
                    & (qlen(st, l, 1) == 0))
        wait = ~can_grab & cond
        grant(st, cfg, tb, pm, can_grab & cond, c, t)
        b = torch.where(tb.big[r, c] == 1, 0, 1).long()
        enq(st, wait, l, b, c)
        park(st, wait, c, QUEUED)

    def pick_next(self, st, cfg, tb, pm, l, t, cond):
        r = rows(l)
        nb, nl = qlen(st, l, 0), qlen(st, l, 1)
        ctr = st.prop_ctr[r, l]
        take_big = (nb > 0) & ((ctr < pm.prop_n) | (nl == 0)) & cond
        take_little = ~take_big & (nl > 0) & cond
        cb = deq(st, take_big, l, 0)
        cl = deq(st, take_little, l, 1)
        st.prop_ctr[r, l] = torch.where(
            take_big, ctr + 1, torch.where(take_little, 0, ctr))
        grant(st, cfg, tb, pm, take_big | take_little,
              torch.where(take_big, cb, cl), t,
              wakeup=True)
