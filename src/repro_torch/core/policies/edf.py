"""EDF — earliest-deadline-first grant (latency-first baseline).

Every waiter's deadline is its epoch's SLO expiry (``epoch_start +
slo * slo_scale[core]``); the releaser grants the most urgent waiter,
exact deadline ties by attempt time, then by core.  Queue-less: waiters
park in QUEUED and the releaser scans the waiting mask.  The deadline
is i32 ticks, the per-core SLO clamped to ``max_window_us`` first, as
the JAX package computes it.
"""

from __future__ import annotations

import torch

from repro_torch.core.policies import register
from repro_torch.core.policies.base import (INF, LockPolicy, grant,
                                            queueless_acquire,
                                            ticks, waiting_mask)


@register
class EdfPolicy(LockPolicy):
    name = "edf"
    param_slots = ("slo",)
    table_slots = ("col.slo_scale",)

    def on_acquire(self, st, cfg, tb, pm, c, t, cond):
        queueless_acquire(st, cfg, tb, pm, c, t, cond)

    def pick_next(self, st, cfg, tb, pm, l, t, cond):
        waiting = waiting_mask(st, cfg, tb, l)
        slo_t = torch.clamp_max(pm.slo[:, None] * tb.col["slo_scale"],
                                float(ticks(cfg.max_window_us))
                                ).to(torch.int32)
        dl = torch.where(waiting, st.epoch_start + slo_t, INF)
        tie = waiting & (dl == dl.amin(dim=1, keepdim=True))
        pick = torch.argmin(torch.where(tie, st.attempt_t, INF), dim=1)
        has = waiting.any(dim=1) & cond
        grant(st, cfg, tb, pm, has, pick, t, wakeup=True)
