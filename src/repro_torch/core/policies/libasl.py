"""LibASL — the paper's policy: big cores enqueue immediately; little
cores stand by for an AIMD-controlled reorder window (Algorithms 1-3)."""

from __future__ import annotations

import torch

from repro_torch.core.aimd import aimd_update
from repro_torch.core.policies import register
from repro_torch.core.policies.base import (LockPolicy, QUEUED, STANDBY,
                                            advance_key, deq, enq, grant,
                                            lock_of, lock_vec,
                                            park, put, qlen, rows, ticks,
                                            weighted_pick)


@register
class LibASLPolicy(LockPolicy):
    name = "libasl"
    host_scheduler = "asl"
    host_dispatch = "asl"
    uses_standby = True
    param_slots = ("slo", "unit0")
    table_slots = ("big", "col.slo_scale")
    state_slots = ("window", "unit", "q", "q_head", "q_tail")

    def on_acquire(self, st, cfg, tb, pm, c, t, cond):
        r = rows(c)
        l = lock_of(st, cfg, tb, c)
        is_big = tb.big[r, c] == 1
        can_grab = (st.holder[r, l] == -1) & (qlen(st, l, 0) == 0)
        wait = ~can_grab & cond
        enq_c = wait & is_big          # big: lock immediately (FIFO)
        standby = wait & ~is_big       # little: stand by for the window
        grant(st, cfg, tb, pm, can_grab & cond, c, t)
        enq(st, enq_c, l, 0, c)
        win = torch.clamp_max(st.window[r, c],
                              float(ticks(cfg.max_window_us))
                              ).to(torch.int32)
        park(st, enq_c, c, QUEUED)
        put(st.phase, (c,), STANDBY, standby)
        put(st.t_ready, (c,), t + torch.clamp_min(win, 0), standby)

    def on_standby_expiry(self, st, cfg, tb, pm, c, t, cond):
        """Reorder window expired -> enqueue FIFO (Alg.1 line 16)."""
        l = lock_of(st, cfg, tb, c)
        free = (st.holder[rows(l), l] == -1) & (qlen(st, l, 0) == 0)
        wait = ~free & cond
        grant(st, cfg, tb, pm, free & cond, c, t)
        enq(st, wait, l, 0, c)
        park(st, wait, c, QUEUED)

    def on_release(self, st, cfg, tb, pm, c, t, ep_latency, last, cond):
        """Algorithm 2: AIMD the reorder window (little cores only),
        against the per-core class SLO."""
        r = rows(c)
        adjust = last & (tb.big[r, c] == 0) & cond
        w, u = aimd_update(st.window[r, c], st.unit[r, c], ep_latency,
                           pm.slo * tb.col["slo_scale"][r, c], pct=cfg.pct,
                           max_window=ticks(cfg.max_window_us))
        put(st.window, (c,), w, adjust)
        put(st.unit, (c,), u, adjust)

    def pick_next(self, st, cfg, tb, pm, l, t, cond):
        # FIFO queue first.
        nonempty = (qlen(st, l, 0) > 0) & cond
        cq = deq(st, nonempty, l, 0)
        grant(st, cfg, tb, pm, nonempty, cq, t, wakeup=True)
        # Queue empty -> a standby competitor may grab the free lock.  The
        # key advances on every release, even when the queue served.
        standby = (st.phase == STANDBY) & (lock_vec(st, cfg, tb) == l[:, None])
        sub = advance_key(st, cond)
        pick, any_standby = weighted_pick(sub, standby.to(torch.float32))
        grant(st, cfg, tb, pm, ~nonempty & any_standby & cond, pick, t)
