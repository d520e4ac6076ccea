"""ShflLock-style queue shuffling: big waiters are shuffled ahead of the
FIFO head, at most ``shfl_bound`` grants in a row, then the head goes
through (starvation-free).  Queue-less like edf: FIFO order is the
waiters' attempt time (lowest core on ties).  ``shfl_bound`` rides in
``SimParams.pol`` (a ``policy_kw`` knob and a sweep axis), the per-lock
bypass counter in ``SimState.pol["shfl_ctr"]``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policies import register
from repro_torch.core.policies.base import (INF, LockPolicy, grant,
                                            policy_opts,
                                            queueless_acquire, rows,
                                            waiting_mask)

DEFAULT_BOUND = 4


@register
class ShflPolicy(LockPolicy):
    name = "shfl"
    table_slots = ("big",)
    state_slots = ("shfl_ctr",)
    param_slots = ("pol.shfl_bound",)
    sweep_axes = {"shfl_bound": "shfl_bound"}

    def init_params(self, cfg):
        return {"shfl_bound": np.int32(
            policy_opts(cfg).get("shfl_bound", DEFAULT_BOUND))}

    def init_state(self, cfg, b, device):
        return {"shfl_ctr": torch.zeros((b, cfg.n_locks), dtype=torch.int32,
                                        device=device)}

    def on_acquire(self, st, cfg, tb, pm, c, t, cond):
        queueless_acquire(st, cfg, tb, pm, c, t, cond)

    def pick_next(self, st, cfg, tb, pm, l, t, cond):
        waiting = waiting_mask(st, cfg, tb, l)
        head = torch.argmin(torch.where(waiting, st.attempt_t, INF), dim=1)
        big_wait = waiting & (tb.big == 1)
        big_head = torch.argmin(torch.where(big_wait, st.attempt_t, INF),
                                dim=1)
        ctrs = st.pol["shfl_ctr"]
        r = rows(l)
        ctr = ctrs[r, l]
        shuffle = big_wait.any(dim=1) & (ctr < pm.pol["shfl_bound"])
        pick = torch.where(shuffle, big_head, head)
        # Consecutive head bypasses; granting the head resets the count.
        bypassed = shuffle & (pick != head)
        has = waiting.any(dim=1) & cond
        ctrs[r, l] = torch.where(has, torch.where(bypassed, ctr + 1, 0), ctr)
        grant(st, cfg, tb, pm, has, pick, t, wakeup=True)
