"""Test-and-set with an asymmetric success rate (paper Figure 3b/3c).

The winner among spinners at release is drawn with weight ``w_big`` for
big cores (w_big > 1 = big-core-affinity, < 1 = little-core-affinity).
"""

from __future__ import annotations

import torch

from repro_torch.core.policies import register
from repro_torch.core.policies.base import (SPIN, LockPolicy, advance_key,
                                            grant, lock_of, lock_vec, park,
                                            rows, weighted_pick)


@register
class TasPolicy(LockPolicy):
    name = "tas"
    host_scheduler = "greedy"
    host_dispatch = "fast-only"
    param_slots = ("w_big",)
    table_slots = ("big",)
    sweep_axes = {"w_big": "w_big"}

    def on_acquire(self, st, cfg, tb, pm, c, t, cond):
        l = lock_of(st, cfg, tb, c)
        free = st.holder[rows(l), l] == -1
        grant(st, cfg, tb, pm, free & cond, c, t)
        park(st, ~free & cond, c, SPIN)

    def pick_next(self, st, cfg, tb, pm, l, t, cond):
        spinning = (st.phase == SPIN) & (lock_vec(st, cfg, tb) == l[:, None])
        # The key advances on every release, whether or not anyone spins.
        sub = advance_key(st, cond)
        w = torch.where(tb.big == 1, pm.w_big[:, None],
                        torch.ones_like(pm.w_big)[:, None])
        winner, any_spin = weighted_pick(
            sub, torch.where(spinning, w, torch.zeros_like(w)))
        grant(st, cfg, tb, pm, any_spin & cond, winner, t)
