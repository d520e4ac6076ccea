"""dvfs_race — asymmetry- and DVFS-aware race-to-idle granting.

Under contention the lock goes to the waiter that retires critical
sections fastest: the grant score is ``race_w * dvfs * (1 + big)``
(highest wins, attempt time then core breaks ties).  ``race_w`` is this
policy's own per-core column, ``dvfs`` the energy layer's.  After
``race_bound`` grants in a row that bypassed the FIFO head (the
earliest attempt), the head is forced through.  ``race_bound`` rides in
``SimParams.pol``, the per-lock counter in ``SimState.pol["race_ctr"]``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import energy as _energy  # noqa: F401  (dvfs column)
from repro_torch.core.columns import ColumnSpec, register_column
from repro_torch.core.policies import register
from repro_torch.core.policies.base import (INF, LockPolicy, grant,
                                            policy_opts,
                                            queueless_acquire, rows,
                                            waiting_mask)

register_column(ColumnSpec(
    name="race_w", dtype="f32", default=1.0, owner="dvfs_race",
    doc="per-core race-to-idle priority weight (0 bans a core from "
        "being shuffled forward; it still gets the forced-head grant)"))

DEFAULT_BOUND = 8


def race_score(tb) -> torch.Tensor:
    """``[B, N]`` f32: each core's grant score, in the JAX package's
    order of operations."""
    return (tb.col["race_w"] * tb.col["dvfs"]) * (1.0 + tb.big.float())


@register
class DvfsRacePolicy(LockPolicy):
    name = "dvfs_race"
    table_slots = ("big", "col.dvfs", "col.race_w")
    state_slots = ("race_ctr",)
    param_slots = ("pol.race_bound",)
    sweep_axes = {"race_bound": "race_bound"}

    def init_params(self, cfg):
        return {"race_bound": np.int32(
            policy_opts(cfg).get("race_bound", DEFAULT_BOUND))}

    def init_state(self, cfg, b, device):
        return {"race_ctr": torch.zeros((b, cfg.n_locks), dtype=torch.int32,
                                        device=device)}

    def on_acquire(self, st, cfg, tb, pm, c, t, cond):
        queueless_acquire(st, cfg, tb, pm, c, t, cond)

    def pick_next(self, st, cfg, tb, pm, l, t, cond):
        waiting = waiting_mask(st, cfg, tb, l)
        score = torch.where(waiting, race_score(tb), -1.0)
        tie = waiting & (score == score.amax(dim=1, keepdim=True))
        fast = torch.argmin(torch.where(tie, st.attempt_t, INF), dim=1)
        head = torch.argmin(torch.where(waiting, st.attempt_t, INF), dim=1)
        ctrs = st.pol["race_ctr"]
        r = rows(l)
        ctr = ctrs[r, l]
        pick = torch.where(ctr >= pm.pol["race_bound"], head, fast)
        has = waiting.any(dim=1) & cond
        ctrs[r, l] = torch.where(has, torch.where(pick != head, ctr + 1, 0),
                                 ctr)
        grant(st, cfg, tb, pm, has, pick, t, wakeup=True)
