"""Key-aware dispatch policies for key-sharded traffic (``n_keys > 0``).

Three queue-less policies that read each epoch's Zipf-drawn lock
(``SimState.cur_lock``) and exploit the rank-preserving bucketing (lock 0
is the hot bucket):

* ``ks_erew`` — EREW key affinity: every lock has a static *owner* core,
  active big cores first; the owner is shuffled ahead of the FIFO head,
  at most ``erew_bound`` grants in a row.
* ``ks_crew`` — CREW: each epoch's ``STREAM_RW`` uniform classifies it a
  write (``cur_rw < crew_wfrac``) or a read; the earliest reader goes
  first, else a write of the owner, at most ``crew_bound`` in a row.
* ``ks_jbsq`` — bounded JBSQ(k): the least-served waiter (fewest epochs,
  then the earliest attempt), back to the FIFO head after ``jbsq_k``
  bypasses in a row.

Plain ``fifo`` under a keyed config is the CRCW baseline.  The owner map
ranks inactive (padded) cores last, so a padded cell runs as the unpadded
one.  With the key gate off they are single-lock policies (owner = the
first big core, every epoch a read).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policies import register
from repro_torch.core.policies.base import (INF, LockPolicy, grant,
                                            policy_opts, queueless_acquire,
                                            rows, waiting_mask)

DEFAULT_BOUND = 4       # erew/crew/jbsq head-bypass bound
DEFAULT_WFRAC = 0.5     # crew write fraction threshold


def _owner_of(tb, pm, l) -> torch.Tensor:
    """Static owner core of lock ``l`` (``[B]``): position ``l mod
    n_active`` in the stable order active bigs, active littles, inactive
    cores, so the owner is always active."""
    n = tb.big.shape[1]
    idx = torch.arange(n, device=tb.big.device)
    rank = torch.where(idx[None, :] < pm.n_active[:, None], 1 - tb.big, 2)
    pref = torch.argsort(rank, dim=1, stable=True)
    pos = torch.remainder(l, torch.clamp_min(pm.n_active, 1).long())
    return pref[rows(l), pos]


def _fifo_head(st, waiting) -> torch.Tensor:
    """Earliest attempt among the waiting set (lowest core on ties)."""
    return torch.argmin(torch.where(waiting, st.attempt_t, INF), dim=1)


def _bounded_grant(st, cfg, tb, pm, l, t, cond, waiting, prefer, use_pref,
                   ctr_slot, bound) -> None:
    """Grant ``prefer`` while the lock's bypass counter is under ``bound``,
    else the FIFO head; count the grants in a row that bypassed the head
    (granting the head resets it)."""
    head = _fifo_head(st, waiting)
    ctrs = st.pol[ctr_slot]
    r = rows(l)
    ctr = ctrs[r, l]
    use = use_pref & (ctr < bound)
    pick = torch.where(use, prefer, head)
    bypassed = use & (pick != head)
    has = waiting.any(dim=1) & cond
    ctrs[r, l] = torch.where(has, torch.where(bypassed, ctr + 1, 0), ctr)
    grant(st, cfg, tb, pm, has, pick, t, wakeup=True)


@register
class KsErewPolicy(LockPolicy):
    name = "ks_erew"
    table_slots = ("big",)
    param_slots = ("n_active", "pol.erew_bound")
    state_slots = ("erew_ctr",)
    sweep_axes = {"erew_bound": "erew_bound"}
    host_dispatch = "key-erew"

    def init_params(self, cfg):
        return {"erew_bound": np.int32(
            policy_opts(cfg).get("erew_bound", DEFAULT_BOUND))}

    def init_state(self, cfg, b, device):
        return {"erew_ctr": torch.zeros((b, cfg.n_locks), dtype=torch.int32,
                                        device=device)}

    def on_acquire(self, st, cfg, tb, pm, c, t, cond):
        queueless_acquire(st, cfg, tb, pm, c, t, cond)

    def pick_next(self, st, cfg, tb, pm, l, t, cond):
        waiting = waiting_mask(st, cfg, tb, l)
        owner = _owner_of(tb, pm, l)
        _bounded_grant(st, cfg, tb, pm, l, t, cond, waiting, owner,
                       waiting[rows(l), owner], "erew_ctr",
                       pm.pol["erew_bound"])


@register
class KsCrewPolicy(LockPolicy):
    name = "ks_crew"
    uses_rw = True
    table_slots = ("big",)
    param_slots = ("n_active", "pol.crew_wfrac", "pol.crew_bound")
    state_slots = ("crew_ctr",)
    sweep_axes = {"crew_wfrac": "crew_wfrac", "crew_bound": "crew_bound"}
    host_dispatch = "key-crew"

    def init_params(self, cfg):
        kw = policy_opts(cfg)
        return {"crew_wfrac": np.float32(kw.get("crew_wfrac",
                                                DEFAULT_WFRAC)),
                "crew_bound": np.int32(kw.get("crew_bound", DEFAULT_BOUND))}

    def init_state(self, cfg, b, device):
        return {"crew_ctr": torch.zeros((b, cfg.n_locks), dtype=torch.int32,
                                        device=device)}

    def on_acquire(self, st, cfg, tb, pm, c, t, cond):
        queueless_acquire(st, cfg, tb, pm, c, t, cond)

    def pick_next(self, st, cfg, tb, pm, l, t, cond):
        waiting = waiting_mask(st, cfg, tb, l)
        # A write where the epoch's rw uniform is under the write fraction
        # (cur_rw stays 1.0 with keys off: every epoch a read).
        writer = st.cur_rw < pm.pol["crew_wfrac"][:, None]
        readers = waiting & ~writer
        r_head = _fifo_head(st, readers)
        owner = _owner_of(tb, pm, l)
        r = rows(l)
        owner_writes = waiting[r, owner] & writer[r, owner]
        any_r = readers.any(dim=1)
        # Readers first (the earliest); else the owner's write; else
        # (use_pref false) the FIFO head, an ordinary writer.
        prefer = torch.where(any_r, r_head,
                             torch.where(owner_writes, owner, 0))
        _bounded_grant(st, cfg, tb, pm, l, t, cond, waiting, prefer,
                       any_r | owner_writes, "crew_ctr",
                       pm.pol["crew_bound"])


@register
class KsJbsqPolicy(LockPolicy):
    name = "ks_jbsq"
    param_slots = ("pol.jbsq_k",)
    state_slots = ("jbsq_ctr",)
    sweep_axes = {"jbsq_k": "jbsq_k"}
    host_dispatch = "key-jbsq"

    def init_params(self, cfg):
        return {"jbsq_k": np.int32(
            policy_opts(cfg).get("jbsq_k", DEFAULT_BOUND))}

    def init_state(self, cfg, b, device):
        return {"jbsq_ctr": torch.zeros((b, cfg.n_locks), dtype=torch.int32,
                                        device=device)}

    def on_acquire(self, st, cfg, tb, pm, c, t, cond):
        queueless_acquire(st, cfg, tb, pm, c, t, cond)

    def pick_next(self, st, cfg, tb, pm, l, t, cond):
        waiting = waiting_mask(st, cfg, tb, l)
        # Least served: fewest completed epochs, the earliest attempt
        # among those tied.
        served = torch.where(waiting, st.ep_cnt, INF)
        tied = waiting & (st.ep_cnt == served.amin(dim=1, keepdim=True))
        _bounded_grant(st, cfg, tb, pm, l, t, cond, waiting,
                       _fifo_head(st, tied), waiting.any(dim=1), "jbsq_ctr",
                       pm.pol["jbsq_k"])
