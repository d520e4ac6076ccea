"""Pluggable lock-policy registry of the port.

Registration order fixes the integer policy ids, and the port keeps the
JAX package's: ``fifo=0, tas=1, prop=2, libasl=3, edf=4, shfl=5,
dvfs_race=6, ks_erew=7, ks_crew=8, ks_jbsq=9``.
"""

from __future__ import annotations

from repro_torch.core.policies.base import LockPolicy

#: name -> the singleton policy instance, in registration order.
REGISTRY: dict = {}


def register(cls):
    """Class decorator: instantiate and register a LockPolicy."""
    pol = cls()
    if not pol.name:
        raise ValueError(f"{cls.__name__} has no policy name")
    if pol.name in REGISTRY:
        raise ValueError(f"duplicate lock policy {pol.name!r}")
    REGISTRY[pol.name] = pol
    return cls


def get(name: str) -> LockPolicy:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown lock policy {name!r}; registered: "
                         f"{sorted(REGISTRY)}") from None


def policy_ids() -> dict:
    """name -> stable integer id (registration order)."""
    return {name: i for i, name in enumerate(REGISTRY)}


class MergedPolicy(LockPolicy):
    """Several registered policies behind one LockPolicy: the cells of one
    batch may each run another member, selected by ``SimParams.pol_id``.

    Every hook applies each member's hook under ``cond & (pol_id ==
    member id)``.  Hooks are fully conditional, so a masked-off member
    commits nothing (not even a key split) and each cell runs exactly as
    under its own policy.  Param and state slots are the members' union
    by name; ``uses_standby`` and ``uses_rw`` are any member's (the engine
    draws the read/write uniform only in the cells of a member that reads
    it, :meth:`rw_member_ids`)."""

    def __init__(self, names):
        ids = policy_ids()
        self.names = tuple(names)
        self.members = tuple((ids[n], get(n)) for n in self.names)
        self.name = "+".join(self.names)
        self.uses_standby = any(m.uses_standby for _, m in self.members)
        self.uses_rw = any(m.uses_rw for _, m in self.members)
        self.param_slots = tuple(dict.fromkeys(
            s for _, m in self.members for s in m.param_slots))
        self.table_slots = tuple(dict.fromkeys(
            s for _, m in self.members for s in m.table_slots))
        self.state_slots = tuple(dict.fromkeys(
            s for _, m in self.members for s in m.state_slots))
        self.sweep_axes = {}
        for _, m in self.members:
            for axis, slot in m.sweep_axes.items():
                if self.sweep_axes.setdefault(axis, slot) != slot:
                    raise ValueError(
                        f"policy set {self.names} maps sweep axis "
                        f"{axis!r} onto two different slots")

    def rw_member_ids(self) -> tuple:
        """Ids of the members that read the per-epoch read/write uniform."""
        return tuple(pid for pid, m in self.members if m.uses_rw)

    def init_params(self, cfg) -> dict:
        out = {}
        for _, m in self.members:
            out.update(m.init_params(cfg))
        return out

    def init_state(self, cfg, b, device) -> dict:
        out = {}
        for _, m in self.members:
            out.update(m.init_state(cfg, b, device))
        return out

    def _fan(self, hook, pm, cond, *args, standby_only=False):
        for pid, m in self.members:
            if standby_only and not m.uses_standby:
                continue
            sub = cond & (pm.pol_id == pid)
            # A member commits nothing where its mask is false: skip it
            # when no cell runs it.
            if bool(sub.any()):
                getattr(m, hook)(*args, sub)

    def on_acquire(self, st, cfg, tb, pm, c, t, cond):
        self._fan("on_acquire", pm, cond, st, cfg, tb, pm, c, t)

    def on_standby_expiry(self, st, cfg, tb, pm, c, t, cond):
        self._fan("on_standby_expiry", pm, cond, st, cfg, tb, pm, c, t,
                  standby_only=True)

    def on_release(self, st, cfg, tb, pm, c, t, ep_latency, last, cond):
        self._fan("on_release", pm, cond, st, cfg, tb, pm, c, t,
                  ep_latency, last)

    def pick_next(self, st, cfg, tb, pm, l, t, cond):
        self._fan("pick_next", pm, cond, st, cfg, tb, pm, l, t)


_MERGED: dict = {}


def merged(names) -> MergedPolicy:
    """The cached :class:`MergedPolicy` for a policy-name tuple (one
    instance per distinct ``SimConfig.policy_set``)."""
    key = tuple(names)
    if key not in _MERGED:
        _MERGED[key] = MergedPolicy(key)
    return _MERGED[key]


def host_schedulers() -> dict:
    """Lock-policy name -> host admission-scheduler name (the
    ``asl_schedule`` analogue), for policies that have one."""
    return {p.name: p.host_scheduler for p in REGISTRY.values()
            if p.host_scheduler}


def dispatch_names() -> tuple:
    """Fleet-dispatch policy names (:mod:`repro_torch.serving.dispatch`),
    in registry order."""
    return tuple(p.host_dispatch for p in REGISTRY.values()
                 if p.host_dispatch)


# Import order == registry order == policy ids.
from repro_torch.core.policies import fifo as _fifo      # noqa: E402,F401
from repro_torch.core.policies import tas as _tas        # noqa: E402,F401
from repro_torch.core.policies import prop as _prop      # noqa: E402,F401
from repro_torch.core.policies import libasl as _libasl  # noqa: E402,F401
from repro_torch.core.policies import edf as _edf        # noqa: E402,F401
from repro_torch.core.policies import shfl as _shfl      # noqa: E402,F401
from repro_torch.core.policies import dvfs_race as _dvfs  # noqa: E402,F401
from repro_torch.core.policies import keyshard as _ks    # noqa: E402,F401

__all__ = ["LockPolicy", "REGISTRY", "register", "get", "policy_ids",
           "MergedPolicy", "merged", "host_schedulers", "dispatch_names"]
