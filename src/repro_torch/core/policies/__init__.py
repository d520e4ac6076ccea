"""Pluggable lock-policy registry of the port.

Registration order fixes the integer policy ids, and the port keeps the
JAX package's: ``fifo=0, tas=1, prop=2, libasl=3``.  The later policies
(``edf``, ``shfl``, ``dvfs_race``, ``ks_*``) and the merged multi-policy
executables are not ported yet; naming one raises ``NotImplementedError``
in :mod:`repro_torch.core.simlock`.
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


# Import order == registry order == policy ids.
from repro_torch.core.policies import fifo as _fifo      # noqa: E402,F401
from repro_torch.core.policies import tas as _tas        # noqa: E402,F401
from repro_torch.core.policies import prop as _prop      # noqa: E402,F401
from repro_torch.core.policies import libasl as _libasl  # noqa: E402,F401
# dvfs_race registers only its owned table column so far.
from repro_torch.core.policies import dvfs_race as _dvfs  # noqa: E402,F401

__all__ = ["LockPolicy", "REGISTRY", "register", "get", "policy_ids"]
