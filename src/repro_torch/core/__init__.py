"""The paper's contribution, ported: the AIMD reorder window
(:mod:`.aimd`), the lock baselines (:mod:`.locks`), the reorderable lock
and the ASL mutex (:mod:`.reorderable`, :mod:`.libasl`), the lock ordering
as an engine-slot admission policy (:mod:`.asl_schedule`), the lock-policy
registry (:mod:`.policies`) and the discrete-event AMP simulator
(:mod:`.simlock`)."""

from repro_torch.core.aimd import AIMDWindow, aimd_update, unit_for
from repro_torch.core.asl_schedule import (ASLScheduler, FIFOScheduler,
                                           GreedyScheduler, SCHEDULERS)
from repro_torch.core.libasl import ASLMutex, LibASL
from repro_torch.core.locks import (FIFOLock, ProportionalLock, TASLock,
                                    TicketLock)
from repro_torch.core.policies import REGISTRY, LockPolicy
from repro_torch.core.reorderable import ReorderableLock

__all__ = [
    "AIMDWindow", "aimd_update", "unit_for", "ASLScheduler",
    "FIFOScheduler", "GreedyScheduler", "SCHEDULERS", "ASLMutex", "LibASL",
    "FIFOLock", "ProportionalLock", "TASLock", "TicketLock",
    "ReorderableLock", "LockPolicy", "REGISTRY",
]
