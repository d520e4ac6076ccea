"""The paper's contribution, ported: the AIMD reorder window
(:mod:`.aimd`), the lock-policy registry (:mod:`.policies`) and the
discrete-event AMP simulator (:mod:`.simlock`)."""

from repro_torch.core.aimd import AIMDWindow, aimd_update, unit_for
from repro_torch.core.policies import REGISTRY, LockPolicy

__all__ = ["AIMDWindow", "aimd_update", "unit_for", "LockPolicy",
           "REGISTRY"]
