"""The fault model's device-side draws, on batched tensors: the port of
``repro/faults/model.py``.

Three fault classes break the paper's symmetry assumption:

* **Lock-holder preemption**: the holder is descheduled mid-critical-
  section for an Exp-distributed stall that every waiter eats.
* **Core churn**: during an "off" slot a core's acquire attempts bounce
  to the next slot boundary.
* **Straggler spikes**: a critical section occasionally runs ``scale``x
  long.

Every draw is pure in ``(seed, stream, core, index)``: preemption and
straggling index by the core's critical-section counter, churn by the time
slot.  A zero rate is bit-identical to fault-free (the draw compares
``u < 0`` and every term is an additive ``where``).  Each function takes
``[B]`` tensors (one value per sweep cell): the cells' seeds, the core
``c`` whose event fires, and its index; ``n`` is the cores a cell
has (:func:`repro_torch.workloads.generators.event_uniform`).

:class:`FaultSpec` holds the same three knobs in seconds for the host-side
serving sims (:mod:`repro_torch.faults.host` turns it into schedules).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.workloads import generators as wlg


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Host-level fault knobs (seconds) for the serving sims: the
    analogue of the ``SimConfig`` fault fields (microseconds).

    ``preempt`` hits a request's *service* (a stall added on the
    replica, mean ``preempt_scale`` seconds), ``churn`` takes whole
    replicas out for ``churn_period``-second slots, ``straggle``
    multiplies a service time by ``straggle_scale``.
    """

    preempt_rate: float = 0.0     # P(stall) per dispatch
    preempt_scale: float = 0.0    # mean stall (seconds)
    churn_rate: float = 0.0       # P(replica out) per period slot
    churn_period: float = 1.0     # outage slot length (seconds)
    straggle_rate: float = 0.0    # P(service spike) per dispatch
    straggle_scale: float = 1.0   # spike multiplier (>= 1)

    def __post_init__(self):
        for f in ("preempt_rate", "churn_rate", "straggle_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0 or math.isnan(v):
                raise ValueError(f"{f} must be a probability, got {v!r}")
        if self.preempt_scale < 0.0 or math.isnan(self.preempt_scale):
            raise ValueError(f"preempt_scale must be >= 0, "
                             f"got {self.preempt_scale!r}")
        if self.churn_period <= 0.0 or math.isnan(self.churn_period):
            raise ValueError(f"churn_period must be > 0, "
                             f"got {self.churn_period!r}")
        if self.straggle_scale < 1.0 or math.isnan(self.straggle_scale):
            raise ValueError(f"straggle_scale must be >= 1, "
                             f"got {self.straggle_scale!r}")

    @property
    def active(self) -> bool:
        return (self.preempt_rate > 0.0 or self.churn_rate > 0.0
                or self.straggle_rate > 0.0)


def preempt_extra(seed, c, cs_ix, rate, scale_ticks, n: int):
    """Holder-preemption stall (ticks, i32) for core ``c``'s ``cs_ix``-th
    critical section: Exp(mean ``scale_ticks``) with probability
    ``rate``, else 0."""
    u = wlg.event_uniforms(seed, (wlg.STREAM_PREEMPT,
                                  wlg.STREAM_PREEMPT ^ 0x40000), c, cs_ix, n)
    stall = (scale_ticks * wlg.exp_unit(u[:, 1])).to(torch.int32)
    return torch.where(u[:, 0] < rate, stall, 0)


def straggle_extra(seed, c, cs_ix, dur, rate, scale, n: int):
    """Straggler spike: the extra ticks that stretch this critical section
    to ``scale`` x its drawn duration, with probability ``rate``."""
    u = wlg.event_uniform(seed, wlg.STREAM_SPIKE, c, cs_ix, n)
    extra = (dur.to(torch.float32) * (scale - 1.0)).to(torch.int32)
    return torch.where(u < rate, extra, 0)


def churn_off(seed, c, t, rate, period_ticks, n: int):
    """Is core ``c`` churned out during the slot holding tick ``t``?  One
    decision per (core, slot)."""
    slot = torch.div(t, period_ticks, rounding_mode="floor")
    return wlg.event_uniform(seed, wlg.STREAM_CHURN, c, slot, n) < rate


def churn_rejoin(t, period_ticks):
    """First tick of the next churn slot (strictly after ``t``)."""
    return (torch.div(t, period_ticks, rounding_mode="floor") + 1) \
        * period_ticks
