"""Host-side fault schedules for the serving sims (the fleet dispatcher).

Everything is precomputed into numpy arrays from the same counter-pure
streams the simulator draws from, so a schedule is the same whatever the
horizon or the interleaving: element ``i`` is pure in ``(seed, replica,
i)``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.faults.model import FaultSpec
from repro_torch.workloads import generators as wlg


def outage_mask(spec: FaultSpec, n_replicas: int, duration: float,
                seed: int) -> np.ndarray:
    """bool[n_replicas, n_slots]: replica r is out during slot k.
    Slot k covers [k*churn_period, (k+1)*churn_period)."""
    n_slots = int(np.ceil(max(duration, 0.0) / spec.churn_period)) + 2
    if spec.churn_rate <= 0.0:
        return np.zeros((n_replicas, n_slots), bool)
    return np.stack([
        wlg.straggle_uniforms(seed, r, n_slots, stream=wlg.STREAM_CHURN)
        < spec.churn_rate for r in range(n_replicas)])


def spike_hits(spec: FaultSpec, replica: int, n: int,
               seed: int) -> np.ndarray:
    """bool[n]: dispatch i on ``replica`` is a straggler spike."""
    if spec.straggle_rate <= 0.0:
        return np.zeros(n, bool)
    u = wlg.straggle_uniforms(seed, replica, n, stream=wlg.STREAM_SPIKE)
    return u < spec.straggle_rate


def preempt_stalls(spec: FaultSpec, replica: int, n: int,
                   seed: int) -> np.ndarray:
    """f64[n]: preemption stall (seconds) paid by dispatch i on
    ``replica``: Exp(mean preempt_scale) with probability preempt_rate."""
    if spec.preempt_rate <= 0.0:
        return np.zeros(n)
    u = wlg.straggle_uniforms(seed, replica, n,
                              stream=wlg.STREAM_PREEMPT)
    uz = wlg.straggle_uniforms(seed, replica, n,
                               stream=wlg.STREAM_PREEMPT ^ 0x40000)
    stall = spec.preempt_scale * -np.log1p(-uz)
    return np.where(u < spec.preempt_rate, stall, 0.0)
