"""Fault layer of the port.

Device side: :func:`preempt_extra` / :func:`straggle_extra` /
:func:`churn_off` ride inside the simulator's event handlers (holder
preemption, core churn, straggler spikes; :mod:`.model`), and the per-core
eligibility column is registered so ``SimTables.col`` matches the JAX
package's.  Host side: :class:`FaultSpec` and the precomputed schedules of
:mod:`.host` drive the fleet dispatcher.
"""

from repro_torch.core.columns import ColumnSpec, register_column
from repro_torch.faults.host import outage_mask, preempt_stalls, spike_hits
from repro_torch.faults.model import (FaultSpec, churn_off, churn_rejoin,
                                      preempt_extra, straggle_extra)

register_column(ColumnSpec(
    name="ft_mask", dtype="f32", default=1.0, field="fault_mask",
    owner="faults",
    doc="per-core fault eligibility (0/1); multiplies the fault rates"))

__all__ = [
    "FaultSpec",
    "churn_off",
    "churn_rejoin",
    "outage_mask",
    "preempt_extra",
    "preempt_stalls",
    "spike_hits",
    "straggle_extra",
]
