"""Fault layer of the port: the fault models' draws (:mod:`.model`:
holder preemption, core churn, straggler spikes) and the per-core
eligibility column, registered so ``SimTables.col`` matches the JAX
package's."""

from repro_torch.core.columns import ColumnSpec, register_column

register_column(ColumnSpec(
    name="ft_mask", dtype="f32", default=1.0, field="fault_mask",
    owner="faults",
    doc="per-core fault eligibility (0/1); multiplies the fault rates"))
