"""Fault layer of the port.  The fault models themselves are not ported
yet (a config with a fault rate raises ``NotImplementedError``); the
per-core eligibility column is registered so ``SimTables.col`` matches
the JAX package's."""

from repro_torch.core.columns import ColumnSpec, register_column

register_column(ColumnSpec(
    name="ft_mask", dtype="f32", default=1.0, field="fault_mask",
    owner="faults",
    doc="per-core fault eligibility (0/1); multiplies the fault rates"))
