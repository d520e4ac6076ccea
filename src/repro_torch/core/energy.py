"""DVFS and power columns of the port.

The in-sim energy integration is not ported yet (a config with a power
table raises ``NotImplementedError``).  The five columns are registered
as the JAX package registers them: ``dvfs`` divides the segment
durations host-side in ``build_tables`` (so it already works), and the
four power tables ride in ``SimTables.col``.
"""

from __future__ import annotations

from repro_torch.core.columns import ColumnSpec, register_column

register_column(ColumnSpec(
    name="dvfs", dtype="f32", default=1.0, field="dvfs",
    positive=True, owner="energy",
    doc="per-core frequency multiplier; divides segment durations, "
        "cubes into the active/spin power draw"))
for _name, _doc in (
        ("p_cs", "active (compute/CS) watts, scaled by dvfs^3"),
        ("p_spin", "busy-wait watts, scaled by dvfs^3"),
        ("p_park", "parked-in-queue watts"),
        ("p_idle", "idle watts (also inactive padded cores)")):
    register_column(ColumnSpec(
        name=_name, dtype="f32", default=0.0, field=_name,
        owner="energy", doc=_doc))

POWER_COLUMNS = ("p_cs", "p_spin", "p_park", "p_idle")
