"""DVFS and power columns of the port, and the default power calibration.

The five columns are registered as the JAX package registers them:
``dvfs`` divides the segment durations host-side in ``build_tables`` and
cubes into the active and busy-wait draw; the four power tables (watts
per phase) ride in ``SimTables.col``.  Any power table set on a config
turns the simulator's energy integration on
(``simlock._power_draw``, ``SimState.energy`` in watt-ticks).
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

#: Default per-class power calibration (watts), the JAX package's: a big
#: core's active draw is ~4x a little's for ~2-3.75x the speed.
BIG_W = {"p_cs": 4.0, "p_spin": 1.6, "p_park": 0.4, "p_idle": 0.2}
LITTLE_W = {"p_cs": 1.0, "p_spin": 0.4, "p_park": 0.12, "p_idle": 0.06}


def amp_power(big) -> dict:
    """The four power-column kwargs of a big/little map from ``BIG_W`` /
    ``LITTLE_W`` (splat into ``SimConfig`` or ``simlock.with_columns``)."""
    return {k: tuple(BIG_W[k] if b else LITTLE_W[k] for b in big)
            for k in POWER_COLUMNS}
