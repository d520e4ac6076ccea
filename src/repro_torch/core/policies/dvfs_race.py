"""dvfs_race — only its owned ``race_w`` table column so far.

The policy itself is not ported yet (``SimConfig(policy="dvfs_race")``
raises ``NotImplementedError``).  Its column is registered so the port's
``SimTables.col`` holds the same keys as the JAX package's, whose
registry always carries it.
"""

from __future__ import annotations

from repro_torch.core import energy as _energy  # noqa: F401  (dvfs column)
from repro_torch.core.columns import ColumnSpec, register_column

register_column(ColumnSpec(
    name="race_w", dtype="f32", default=1.0, owner="dvfs_race",
    doc="per-core race-to-idle priority weight (0 bans a core from "
        "being shuffled forward; it still gets the forced-head grant)"))
