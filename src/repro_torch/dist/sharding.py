"""How a split sweep tiles its cells over devices: the port's copy of
``row_splits`` from the JAX package's ``repro/dist/sharding.py``.

The reference's logical-axis rules (``Rules``, ``build_rules``,
``build_sweep_rules``, ``use_mesh``, ``constrain``) place arrays for
GSPMD and have no counterpart here: a split sweep
(``repro_torch.core.simlock.sweep(devices=...)``) gives each device a
contiguous block of cells itself.
"""

from __future__ import annotations


def row_splits(n_rows: int, n_shards: int) -> list:
    """Contiguous per-shard row counts for ``n_rows`` tiled over
    ``n_shards`` (equal blocks; requires divisibility)."""
    if n_shards <= 0 or n_rows % n_shards:
        raise ValueError(f"{n_rows} rows do not tile over {n_shards} shards")
    return [n_rows // n_shards] * n_shards
