"""Registry of policy/feature-owned per-core ``SimTables`` columns.

A copy of the JAX package's registry (same specs, same encodings), so the
port's ``SimTables.col`` holds the same keys and dtypes.  Any lock policy
or feature layer (workloads, faults, energy) can declare a per-core column
that rides in ``SimTables.col`` — the per-core analogue of the
``SimParams.pol`` / ``SimState.pol`` slots.  A :class:`ColumnSpec` names
the column, its dtype, its neutral default (used to pad short value
tuples), and where its values come from on :class:`SimConfig`: a
dedicated config field or the generic ``SimConfig.columns`` tuple for
plugin-owned columns.

Registration happens at import time of the owning layer
(``repro_torch.faults`` registers ``ft_mask``, ``repro_torch.workloads``
registers ``slo_scale`` + ``wl_service``, ``repro_torch.core.energy``
registers the DVFS/power columns, a policy module registers its own).
``simlock.build_tables`` materializes every registered column.

This module imports nothing from the package, so the feature packages can
register columns while ``repro_torch.core`` is still mid-initialization.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

#: name -> ColumnSpec, in registration order (order is not load-bearing:
#: ``SimTables.col`` is a dict pytree, flattened in sorted-key order).
COLUMNS: dict = {}


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """One declared per-core column of ``SimTables.col``."""

    #: column key in ``SimTables.col`` (and the sweep-axis name when the
    #: spec has no dedicated config field).
    name: str
    #: "f32" | "i32" — the traced array dtype.
    dtype: str = "f32"
    #: neutral pad/default value: a config that does not set the column
    #: gets a full-width array of this (and short tuples are padded with
    #: it, never index-clamped).
    default: float = 0.0
    #: ``SimConfig`` field carrying the raw per-core values; ``None`` ->
    #: the values come from the generic ``SimConfig.columns`` tuple.
    field: Optional[str] = None
    #: whether the column is a table sweep axis (rebuilds ``SimTables``
    #: per cell; still one executable).
    sweepable: bool = True
    #: optional raw-entry -> numeric encoder (e.g. a SERVICES name ->
    #: its id); identity when ``None``.
    encode: Optional[Callable] = None
    #: validate raw entries as numbers (NaN / negative rejected at
    #: ``SimConfig`` construction).  ``False`` for encoded columns whose
    #: raw entries are names.
    numeric: bool = True
    #: numeric entries must be strictly positive (e.g. ``dvfs`` divides
    #: segment durations).
    positive: bool = False
    #: the registering layer ("faults", "workloads", "energy", or a
    #: policy name) — documentation + conformance.
    owner: str = ""
    doc: str = ""

    @property
    def axis(self) -> str:
        """Sweep-axis / config-surface name for this column."""
        return self.field or self.name

    def raw_values(self, cfg) -> tuple:
        """The raw (un-encoded, un-padded) per-core values on ``cfg``."""
        if self.field:
            return tuple(getattr(cfg, self.field))
        return tuple(dict(cfg.columns).get(self.name, ()))

    def host_values(self, cfg, n: int) -> tuple:
        """Encoded values padded with the default to ``n`` cores — the
        exact host-side tuple ``build_tables`` materializes."""
        raw = self.raw_values(cfg)
        enc = tuple(self.encode(v) for v in raw) if self.encode else raw
        return (enc + (self.default,) * n)[:n]

    def np_values(self, cfg, n: int):
        """:meth:`host_values` as a numpy array for host-side metric
        paths (e.g. ``simlock.summarize``'s per-core SLO scaling) —
        float64/int64, NOT the traced dtype: host metrics keep full
        precision so padding a column can never move a summary bit."""
        import numpy as np
        return np.asarray(self.host_values(cfg, n),
                          float if self.dtype == "f32" else np.int64)


def register_column(spec: ColumnSpec) -> ColumnSpec:
    """Register a column spec (append-only; duplicate names rejected)."""
    if not spec.name:
        raise ValueError("ColumnSpec needs a name")
    if spec.name in COLUMNS:
        raise ValueError(f"duplicate SimTables column {spec.name!r} "
                         f"(owned by {COLUMNS[spec.name].owner!r})")
    if spec.dtype not in ("f32", "i32"):
        raise ValueError(f"ColumnSpec.dtype must be 'f32'|'i32', "
                         f"got {spec.dtype!r}")
    COLUMNS[spec.name] = spec
    return spec


def lookup(name: str) -> ColumnSpec:
    """Spec by column name, with a did-you-mean on unknown names."""
    try:
        return COLUMNS[name]
    except KeyError:
        import difflib
        hint = difflib.get_close_matches(name, COLUMNS, n=1)
        raise ValueError(
            f"unknown SimTables column {name!r}; registered: "
            f"{sorted(COLUMNS)}"
            + (f" -- did you mean {hint[0]!r}?" if hint else "")) from None


def axis_to_spec() -> dict:
    """Sweep-axis name -> spec, for every sweepable registered column."""
    return {s.axis: s for s in COLUMNS.values() if s.sweepable}
