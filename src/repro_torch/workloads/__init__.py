"""Workload layer of the port: the counter-based RNG and the workload-owned
``SimTables`` columns.

:mod:`.generators` (ids, stream constants, threefry keys and uniforms,
and the host blocks of the serving sims: arrivals, service times,
choices), :mod:`.traces` (a workload materialized as a trace),
:mod:`.keys` (the Zipf sampler constants that ``build_params`` always
computes), and the two per-core tenancy columns below, registered as the
JAX package registers them.
"""

from repro_torch.core.columns import ColumnSpec, register_column
from repro_torch.workloads.generators import ARRIVALS, SERVICES

register_column(ColumnSpec(
    name="slo_scale", dtype="f32", default=1.0, field="slo_scale",
    owner="workloads",
    doc="per-core SLO multiplier (multi-class tenancy)"))
register_column(ColumnSpec(
    name="wl_service", dtype="i32", default=-1,
    field="wl_service_per_core", numeric=False,
    encode=lambda d: -1 if not d else SERVICES[d],
    owner="workloads",
    doc="per-core SERVICES id override (-1 = inherit wl_service)"))

__all__ = ["ARRIVALS", "SERVICES"]
