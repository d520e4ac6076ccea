"""Serving and straggler benchmarks of the port: the counterpart of the
JAX package's ``benchmarks/serving_bench.py``, with the same tables,
sections, row names and keys, over ``repro_torch``'s host-side
simulators.

    PYTHONPATH=src python examples/serving_bench_torch.py

* ``db_serving``: a continuous-batching engine with mixed short / long
  requests under FIFO / greedy / ASL admission, at a load where the TTFT
  SLO is met only by bounded reordering.
* ``db_multiclass``: a latency-critical and a best-effort class share one
  engine; ASL keeps one AIMD window per class.
* ``dispatch_fleet``: a heterogeneous replica fleet (big / little pods)
  under every dispatch policy across a load sweep.
* ``straggler_training``: bounded-staleness data parallelism against
  synchronous and unbounded commits under transient stragglers.

Everything here is host-side numpy on a virtual clock (no tensor work, no
card): each row equals the reference's for the same seed.  Prints one JSON
object per row.
"""

import hashlib
import json
import pathlib
import sys

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT / "src"))

from repro_torch.dist.staleness import (                  # noqa: E402
    BoundedStalenessController, simulate)
from repro_torch.serving.dispatch import (                # noqa: E402
    DISPATCH_POLICIES, simulate_dispatch)
from repro_torch.serving.engine import (                  # noqa: E402
    CostModel, ServingEngine, poisson_workload)
from repro_torch.workloads import ClientClass, WorkloadMix  # noqa: E402
from repro_torch.workloads.clients import (               # noqa: E402
    metrics_by_class, multiclass_workload)

# The policy / load grid: the reference benchmark's tables, unchanged.

ENGINE_POLICIES = (
    ("fifo", "fifo", {}),
    ("greedy", "greedy", {}),
    ("asl", "asl", dict(default_window=0.02, max_window=10.0)),
    ("asl-warm", "asl", dict(default_window=0.02, max_window=10.0,
                             warm_start=True, mi_factor=0.5)),
)
# DISPATCH_POLICIES comes from repro_torch.serving.dispatch, derived from
# the lock-policy registry (LockPolicy.host_dispatch).
# Offered load as a fraction of fleet capacity.
LOAD_FRACS = (0.2, 0.4, 0.6, 0.8, 0.9)
# 4 fast replicas at 10 rps + 4 slow at 10/3 rps (service_s=0.1, 3x slow)
DISPATCH_CAPACITY_RPS = 4 / 0.1 + 4 / (0.1 * 3.0)

# Global duration scale; 1.0 is the reference's full length.
SCALE = 1.0

DB_SLO_TTFT = 0.6


def db_serving(rate_rps=2.5, duration_s=150.0, slo_ttft=DB_SLO_TTFT):
    cost = CostModel(decode_step_s=2e-3, prefill_chunk_s=18e-3,
                     prefill_chunk=2048, max_batch=64)
    rows = []
    for name, sched, kw in ENGINE_POLICIES:
        eng = ServingEngine(sched, cost, scheduler_kwargs=kw, seed=1)
        poisson_workload(eng, rate_rps=rate_rps,
                         duration_s=duration_s * SCALE,
                         prompt_lens=[2048, 4096, 8192, 16384],
                         new_tokens=[32, 128, 256],
                         slo_ttft=slo_ttft, seed=2)
        m = eng.metrics()
        m.update(name=f"db_serving/{name}", slo_ttft=slo_ttft)
        rows.append(m)
    return rows


def db_multiclass(rate_rps=2.5, duration_s=150.0):
    """Fig 8c tenancy: a latency-critical and a best-effort class share
    one engine; ASL keeps one AIMD window per class (epoch_id)."""
    # No per-class ServiceSpec: engine replay derives all timing from
    # the CostModel + prompt_len/new_tokens columns (trace.service_s is
    # ignored on this path — see replay_workload).
    mix = WorkloadMix((
        ClientClass("latency-critical", weight=1.0, slo=0.4),
        ClientClass("best-effort", weight=1.0, slo=4.0),
    ))
    cost = CostModel(decode_step_s=2e-3, prefill_chunk_s=18e-3,
                     prefill_chunk=2048, max_batch=64)
    rows = []
    for name, sched, kw in ENGINE_POLICIES[:3]:        # fifo/greedy/asl
        eng = ServingEngine(sched, cost, scheduler_kwargs=kw, seed=1)
        multiclass_workload(eng, mix, rate_rps=rate_rps,
                            duration_s=duration_s * SCALE,
                            prompt_lens=[2048, 4096, 8192],
                            new_tokens=[32, 128], seed=2)
        per = metrics_by_class(eng, mix)
        row = dict(name=f"db_multiclass/{name}", by_class=per)
        for cls, m in per.items():
            for k, v in m.items():
                row[f"{cls}/{k}"] = v
        rows.append(row)
    return rows


def dispatch_fleet():
    rows = []
    for frac in LOAD_FRACS:
        rate = round(frac * DISPATCH_CAPACITY_RPS, 1)
        for pol in DISPATCH_POLICIES:
            m = simulate_dispatch(pol, rate_rps=rate, service_s=0.1,
                                  slo=0.5, duration_s=200.0 * SCALE,
                                  seed=3)
            m["name"] = f"dispatch/{pol}/load{frac:.2f}"
            m["rate_rps"] = rate
            m["load_frac"] = frac
            rows.append(m)
    return rows


def straggler_training():
    rows = []
    dur = [1.0] * 8
    kw = dict(straggle_prob=0.1, straggle_factor=5.0, seed=11,
              horizon_steps=300)
    for name, ctl, ckw in (
            ("sync", BoundedStalenessController(8, window_steps=0.0,
                                                max_window=0.0), {}),
            ("async-unbounded", BoundedStalenessController(
                8, window_steps=1e6, max_window=1e6),
             dict(quality_slo=float("inf"))),
            ("asl-staleness", BoundedStalenessController(
                8, window_steps=4.0, max_window=8.0),
             dict(quality_slo=6.0, penalty_per_stale=1.0))):
        sps, mean_st, p99_st = simulate(8, dur, controller=ctl, **kw, **ckw)
        rows.append(dict(name=f"straggler/{name}", steps_per_s=sps,
                         mean_staleness=mean_st, p99_staleness=p99_st))
    return rows


ALL = {
    "db_serving": db_serving,
    "db_multiclass": db_multiclass,
    "dispatch_fleet": dispatch_fleet,
    "straggler_training": straggler_training,
}


def plain_value(v):
    """A row's value with numpy scalars as Python numbers, and tuples as
    lists, recursively (what JSON writes)."""
    if isinstance(v, dict):
        return {k: plain_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain_value(x) for x in v]
    return v.item() if hasattr(v, "item") else v


def rows_digest(rows) -> str:
    """sha256 of a section's rows as JSON with sorted keys: floats by
    their shortest repr (exact), NaN as NaN."""
    return hashlib.sha256(json.dumps(plain_value(rows), sort_keys=True)
                          .encode()).hexdigest()


def main() -> dict:
    """Run every section and print each row as JSON; -> {section: rows}."""
    out = {name: section() for name, section in ALL.items()}
    for rows in out.values():
        for row in rows:
            print(json.dumps(plain_value(row), sort_keys=True))
    return out


if __name__ == "__main__":
    main()
