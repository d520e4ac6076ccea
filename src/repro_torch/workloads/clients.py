"""Multi-class clients: per-class SLOs, mix ratios, core affinity — the
port's copy of the JAX package's ``repro/workloads/clients.py``.

One workload can model latency-critical + best-effort tenants side by
side (paper Fig 8c): each :class:`ClientClass` carries its share of the
arrival stream (``weight``), its own SLO and service distribution, and —
for the AMP lock simulator, where each core *is* a client — a big/little
core affinity.

Consumers:

* the serving engine: :func:`multiclass_workload` drives a
  ``ServingEngine`` with one Poisson stream split over the classes;
  ``epoch_id`` = class index, so the ASL scheduler keeps one AIMD
  reorder window per class (the paper's per-epoch-id windows).
* the lock simulator: :func:`amp_config` maps classes onto cores
  (affinity + weights) and installs the per-core SLO-scale (and service)
  columns that ride in ``SimTables`` — one batched sweep covers all
  tenants, in ``fused_chunk`` on the card.
* the trace recorder: ``traces.generate(..., classes=mix)`` stamps each
  request with its class id and per-class service draw.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import stats
from repro_torch.workloads.generators import (STREAM_CLASS, ServiceSpec,
                                              choice)


@dataclasses.dataclass(frozen=True)
class ClientClass:
    """One tenant class of a mixed workload."""

    name: str
    weight: float = 1.0                  # share of the arrival stream
    slo: float = math.inf                # per-class SLO (consumer units)
    service: ServiceSpec = ServiceSpec()
    affinity: str = "any"                # "big" | "little" | "any"

    def __post_init__(self):
        if self.affinity not in ("big", "little", "any"):
            raise ValueError(f"bad affinity {self.affinity!r}")
        if self.weight <= 0:
            raise ValueError("class weight must be positive")


@dataclasses.dataclass(frozen=True)
class WorkloadMix:
    """A weighted set of client classes."""

    classes: tuple

    def __post_init__(self):
        if not self.classes:
            raise ValueError("empty mix")

    def probs(self) -> np.ndarray:
        w = np.asarray([c.weight for c in self.classes], np.float64)
        return w / w.sum()

    def class_ids(self, n: int, seed: int,
                  *, stream: int = STREAM_CLASS) -> np.ndarray:
        """Class id per request — counter-based categorical by weight
        (one sampler: generators.choice)."""
        return choice(np.arange(len(self.classes), dtype=np.int32), n,
                      seed, stream=stream,
                      weights=[c.weight for c in self.classes])

    def slos(self) -> np.ndarray:
        return np.asarray([c.slo for c in self.classes], np.float64)


def assign_cores(mix: WorkloadMix, big) -> np.ndarray:
    """Class id per core honoring affinity, then weight shares.

    ``big`` is the simulator's per-core big/little tuple.  Cores with a
    class's affinity are claimed first (big-affine classes take big cores
    etc.); "any" classes fill the remainder by weight.  Every core gets
    a class; raises if an affinity cannot be satisfied at all.
    """
    big = np.asarray(big, bool)
    n = len(big)
    out = np.full(n, -1, np.int64)
    pools = {"big": [c for c in range(n) if big[c]],
             "little": [c for c in range(n) if not big[c]]}
    # Target core counts proportional to weight (at least 1 per class).
    p = mix.probs()
    want = np.maximum(1, np.round(p * n).astype(int))
    affine = [(k, c) for k, c in enumerate(mix.classes)
              if c.affinity != "any"]
    for k, cls in affine:
        pool = pools[cls.affinity]
        if not pool:
            raise ValueError(f"class {cls.name!r} wants {cls.affinity} "
                             "cores but none are left")
        take = pool[:max(1, min(want[k], len(pool)))]
        for c in take:
            out[c] = k
            pool.remove(c)
    rest = [c for c in range(n) if out[c] < 0]
    anyk = [k for k, c in enumerate(mix.classes) if c.affinity == "any"]
    if rest and not anyk:
        anyk = list(range(len(mix.classes)))   # spill onto affine classes
    for i, c in enumerate(rest):
        # round-robin weighted: repeat class k want[k] times
        seq = [k for k in anyk for _ in range(int(want[k]))] or anyk
        out[c] = seq[i % len(seq)]
    return out


def amp_config(cfg, mix: WorkloadMix, base_slo: float):
    """Specialize a ``SimConfig`` for a multi-class tenancy.

    Maps classes to cores (:func:`assign_cores`) and installs the
    per-core ``slo_scale`` column (class SLO / ``base_slo``) — run the
    result with ``slo_us=base_slo`` and each core's effective SLO is its
    class's own.  A class that declares a non-default :class:`ServiceSpec`
    additionally installs its service *shape* into the per-core
    ``wl_service_per_core`` column (big/little tenants with different
    Get/Put mixes side by side); the shape parameters (``cv`` / ``mix``
    / ``mix_scale``) stay run-wide knobs.  Returns
    ``(cfg, class_of_core)``.
    """
    # Lazy import: simlock imports this package (generators) at load
    # time; by the time a SimConfig reaches amp_config it is loaded.
    from repro_torch.core import simlock as sl
    assign = assign_cores(mix, cfg.big[:cfg.n_cores])
    scale = tuple(
        float(mix.classes[k].slo / base_slo) if
        math.isfinite(mix.classes[k].slo) else 1e9
        for k in assign)
    default = ServiceSpec()
    svc = tuple(mix.classes[k].service.dist
                if mix.classes[k].service != default else None
                for k in assign)
    if any(svc):
        cfg = sl.with_columns(cfg, wl_service=svc)
    return sl.with_columns(cfg, slo_scale=scale), assign


def multiclass_workload(engine, mix: WorkloadMix, *, rate_rps: float,
                        duration_s: float, prompt_lens, new_tokens,
                        seed: int = 0, trace=None):
    """Drive a ``ServingEngine`` with a multi-class Poisson stream.

    Every request carries its class index as ``epoch_id`` and its class
    SLO as the TTFT SLO, so the ASL scheduler maintains one AIMD window
    per class.  Returns the engine (inspect ``engine.metrics()`` /
    ``metrics_by_class``).
    """
    from repro_torch.serving.engine import replay_workload
    from repro_torch.workloads import traces
    from repro_torch.workloads.generators import ArrivalSpec
    if trace is None:
        trace = traces.generate(
            ArrivalSpec("poisson", rate_rps), None, duration_s, seed,
            classes=mix, cols=traces.request_columns(prompt_lens,
                                                     new_tokens))
    return replay_workload(engine, trace)


def metrics_by_class(engine, mix: WorkloadMix,
                     warmup_frac: float = 0.1) -> dict:
    """Per-class serving metrics (TTFT tail + SLO violation rate).
    Drops a ``warmup_frac`` completion-order prefix per class, matching
    ``ServingEngine.metrics`` so the tails are comparable."""
    out = {}
    for k, cls in enumerate(mix.classes):
        reqs = [r for r in engine.done
                if r.epoch_id == k and r.first_token_t is not None]
        reqs = reqs[int(len(reqs) * warmup_frac):]
        if not reqs:
            out[cls.name] = {"n": 0}
            continue
        ttft = np.asarray([r.first_token_t - r.arrival_t for r in reqs])
        out[cls.name] = {
            "n": len(reqs),
            # stats.percentile: nan (never a raise) on zero samples.
            "ttft_p50": stats.percentile(ttft, 50),
            "ttft_p99": stats.percentile(ttft, 99),
            "slo_violation_rate": float(np.mean(ttft > cls.slo)),
        }
    return out
