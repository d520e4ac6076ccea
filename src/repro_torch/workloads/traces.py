"""Workload traces: the materialized form of a workload.

A :class:`Trace` holds sorted arrival times, per-request service times, a
class id per request and aligned extra columns (the serving engine stores
``prompt_len`` / ``new_tokens`` here).  Every draw is counter-based
(:mod:`repro_torch.workloads.generators`), so :func:`generate` is a pure
function of its specs and seed and equals the JAX package's
``repro/workloads/traces.py::generate`` for the same arguments.

Not ported yet: multi-class mixes (``classes=``, which need
``workloads/clients.py``) and the npz ``save`` / ``load``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.workloads.generators import (STREAM_CLASS, ArrivalSpec,
                                              ServiceSpec,  # noqa: F401
                                              arrival_times, choice,
                                              service_times)

FORMAT_VERSION = 1
STREAM_COLS_PROMPT = STREAM_CLASS ^ 0x20000
STREAM_COLS_TOKENS = STREAM_CLASS ^ 0x30000


@dataclasses.dataclass
class Trace:
    """One recorded workload.  ``klass`` indexes ``classes``/``slo``."""

    arrival_t: np.ndarray                 # f64[n], sorted
    service_s: np.ndarray                 # f64[n]
    klass: np.ndarray                     # i32[n]
    classes: tuple = ("default",)
    slo: np.ndarray = None                # f64[K] per-class SLO (or None)
    cols: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        n = len(self.arrival_t)
        for name, arr in [("service_s", self.service_s),
                          ("klass", self.klass)] + list(self.cols.items()):
            if len(arr) != n:
                raise ValueError(f"column {name!r} has {len(arr)} rows, "
                                 f"trace has {n}")

    def __len__(self):
        return len(self.arrival_t)

    def rows(self):
        """Iterate (arrival_t, service_s, klass, cols-dict) per request."""
        for i in range(len(self)):
            yield (float(self.arrival_t[i]), float(self.service_s[i]),
                   int(self.klass[i]),
                   {k: v[i] for k, v in self.cols.items()})


def generate(arrival: ArrivalSpec, service, duration: float, seed: int,
             *, classes=None, cols=None) -> Trace:
    """Materialize a workload trace (deterministic per arguments).

    ``service`` is one :class:`ServiceSpec`; ``cols`` maps column names to
    callables ``f(n, seed) -> array`` (e.g. :func:`request_columns`)."""
    if classes is not None:
        raise NotImplementedError(
            "multi-class traces (classes=) need workloads/clients.py, "
            "which is not ported to repro_torch yet")
    t = arrival_times(arrival, duration, seed)
    n = len(t)
    meta = {"version": FORMAT_VERSION, "seed": int(seed),
            "duration": float(duration),
            "arrival": dataclasses.asdict(arrival),
            "services": [dataclasses.asdict(service)]}
    trace = Trace(t, service_times(service, n, seed), np.zeros(n, np.int32))
    trace.meta = meta
    for name, fn in (cols or {}).items():
        trace.cols[name] = np.asarray(fn(n, seed))
    return trace


def request_columns(prompt_lens, new_tokens):
    """Standard serving-engine columns (counter-based choices)."""
    return {
        "prompt_len": lambda n, seed: choice(
            prompt_lens, n, seed, stream=STREAM_COLS_PROMPT),
        "new_tokens": lambda n, seed: choice(
            new_tokens, n, seed, stream=STREAM_COLS_TOKENS),
    }
