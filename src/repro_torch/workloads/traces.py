"""Workload traces: the materialized form of a workload.

A :class:`Trace` holds sorted arrival times, per-request service times, a
class id per request and aligned extra columns (the serving engine stores
``prompt_len`` / ``new_tokens`` here).  Every draw is counter-based
(:mod:`repro_torch.workloads.generators`), so :func:`generate` is a pure
function of its specs and seed and equals the JAX package's
``repro/workloads/traces.py::generate`` for the same arguments.

File format (:func:`save` / :func:`load`, the JAX package's): a single
``.npz`` with the three core arrays, the per-class SLOs, one
``col_<name>`` array per extra column, and a json-encoded ``meta`` blob
(class names, generating specs, format version).  No pickling: a trace
saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from repro_torch.workloads.generators import (STREAM_CLASS, STREAM_SERVICE,
                                              ArrivalSpec,
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

    ``service`` is one :class:`ServiceSpec`, or — with ``classes`` a
    :class:`repro_torch.workloads.clients.WorkloadMix` — ignored in favor
    of the per-class specs.  ``cols`` maps column names to callables
    ``f(n, seed) -> array`` (e.g. :func:`request_columns`)."""
    t = arrival_times(arrival, duration, seed)
    n = len(t)
    meta = {"version": FORMAT_VERSION, "seed": int(seed),
            "duration": float(duration),
            "arrival": dataclasses.asdict(arrival)}
    if classes is not None:
        kl = classes.class_ids(n, seed)
        per = np.zeros(n)
        for k, cls in enumerate(classes.classes):
            # Per-class service stream: a high-nibble offset that cannot
            # collide with any STREAM_* constant (0x778x block).
            svc = service_times(cls.service, n, seed,
                                stream=STREAM_SERVICE ^ (0x1000 * (k + 1)))
            per = np.where(kl == k, svc, per)
        names = tuple(c.name for c in classes.classes)
        slo = np.asarray([c.slo for c in classes.classes], np.float64)
        meta["services"] = [dataclasses.asdict(c.service)
                            for c in classes.classes]
        trace = Trace(t, per, kl.astype(np.int32), names, slo)
    else:
        meta["services"] = [dataclasses.asdict(service)]
        trace = Trace(t, service_times(service, n, seed),
                      np.zeros(n, np.int32))
    trace.meta = meta
    for name, fn in (cols or {}).items():
        trace.cols[name] = np.asarray(fn(n, seed))
    return trace


def save(path, trace: Trace) -> Path:
    """Write one npz (arrays + json meta); returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = dict(trace.meta, version=FORMAT_VERSION,
                classes=list(trace.classes))
    arrays = {"arrival_t": trace.arrival_t, "service_s": trace.service_s,
              "klass": trace.klass,
              "meta": np.frombuffer(
                  json.dumps(meta, sort_keys=True).encode(), np.uint8)}
    if trace.slo is not None:
        arrays["slo"] = np.asarray(trace.slo, np.float64)
    for name, arr in trace.cols.items():
        arrays[f"col_{name}"] = np.asarray(arr)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def load(path) -> Trace:
    """Read a trace :func:`save` (of either package) wrote."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta.get("version", 0) > FORMAT_VERSION:
            raise ValueError(f"trace {path} has format version "
                             f"{meta['version']} > {FORMAT_VERSION}")
        cols = {k[len("col_"):]: z[k] for k in z.files
                if k.startswith("col_")}
        return Trace(z["arrival_t"], z["service_s"], z["klass"],
                     tuple(meta.pop("classes", ("default",))),
                     z["slo"] if "slo" in z.files else None, cols, meta)


def request_columns(prompt_lens, new_tokens):
    """Standard serving-engine columns (counter-based choices)."""
    return {
        "prompt_len": lambda n, seed: choice(
            prompt_lens, n, seed, stream=STREAM_COLS_PROMPT),
        "new_tokens": lambda n, seed: choice(
            new_tokens, n, seed, stream=STREAM_COLS_TOKENS),
    }
