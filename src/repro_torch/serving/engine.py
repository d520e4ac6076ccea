"""Continuous-batching serving engine with pluggable admission scheduling.

The engine runs a loop of *engine slots* (the paper's critical sections):
each slot executes either one batched **decode** micro-step (one token for
every running sequence — short, throughput-dense: the "big core" class) or
one **prefill chunk** (long, latency-elastic: the "little core" class).
Which one runs is the scheduler's lock ordering:

* ``fifo``    — arrival order (MCS): a long prefill head-of-line blocks all
  running decodes => inter-token latency + token throughput collapse.
* ``greedy``  — decode-first always (TAS big-affinity): TTFT collapse /
  prefill starvation under load.
* ``asl``     — the paper: decode admits immediately; prefill chunks are
  standby competitors with an AIMD reorder window tuned against the
  request TTFT SLO (epoch = submit -> first token).

The engine advances a virtual clock by a cost model's slot durations;
``repro_torch.launch.serve`` calibrates that cost model from real
prefill / decode steps of a model on the card.  A copy of the JAX
package's numpy-only ``repro/serving/engine.py`` over the port's
schedulers and workload generators: the same trace and cost model give
the same metrics.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import defaultdict

import numpy as np

from repro_torch.core import stats
from repro_torch.core.asl_schedule import SCHEDULERS


@dataclasses.dataclass
class Request:
    rid: int
    arrival_t: float
    prompt_len: int
    max_new_tokens: int
    slo_ttft: float                 # epoch SLO (submit -> first token)
    epoch_id: int = 0               # SLO class
    # lifecycle
    prefill_done: int = 0
    generated: int = 0
    first_token_t: float | None = None
    finish_t: float | None = None
    # resilience lifecycle (engine timeout/retry/admission — all inert
    # unless the engine was built with the chaos kwargs)
    deadline_t: float = float("inf")
    retries: int = 0
    dropped: bool = False
    timed_out: bool = False


@dataclasses.dataclass
class CostModel:
    """Slot durations (seconds). Calibrated per arch from the roofline
    terms (memory-bound decode, compute-bound prefill)."""

    decode_step_s: float = 2e-3         # one token for the whole batch
    prefill_chunk_s: float = 12e-3      # one chunk of prefill_chunk tokens
    prefill_chunk: int = 2048
    max_batch: int = 64


class ServingEngine:
    """``timeout_s`` / ``max_retries`` / ``backoff_base_s`` /
    ``backoff_cap_s`` / ``admit_limit`` are the resilience knobs
    (docs/faults.md §Serving): a request whose TTFT deadline
    (arrival + timeout_s) passes before its first token is cancelled at
    dequeue and retried after a capped exponential backoff (restarting
    its prefill), up to ``max_retries`` times; ``admit_limit`` is
    admission control — arrivals are shed outright while more than that
    many requests are pending + running (load past saturation).  All
    default off, in which case behavior is bit-identical to the
    pre-chaos engine."""

    def __init__(self, scheduler: str = "asl", cost: CostModel = None,
                 *, scheduler_kwargs: dict = None, seed: int = 0,
                 timeout_s: float = None, max_retries: int = 0,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0,
                 admit_limit: int = None):
        self.cost = cost or CostModel()
        self.clock = 0.0
        kw = dict(scheduler_kwargs or {})
        # Scheduler names come from the lock-policy registry (each
        # LockPolicy's host_scheduler — repro_torch.core.asl_schedule).
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; "
                             f"registered: {sorted(SCHEDULERS)}")
        self.sched = SCHEDULERS[scheduler](clock=lambda: self.clock, **kw)
        self.sched_name = scheduler
        self.running: list[Request] = []      # decode set
        self.done: list[Request] = []
        self.itl_samples: list[float] = []    # inter-token gaps (decode)
        self._last_decode_t: float | None = None
        self._rid = itertools.count()
        # Resilience knobs + per-class (epoch_id) fault counters.
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.admit_limit = admit_limit
        self.timeouts: dict[int, int] = defaultdict(int)
        self.retry_counts: dict[int, int] = defaultdict(int)
        self.drops: dict[int, int] = defaultdict(int)
        self.shed: list[Request] = []         # admission-dropped
        self.expired: list[Request] = []      # timed out, retries spent
        self._retry_q: list = []              # (due_t, seq, Request)
        self._retry_seq = itertools.count()
        # ``seed`` is kept for API compatibility; all workload randomness
        # now lives in repro_torch.workloads (counter-based, engine-independent).
        del seed

    # ------------------------------------------------------------------
    def submit(self, prompt_len: int, max_new_tokens: int, slo_ttft: float,
               epoch_id: int = 0, arrival_t: float = None) -> Request:
        r = Request(next(self._rid),
                    self.clock if arrival_t is None else arrival_t,
                    prompt_len, max_new_tokens, slo_ttft, epoch_id)
        if self.admit_limit is not None and \
                self.sched.pending() + len(self.running) >= self.admit_limit:
            # Admission control: past saturation, shedding at arrival
            # keeps the queue (and every admitted request's wait) bounded.
            r.dropped = True
            self.drops[epoch_id] += 1
            self.shed.append(r)
            return r
        if self.timeout_s is not None:
            r.deadline_t = r.arrival_t + self.timeout_s
        self.sched.submit(r, klass="little", epoch_id=epoch_id)
        return r

    # -- resilience helpers --------------------------------------------
    def retry_pending(self) -> int:
        """Requests waiting out a retry backoff (drivers must not skip
        the clock past them when the queue is otherwise empty)."""
        return len(self._retry_q)

    def _release_retries(self):
        while self._retry_q and self._retry_q[0][0] <= self.clock:
            _, _, r = heapq.heappop(self._retry_q)
            r.deadline_t = self.clock + self.timeout_s
            self.sched.submit(r, klass="little", epoch_id=r.epoch_id)

    def _expired(self, r: Request) -> bool:
        return self.timeout_s is not None and r.first_token_t is None \
            and self.clock > r.deadline_t

    def _on_timeout(self, r: Request):
        self.timeouts[r.epoch_id] += 1
        if r.retries < self.max_retries:
            r.retries += 1
            self.retry_counts[r.epoch_id] += 1
            backoff = min(self.backoff_base_s * 2 ** (r.retries - 1),
                          self.backoff_cap_s)
            r.prefill_done = 0        # a retried request restarts prefill
            heapq.heappush(self._retry_q,
                           (self.clock + backoff, next(self._retry_seq), r))
        else:
            r.timed_out = True
            self.expired.append(r)

    def _admit_decode_slot(self):
        """Decode work is 'big': register one slot-claim per loop if any
        sequence is running (lock_immediately)."""
        if self.running:
            self.sched.submit(None, klass="big")

    # ------------------------------------------------------------------
    def step(self) -> str:
        """Run one engine slot; returns what ran ('decode'/'prefill'/'idle')."""
        if self._retry_q:
            self._release_retries()
        self._admit_decode_slot()
        item = self.sched.next_item()
        # Timeout detection happens at dequeue (the scheduler is a
        # pluggable black box): expired prefill work is cancelled and
        # handed to the retry/expire path, and the slot goes to the next
        # item — the engine never burns a slot on a dead request.
        while item is not None and item.klass == "little" \
                and self._expired(item.payload):
            self._on_timeout(item.payload)
            item = self.sched.next_item()
        if item is None:
            if self._retry_q:
                # Nothing runnable until the next backoff elapses.
                self.clock = max(self.clock, self._retry_q[0][0])
                self._release_retries()
            else:
                self.clock += 1e-4
            return "idle"

        if item.klass == "big":
            self._run_decode()
            return "decode"
        self._run_prefill_chunk(item.payload)
        return "prefill"

    def _run_decode(self):
        if self._last_decode_t is not None and self.running:
            self.itl_samples.append(self.clock - self._last_decode_t)
        self.clock += self.cost.decode_step_s
        self._last_decode_t = self.clock
        # One pass: partition finished/still-running in place (the old
        # copy + .remove() pattern was O(batch^2) per decode step).
        still: list[Request] = []
        for r in self.running:
            r.generated += 1
            if r.first_token_t is None:
                r.first_token_t = self.clock
                self.sched.observe_epoch(
                    r.epoch_id, self.clock - r.arrival_t, r.slo_ttft)
            if r.generated >= r.max_new_tokens:
                r.finish_t = self.clock
                self.done.append(r)
            else:
                still.append(r)
        self.running = still

    def _run_prefill_chunk(self, r: Request):
        self.clock += self.cost.prefill_chunk_s
        r.prefill_done += self.cost.prefill_chunk
        if r.prefill_done >= r.prompt_len:
            if len(self.running) < self.cost.max_batch:
                self.running.append(r)
            else:
                # batch full: decode capacity is the bottleneck; requeue the
                # *admission to the decode set* as immediate work.
                self.running.append(r)   # simple model: allow overfill
        else:
            # Re-submit the remaining chunks.  Paper semantics: an epoch may
            # contain many lock acquisitions, each taking the epoch's
            # *current* reorder window (Algorithm 3 line 7-8) — so every
            # chunk is a fresh lock_reorder with the AIMD-tuned window.
            self.sched.submit(r, klass="little", epoch_id=r.epoch_id)

    # ------------------------------------------------------------------
    def run(self, until_t: float = None, until_done: int = None,
            max_slots: int = 2_000_000):
        for _ in range(max_slots):
            if until_t is not None and self.clock >= until_t:
                break
            if until_done is not None and len(self.done) >= until_done:
                break
            if self.step() == "idle" and not self.sched.pending() \
                    and not self.running and until_done is not None:
                break
        return self

    # ------------------------------------------------------------------
    def _fault_counters(self) -> dict:
        return {
            "timeouts": dict(self.timeouts),
            "retries": dict(self.retry_counts),
            "drops": dict(self.drops),
            "timeouts_total": sum(self.timeouts.values()),
            "retries_total": sum(self.retry_counts.values()),
            "drops_total": sum(self.drops.values()),
        }

    def metrics(self, warmup_frac: float = 0.1) -> dict:
        reqs = [r for r in self.done if r.first_token_t is not None]
        reqs = reqs[int(len(reqs) * warmup_frac):]
        if not reqs:
            return {"n": 0, **self._fault_counters()}
        ttft = np.array([r.first_token_t - r.arrival_t for r in reqs])
        e2e = np.array([r.finish_t - r.arrival_t for r in reqs])
        toks = sum(r.generated for r in reqs)
        span = max(r.finish_t for r in reqs) - min(r.arrival_t for r in reqs)
        viol = np.mean([t > r.slo_ttft for t, r in zip(ttft, reqs)])
        # No ITL samples (e.g. every request shed before a second token)
        # -> nan percentiles below, not the old 0.0 sentinel.
        itl = np.array(self.itl_samples[int(len(self.itl_samples)
                                            * warmup_frac):], float)
        # Goodput: completions that met their TTFT SLO — shed, expired
        # and SLO-late requests all count against it (the chaos figures'
        # useful-work-per-second metric).
        good = [r for t, r in zip(ttft, reqs) if t <= r.slo_ttft]
        offered = len(reqs) + len(self.shed) + len(self.expired)
        return {
            "n": len(reqs),
            "throughput_tok_s": toks / max(span, 1e-9),
            "ttft_p50": stats.percentile(ttft, 50),
            "ttft_p99": stats.percentile(ttft, 99),
            "e2e_p99": stats.percentile(e2e, 99),
            "itl_p50": stats.percentile(itl, 50),
            "itl_p99": stats.percentile(itl, 99),
            "slo_violation_rate": float(viol),
            "goodput_req_s": len(good) / max(span, 1e-9),
            "goodput_tok_s": sum(r.generated for r in good)
            / max(span, 1e-9),
            "goodput_frac": len(good) / max(offered, 1),
            **self._fault_counters(),
        }


def replay_workload(engine: ServingEngine, trace, *, slo_ttft: float = None,
                    duration_s: float = None):
    """Drive the engine from a ``repro_torch.workloads.traces.Trace`` —
    deterministic: the same trace always produces the same run.

    Request shape comes from the trace's ``prompt_len``/``new_tokens``
    columns; class ids become scheduler ``epoch_id``s and per-class SLOs
    (``trace.slo``) the TTFT SLOs (``slo_ttft`` overrides for
    single-class traces).  ``trace.service_s`` is NOT consumed here —
    engine timing comes from the CostModel and the shape columns (the
    dispatch sim is the consumer that replays service times)."""
    if duration_s is None:
        duration_s = float(trace.meta.get(
            "duration", trace.arrival_t[-1] if len(trace) else 0.0))
    pl = trace.cols["prompt_len"]
    nt = trace.cols["new_tokens"]
    slos = trace.slo
    ai = 0
    n = len(trace)
    while engine.clock < duration_s:
        while ai < n and trace.arrival_t[ai] <= engine.clock:
            k = int(trace.klass[ai])
            slo = slo_ttft if slo_ttft is not None else (
                float(slos[k]) if slos is not None else float("inf"))
            engine.submit(int(pl[ai]), int(nt[ai]), slo, epoch_id=k,
                          arrival_t=float(trace.arrival_t[ai]))
            ai += 1
        if ai < n and not engine.sched.pending() and not engine.running \
                and not engine.retry_pending():
            engine.clock = float(trace.arrival_t[ai])  # skip idle gaps
            continue
        engine.step()
    return engine


def poisson_workload(engine: ServingEngine, *, rate_rps: float,
                     duration_s: float, prompt_lens, new_tokens,
                     slo_ttft: float, seed: int = 0, trace=None):
    """Drive the engine with an open-loop Poisson arrival process.

    The workload is materialized as a ``repro_torch.workloads`` trace
    (counter-based draws — deterministic per seed) and replayed; pass
    ``trace`` to replay a recorded one instead."""
    from repro_torch.workloads import traces as wl_traces
    from repro_torch.workloads.generators import ArrivalSpec, ServiceSpec
    if trace is None:
        trace = wl_traces.generate(
            ArrivalSpec("poisson", rate_rps), ServiceSpec(), duration_s,
            seed, cols=wl_traces.request_columns(prompt_lens, new_tokens))
    return replay_workload(engine, trace, slo_ttft=slo_ttft,
                           duration_s=duration_s)


def closed_loop_workload(engine: ServingEngine, *, n_clients: int,
                         think_s: float, duration_s: float, prompt_lens,
                         new_tokens, slo_ttft: float, seed: int = 0):
    """Closed-loop driver: each of ``n_clients`` resubmits one request an
    Exp(``think_s``) think time after its previous one *finishes* (load
    self-throttles with congestion, unlike the open-loop Poisson driver).
    Think draws are counter-based per (client, request index)."""
    from repro_torch.workloads.generators import choice, client_think_gaps
    cap = max(int(duration_s / max(think_s, 1e-6) * 2) + 16, 64)
    gaps = [client_think_gaps(seed, c, cap) * think_s
            for c in range(n_clients)]
    pls = choice(prompt_lens, n_clients * cap, seed)
    nts = choice(new_tokens, n_clients * cap, seed + 1)
    next_t = [float(gaps[c][0]) for c in range(n_clients)]
    n_sub = [1] * n_clients                   # next gap index per client
    subs = [0] * n_clients                    # submissions per client
    inflight: dict[int, int] = {}             # rid -> client
    done_seen = 0
    while engine.clock < duration_s:
        for c in range(n_clients):
            if next_t[c] <= engine.clock:
                # Shape draws are indexed per (client, submission) — a
                # global counter would make the workload depend on
                # completion interleaving (i.e. on the policy under
                # test), breaking the identical-workload discipline.
                i = c * cap + subs[c]
                r = engine.submit(int(pls[i % len(pls)]),
                                  int(nts[i % len(nts)]), slo_ttft,
                                  arrival_t=next_t[c])
                subs[c] += 1
                inflight[r.rid] = c
                next_t[c] = float("inf")
        if not engine.sched.pending() and not engine.running \
                and not engine.retry_pending():
            t_min = min((t for t in next_t if t < float("inf")),
                        default=None)
            if t_min is None or t_min >= duration_s:
                break
            engine.clock = max(engine.clock, t_min)
            continue
        engine.step()
        while done_seen < len(engine.done):
            r = engine.done[done_seen]
            done_seen += 1
            c = inflight.pop(r.rid, None)
            if c is not None and n_sub[c] < cap:
                next_t[c] = r.finish_t + float(gaps[c][n_sub[c]])
                n_sub[c] += 1
    return engine
