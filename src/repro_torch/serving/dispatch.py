"""Heterogeneous-replica dispatch: the paper's big/little cores at
serving-fleet scale, ported from the JAX package's
``repro/serving/dispatch.py`` (host-side numpy; no tensor work).

A fleet mixes fast replicas ("big cores") and slow ones ("little
cores"), and every request needs one replica slot: the replica pool is
the lock.

* ``fair``: round-robin over replicas (the MCS analogue): slow-replica
  service time lands on the critical path of 1/k of requests, and fleet
  throughput collapses (Implication 1).
* ``fast-only``: never dispatch to slow replicas; the queue blows up
  once the fast replicas saturate (the paper's "only big cores"
  strawman).
* ``asl``: requests stand by for a fast replica during an AIMD reorder
  window tuned against the request latency SLO; when the window expires
  (fast replicas busy and the SLO at risk) they take a slow replica.

Key-aware variants (the ``ks_*`` lock policies' fleet analogues): every
request carries a Zipf-drawn key bucketed to ``bucket = key % n_buckets``;
the *owner* replica of a bucket is ``fleet[bucket % n_replicas]`` with the
fleet ordered fast-first, so hot buckets (low ids) are owned by fast
replicas.

* ``key-erew``: a request is served ONLY by its bucket's owner.
* ``key-crew``: reads go to any free replica (fast preferred), writes
  are owner-exclusive.
* ``key-jbsq``: the FIFO head goes to the least-loaded free replica
  (fewest dispatches), ignoring ownership.

The key and write streams are counter-pure (``STREAM_KEY`` /
``STREAM_RW`` blocks, prefix-invariant in the arrival count) and drawn
only for key-aware policies.  The keys go through
:func:`repro_torch.workloads.keys.zipf_key` rounded op by op
(``fused=False``), as the reference draws them eagerly; every value the
run returns is the JAX package's, bit for bit.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

import torch

from repro_torch.core import stats
from repro_torch.core.aimd import AIMDWindow, unit_for
from repro_torch.core.policies import dispatch_names
from repro_torch.faults import host as flt_host
from repro_torch.faults.model import FaultSpec
from repro_torch.workloads import keys as wl_keys
from repro_torch.workloads import traces as wl_traces
from repro_torch.workloads.generators import (LEGACY_LOGNORMAL_CV,
                                        LEGACY_LOGNORMAL_MEAN, STREAM_KEY,
                                        STREAM_RW, ArrivalSpec, ServiceSpec,
                                        uniform_block)

# Fleet-dispatch policy names, keyed off the lock-policy registry (each
# LockPolicy's host_dispatch: fifo -> "fair" round-robin, tas
# big-affinity -> "fast-only", libasl -> "asl" window spill).
DISPATCH_POLICIES = dispatch_names()


@dataclasses.dataclass
class Replica:
    speed: float          # service-time multiplier (1.0 = fast)
    busy_until: float = 0.0
    idx: int = 0          # fleet-wide index (fault-stream namespace)
    served: int = 0       # dispatches so far (fault-draw counter)


def spill_index(queue, clock):
    """Which queued request an ASL spill hands to a free slow replica:
    the earliest-*deadline* expired standby (paper §3.2 — reorder-window
    expiry order, not FIFO arrival order), or None when no window has
    expired yet.  ``queue`` holds ``(arrival_t, service_s, win_deadline,
    timeout_deadline, tries)`` rows (the last two are the resilience
    columns; the window deadline is still ``row[2]``)."""
    expired = [(row[2], i) for i, row in enumerate(queue)
               if clock >= row[2]]
    return min(expired)[1] if expired else None


def simulate_dispatch(policy: str, *, n_fast=4, n_slow=4, slow_factor=3.0,
                      rate_rps=30.0, service_s=0.1, duration_s=300.0,
                      slo=None, pct=99.0, seed=0,
                      default_window=0.02, max_window=30.0,
                      arrival: ArrivalSpec = None,
                      service: ServiceSpec = None, trace=None,
                      timeout_s=None, max_retries=0,
                      backoff_base=0.05, backoff_cap=2.0,
                      admit_cap=None, faults: FaultSpec = None,
                      n_buckets=64, n_keys=1024, zipf_theta=0.99,
                      write_frac=0.5):
    """Event-driven M/G/k with heterogeneous servers; returns metrics.

    ASL: a queued request may wait (stand by) for a fast replica until its
    window expires, then accepts any replica.  Feedback: AIMD on completed
    request latency vs SLO (one shared epoch class).

    The workload comes from ``repro_torch.workloads``: pass a recorded
    ``trace`` to replay it exactly, or ``arrival``/``service`` specs to
    generate one (default: open-loop Poisson arrivals + the legacy
    lognormal service shape) — deterministic per ``seed``.

    Resilience and chaos (all off by default, in which case no fault
    schedule is drawn):

    * ``timeout_s`` — a request still queued ``timeout_s`` after arrival
      is cancelled; with retries left it re-enqueues after a capped
      exponential backoff (``backoff_base * 2**tries``, cap
      ``backoff_cap``), keeping its original arrival time so measured
      latency includes every backoff.
    * ``admit_cap`` — admission control: arrivals are shed while the
      queue holds that many requests.
    * ``faults`` — a :class:`repro_torch.faults.FaultSpec`: replica outages
      (churn: a replica accepts no new work during "off" slots),
      straggler service spikes, and preemption stalls, all counter-pure
      per (replica, dispatch index) via ``repro_torch.faults.host``.

    Key-aware policies (``key-erew``/``key-crew``/``key-jbsq``) draw a
    Zipf(``n_keys``, ``zipf_theta``) key and a read/write bit per
    request (``write_frac`` = write probability) and bucket keys to
    ``key % n_buckets``; other policies never draw the streams (their
    runs are bit-identical with the knobs at any value).
    """
    if policy not in DISPATCH_POLICIES:
        raise ValueError(f"unknown dispatch policy {policy!r}; "
                         f"registered: {DISPATCH_POLICIES}")
    if trace is None:
        trace = wl_traces.generate(
            arrival or ArrivalSpec("poisson", rate_rps),
            service or ServiceSpec("lognormal",
                                   mean=service_s * LEGACY_LOGNORMAL_MEAN,
                                   cv=LEGACY_LOGNORMAL_CV),
            duration_s, seed)
    fast = [Replica(1.0, idx=i) for i in range(n_fast)]
    slow = [Replica(slow_factor, idx=n_fast + i) for i in range(n_slow)]
    fleet = fast + slow            # fast-first: hot buckets own fast
    n_rep = len(fleet)
    win = AIMDWindow(window=default_window,
                     unit=unit_for(default_window, pct), pct=pct,
                     max_window=max_window)
    arrivals = list(zip(trace.arrival_t.tolist(),
                        trace.service_s.tolist()))
    keyed = policy.startswith("key-")
    if keyed and arrivals:
        # Counter-pure key + read/write streams, prefix-invariant in the
        # arrival count — the device engine's epoch-draw composition
        # (uniform -> Zipf rank -> bucket) at fleet scale.
        n_arr = len(arrivals)
        th, ze, et, al = wl_keys.zipf_consts(max(int(n_keys), 1),
                                             zipf_theta)
        u = torch.from_numpy(
            uniform_block(seed, STREAM_KEY, n_arr).astype(np.float32))
        ranks = wl_keys.zipf_key(u, n_keys, th, ze, et, al,
                                 fused=False).numpy()
        bks = (ranks % max(int(n_buckets), 1)).tolist()
        wrs = (uniform_block(seed, STREAM_RW, n_arr)
               < write_frac).tolist()
    else:
        bks = [0] * len(arrivals)
        wrs = [False] * len(arrivals)
    arrivals = [(t, s, b, w)
                for (t, s), b, w in zip(arrivals, bks, wrs)]

    chaos_faults = faults if faults is not None and faults.active else None
    if chaos_faults is not None:
        # Precomputed counter-pure schedules (repro_torch.faults.host): per-
        # (replica, slot) outages; per-(replica, dispatch) spike/stall.
        out_mask = flt_host.outage_mask(chaos_faults, n_rep,
                                        duration_s * 4 + 60.0, seed)
        cap_disp = len(arrivals) * (1 + max_retries) + 64
        spikes = [flt_host.spike_hits(chaos_faults, r, cap_disp, seed)
                  for r in range(n_rep)]
        stalls = [flt_host.preempt_stalls(chaos_faults, r, cap_disp, seed)
                  for r in range(n_rep)]

    def rep_out(r, now):
        if chaos_faults is None or chaos_faults.churn_rate <= 0.0:
            return False
        k = min(int(now / chaos_faults.churn_period),
                out_mask.shape[1] - 1)
        return bool(out_mask[r.idx, k])

    lat = []
    served_fast = served_slow = 0
    timeouts = retried = drops = lost = 0
    queue = []    # (arrival_t, svc, win_dead, timeout_dead, tries,
    #               bucket, write) — the last two are the key columns
    #               (0/False for non-key policies)
    events = []         # completion heap
    retry_q = []        # (due_t, seq, arrival_t, svc, tries, bucket, wr)
    seq = 0
    clock = 0.0
    ai = 0
    hard_stop = 10.0 * duration_s + 60.0   # churn_rate=1 can strand work

    def free_replica(pool, now):
        for r in pool:
            if r.busy_until <= now and not rep_out(r, now):
                return r
        return None

    while ai < len(arrivals) or queue or events or retry_q:
        # next event time: arrival, completion, retry release; an ASL
        # window deadline is only an event if a slow replica is free to
        # accept the spill; a queued timeout and (under churn) the next
        # outage-slot boundary are events too.
        t_arr = arrivals[ai][0] if ai < len(arrivals) else np.inf
        t_done = events[0] if events else np.inf
        t_retry = retry_q[0][0] if retry_q else np.inf
        t_next = min(t_arr, t_done, t_retry)
        if policy == "asl" and queue and \
                free_replica(slow, clock) is not None:
            t_dead = min(row[2] for row in queue)
            t_next = min(t_next, max(t_dead, clock))
        if timeout_s is not None and queue:
            t_to = min(row[3] for row in queue)
            t_next = min(t_next, max(t_to, clock))
        if chaos_faults is not None and chaos_faults.churn_rate > 0.0 \
                and queue:
            k = int(clock / chaos_faults.churn_period)
            t_next = min(t_next, (k + 1) * chaos_faults.churn_period)
        if t_next == np.inf:
            break
        clock = max(clock, t_next)
        if clock > hard_stop:
            break
        while events and events[0] <= clock:
            heapq.heappop(events)
        while retry_q and retry_q[0][0] <= clock:
            _, _, a0, svc, tries, bk, wr = heapq.heappop(retry_q)
            queue.append((a0, svc, clock + win.window,
                          clock + timeout_s, tries, bk, wr))
        while ai < len(arrivals) and arrivals[ai][0] <= clock:
            a, svc, bk, wr = arrivals[ai]
            ai += 1
            if admit_cap is not None and len(queue) >= admit_cap:
                drops += 1           # admission control: shed at arrival
                continue
            queue.append((a, svc, a + win.window,
                          (a + timeout_s) if timeout_s is not None
                          else np.inf, 0, bk, wr))
        if timeout_s is not None:
            # Timeout detection: cancel expired queue entries; with
            # retries left they re-arrive after a capped exp backoff.
            keep = []
            for row in queue:
                if clock >= row[3]:
                    timeouts += 1
                    if row[4] < max_retries:
                        retried += 1
                        backoff = min(backoff_base * 2 ** row[4],
                                      backoff_cap)
                        seq += 1
                        heapq.heappush(retry_q,
                                       (clock + backoff, seq, row[0],
                                        row[1], row[4] + 1, row[5],
                                        row[6]))
                    else:
                        lost += 1
                else:
                    keep.append(row)
            queue = keep
        # dispatch loop
        progressed = True
        while queue and progressed:
            progressed = False
            rf = free_replica(fast, clock)
            rs = free_replica(slow, clock)
            target = None
            pick = 0
            if policy == "fair":
                # round-robin: earliest-free replica of either kind
                cands = [r for r in fast + slow
                         if r.busy_until <= clock and not rep_out(r, clock)]
                if cands:
                    target = cands[(served_fast + served_slow)
                                   % len(cands)]
            elif policy == "fast-only":
                target = rf
            elif policy == "key-erew":
                # Strict EREW sharding: the earliest queued request
                # whose bucket-owner replica is free dispatches to it;
                # everyone else waits for their owner.
                for i, row in enumerate(queue):
                    r = fleet[row[5] % n_rep]
                    if r.busy_until <= clock and not rep_out(r, clock):
                        pick, target = i, r
                        break
            elif policy == "key-crew":
                # CREW: reads take any free replica (fast preferred);
                # writes are owner-exclusive.
                for i, row in enumerate(queue):
                    if row[6]:
                        r = fleet[row[5] % n_rep]
                        if r.busy_until <= clock \
                                and not rep_out(r, clock):
                            pick, target = i, r
                            break
                    elif rf is not None or rs is not None:
                        pick = i
                        target = rf if rf is not None else rs
                        break
            elif policy == "key-jbsq":
                # JBSQ-style: the FIFO head joins the least-loaded
                # free replica (fewest dispatches), ownership-blind —
                # the fairness-first contrast to key-erew.
                cands = [r for r in fleet if r.busy_until <= clock
                         and not rep_out(r, clock)]
                if cands:
                    target = min(cands,
                                 key=lambda r: (r.served, r.idx))
            else:  # asl
                if rf is not None:
                    target = rf    # fast replica: FIFO head takes it
                elif rs is not None:
                    i = spill_index(queue, clock)
                    if i is not None:
                        pick = i
                        target = rs
            if target is not None:
                a, svc, dead, to_dead, tries, bk, wr = queue[pick]
                queue.pop(pick)
                dur = svc * target.speed
                if chaos_faults is not None:
                    # Straggle spike first, preemption stall on top —
                    # the device sim's grant() composition order.
                    d_ix = min(target.served, cap_disp - 1)
                    if spikes[target.idx][d_ix]:
                        dur *= chaos_faults.straggle_scale
                    dur += stalls[target.idx][d_ix]
                target.served += 1
                target.busy_until = clock + dur
                heapq.heappush(events, clock + dur)
                latency = clock + dur - a
                lat.append(latency)
                if slo is not None and policy == "asl":
                    win.update(latency, slo)
                if target.speed == 1.0:
                    served_fast += 1
                else:
                    served_slow += 1
                progressed = True

    # Throughput counts every completion; the latency sample alone drops a
    # 5% warmup prefix (counting after the trim undercounted throughput by
    # exactly that warmup fraction).
    completed = len(lat)
    full_lat = lat
    # Zero completions -> nan percentiles (repro_torch.core.stats).
    lat = np.array(lat[int(0.05 * len(lat)):], float)
    good = int(np.sum(np.asarray(full_lat) <= slo)) \
        if slo is not None else None
    return {
        "policy": policy,
        "n": len(lat),
        "completed": completed,
        "throughput_rps": completed / max(clock, 1e-9),
        "p50": stats.percentile(lat, 50),
        "p99": stats.percentile(lat, 99),
        "served_fast": served_fast,
        "served_slow": served_slow,
        "final_window": win.window,
        "slo_violation": (float(np.mean(lat > slo)) if lat.size
                          else float("nan")) if slo else None,
        # resilience counters + goodput (SLO-met completions per second)
        "timeouts": timeouts,
        "retries": retried,
        "drops": drops,
        "lost": lost,
        "goodput_rps": float(good / max(clock, 1e-9))
        if good is not None else None,
    }
