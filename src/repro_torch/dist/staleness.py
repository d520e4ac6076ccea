"""Bounded-staleness gradient commits — the paper's lock ordering applied
to data-parallel training.

Mapping (DESIGN.md §3, ROADMAP straggler direction): the serialized commit
of a gradient into the global parameters is the critical section; a pod
that has stepped ahead of the slowest pod is a "little core" whose commit
may be *reordered* (delayed) — but only within a bounded window, so the
slowest pod is never starved and gradient staleness stays bounded
(starvation-freedom <-> bounded quality loss).

* ``window_steps == 0``  -> fully synchronous (lockstep rounds).
* ``window_steps == inf``-> unbounded async.
* in between             -> a pod may run ahead by ``< window`` steps; the
  window itself is AIMD-tuned against a *quality SLO* (staleness penalty
  plays the role of the paper's epoch latency) and capped by
  ``max_window`` (the 100 ms bound analogue -> hard staleness guarantee).

The port's own copy of the JAX package's ``repro/dist/staleness.py`` (it imports
nothing of that package); its behaviour is the reference's.
"""

from __future__ import annotations

import threading

import numpy as np

from repro_torch.core import stats
from repro_torch.core.aimd import AIMDWindow, unit_for
from repro_torch.workloads.generators import straggle_uniforms


class BoundedStalenessController:
    """Decides whether pod ``p`` may start (and then commit) its next step.

    ``can_commit(p)`` is true iff p is not ahead of the slowest pod at all,
    or ahead by strictly less than the current window — so after the commit
    its lead is at most ``window`` (<= ``max_window``): a hard staleness
    bound, the analogue of the paper's maximum reorder window.
    """

    def __init__(self, n_pods: int, *, window_steps: float = 0.0,
                 max_window: float = None, pct: float = 99.0):
        self.n_pods = n_pods
        if max_window is None:
            max_window = window_steps
        self.max_window = float(max_window)
        self._aimd = AIMDWindow(
            window=float(window_steps),
            unit=unit_for(float(window_steps), pct),
            pct=pct, max_window=self.max_window)
        self.steps = [0] * n_pods
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    @property
    def window(self) -> float:
        return self._aimd.window

    def can_commit(self, pod: int) -> bool:
        with self._lock:
            ahead = self.steps[pod] - min(self.steps)
            return ahead == 0 or ahead < self._aimd.window

    def commit(self, pod: int):
        with self._lock:
            self.steps[pod] += 1

    def staleness(self) -> int:
        """Current lead of the fastest pod over the slowest (steps)."""
        with self._lock:
            return max(self.steps) - min(self.steps)

    def lead(self, pod: int) -> int:
        """Pod's own lead over the slowest pod — the staleness of the
        gradient this pod just committed."""
        with self._lock:
            return self.steps[pod] - min(self.steps)

    def observe_quality(self, penalty: float, slo: float):
        """AIMD feedback: staleness-induced quality penalty vs. its SLO
        (Algorithm 2 with penalty in place of epoch latency)."""
        with self._lock:
            self._aimd.update(penalty, slo)


def simulate(n_pods: int, durations, *, controller: BoundedStalenessController,
             straggle_prob: float = 0.0, straggle_factor: float = 1.0,
             seed: int = 0, horizon_steps: int = 400,
             quality_slo: float = float("inf"),
             penalty_per_stale: float = 0.0):
    """Event-driven sim of ``n_pods`` data-parallel pods under a commit
    controller.  ``durations[p]`` is pod p's base step time; each step
    independently straggles (x ``straggle_factor``) with ``straggle_prob``
    (preemptions, ECC retries, network blips).

    Returns ``(steps_per_s, mean_staleness, p99_staleness)`` — staleness
    sampled at every commit.

    Straggle draws are counter-based (``repro_torch.workloads.generators``):
    pod ``p``'s step ``k`` straggles iff its uniform — pure in
    ``(seed, p, k)`` — lands under ``straggle_prob``, so the straggler
    pattern is identical across horizons, controllers and commit
    interleavings (no sequential RNG state).
    """
    INF = float("inf")
    t = 0.0
    finish = [INF] * n_pods          # completion time of the in-flight step
    blocked = [False] * n_pods
    staleness_samples: list[int] = []
    commits = 0
    # A pod can start at most one step per global commit, plus its final
    # in-flight step — horizon_steps + 1 draws bound every pod.
    u = [straggle_uniforms(seed, p, horizon_steps + 1)
         for p in range(n_pods)] if straggle_prob > 0.0 else None
    started = [0] * n_pods

    def step_duration(p: int) -> float:
        d = float(durations[p])
        if straggle_prob > 0.0:
            if u[p][started[p]] < straggle_prob:
                d *= straggle_factor
            started[p] += 1
        return d

    def try_start(p: int):
        if controller.can_commit(p):
            blocked[p] = False
            finish[p] = t + step_duration(p)
        else:
            blocked[p] = True
            finish[p] = INF

    for p in range(n_pods):
        try_start(p)

    while commits < horizon_steps:
        p = int(np.argmin(finish))
        if finish[p] == INF:         # total deadlock cannot happen: the
            break                    # slowest pod always has ahead == 0
        t = finish[p]
        controller.commit(p)
        commits += 1
        # Staleness of the committed gradient = this pod's own lead (the
        # global max-min lead would keep penalizing laggards for a sprint
        # the window already ended, collapsing the AIMD loop).
        st = controller.lead(p)
        staleness_samples.append(st)
        if penalty_per_stale > 0.0 or quality_slo != float("inf"):
            controller.observe_quality(st * penalty_per_stale, quality_slo)
        try_start(p)
        for q in range(n_pods):      # a commit may unblock waiting pods
            if blocked[q]:
                try_start(q)

    sps = commits / max(t, 1e-12)
    # Zero commits -> no staleness distribution exists: nan, not a 0.0
    # sentinel that would read as "perfectly fresh" (repro_torch.core.stats
    # is the repo-wide empty-samples convention).
    mean_st = float(np.mean(staleness_samples)) if staleness_samples \
        else float("nan")
    p99_st = stats.percentile(staleness_samples, 99)
    return sps, mean_st, p99_st
