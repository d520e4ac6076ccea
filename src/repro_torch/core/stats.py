"""Shared streaming-statistics helpers (host-side, numpy only): a copy of
the JAX package's module, kept here so the port imports nothing of it.

Two things live here:

1. :func:`percentile` — the repo-wide empty-safe percentile.  Every
   host-side metrics path (simlock summaries, serving dispatch/engine,
   staleness, workload clients) funnels through it so "no samples"
   uniformly reports ``nan`` instead of raising or inventing a 0.0/inf
   sentinel.

2. The log-bucketed streaming-histogram layout used by the simulator's
   constant-memory tail metrics (``SimConfig.hist``,
   docs/simulator.md §Streaming metrics).  The device records counts;
   everything value-shaped (edges, representative values, quantiles,
   SLO fractions) is reconstructed here from the three layout numbers
   ``(lo, hi, n_buckets)``.

Bucket layout (``n_buckets = B >= 4``, growth ``g = (hi/lo)**(1/(B-2))``):

    bucket 0      : [0, lo)                  underflow
    bucket j      : [lo*g^(j-1), lo*g^j)     j = 1 .. B-2 (log-spaced)
    bucket B-1    : [hi, inf)                overflow

A sample is bucketed on device with two precomputed scalars
(``log2(lo)`` and ``1/log2(g)`` — see :func:`layout`), so recording is
one log2 + one clipped floor + one scatter-add.  Counts are u32 and
merge across cores, sweep cells, shards and devices by plain addition —
exactly associative and commutative, so any merge order is bitwise
identical.  Quantiles reconstructed from a merged histogram carry a
documented relative-error bound of ``sqrt(g) - 1`` (< one bucket's
relative width ``g - 1``) versus the exact order statistics, for
samples inside ``[lo, hi)``.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "percentile", "layout", "growth", "edges", "reps",
    "quantile", "good_count", "merge", "rel_err_bound",
]


def percentile(vals, q) -> float:
    """``np.percentile`` that returns ``nan`` on zero samples (and never
    raises on empty input).  ``q`` may be a scalar or a sequence; the
    return shape follows ``np.percentile``."""
    v = np.asarray(vals, float).ravel()
    if v.size == 0:
        q = np.asarray(q, float)
        return float("nan") if q.ndim == 0 else np.full(q.shape, np.nan)
    res = np.percentile(v, q)
    return float(res) if np.ndim(res) == 0 else res


# --------------------------------------------------------------------------
# Log-bucketed histogram layout
# --------------------------------------------------------------------------

def growth(lo: float, hi: float, n_buckets: int) -> float:
    """Per-bucket growth factor g: bucket upper/lower edge ratio."""
    if not (0.0 < lo < hi) or n_buckets < 4:
        raise ValueError(f"need 0 < lo < hi and n_buckets >= 4, got "
                         f"lo={lo!r} hi={hi!r} n_buckets={n_buckets!r}")
    return (hi / lo) ** (1.0 / (n_buckets - 2))


def rel_err_bound(lo: float, hi: float, n_buckets: int) -> float:
    """The documented quantile error bound: one bucket's relative width
    ``g - 1``, for samples in ``[lo, hi)``.  The reconstruction itself
    is tighter (``sqrt(g) - 1``, see :func:`quantile`); the slack
    absorbs float32 device bucketing of samples that sit within
    rounding distance of a bucket edge."""
    return growth(lo, hi, n_buckets) - 1.0


def layout(lo: float, hi: float, n_buckets: int) -> tuple:
    """The two scalars the device bucketing needs:
    ``(log2(lo), 1/log2(g))``.  Bucket index of a sample v is
    ``clip(1 + floor((log2(v) - log2(lo)) / log2(g)), 0, B-1)``."""
    g = growth(lo, hi, n_buckets)
    return math.log2(lo), 1.0 / math.log2(g)


def edges(lo: float, hi: float, n_buckets: int) -> np.ndarray:
    """The ``B-1`` internal bucket boundaries ``lo * g^j``,
    j = 0 .. B-2 (the last equals ``hi`` up to rounding)."""
    g = growth(lo, hi, n_buckets)
    return lo * g ** np.arange(n_buckets - 1, dtype=float)


def reps(lo: float, hi: float, n_buckets: int) -> np.ndarray:
    """Representative value per bucket: the geometric mid of the bucket's
    edges for the log-spaced interior, the nearest finite edge for the
    underflow/overflow buckets (conservative — error there is unbounded
    by construction; choose lo/hi to enclose the data)."""
    e = edges(lo, hi, n_buckets)
    g = growth(lo, hi, n_buckets)
    r = np.empty(n_buckets, float)
    r[0] = e[0]
    r[1:-1] = e[:-1] * math.sqrt(g)   # geometric mid of [e[j-1], e[j])
    r[-1] = e[-1]
    return r


def merge(hists) -> np.ndarray:
    """Merge histograms by summation over every leading axis: accepts a
    ``[..., B]`` array or a sequence of them.  u64 accumulation, so the
    merge is exact, associative and commutative — any cell/shard/device
    order is bitwise identical."""
    if isinstance(hists, (list, tuple)):
        hists = [np.asarray(h, np.uint64).reshape(-1, np.shape(h)[-1])
                 for h in hists]
        hists = np.concatenate(hists, axis=0)
    h = np.asarray(hists, np.uint64)
    return h.reshape(-1, h.shape[-1]).sum(axis=0, dtype=np.uint64)


def quantile(counts, q, lo: float, hi: float) -> float:
    """Quantile from a (merged) histogram; ``nan`` on zero counts.

    Mirrors ``np.percentile``'s linear interpolation at bucket
    resolution: the two order statistics straddling rank
    ``(total-1) * q/100`` are located exactly in the CDF and each is
    replaced by its bucket's representative value (geometric mid).  A
    convex combination preserves a multiplicative bound, so for samples
    inside ``[lo, hi)`` the result is within a factor ``sqrt(g)`` of the
    exact interpolated percentile — relative error <= ``sqrt(g) - 1``,
    strictly less than one bucket's relative width ``g - 1``."""
    c = merge(counts)
    total = int(c.sum())
    if total == 0:
        return float("nan")
    r = reps(lo, hi, c.size)
    k = (total - 1) * float(q) / 100.0
    k_lo = int(math.floor(k))
    w = k - k_lo
    cum = np.cumsum(c)
    # searchsorted over the CDF: first bucket whose cumulative count
    # reaches the (1-indexed) straddling ranks.
    j_lo = int(np.searchsorted(cum, k_lo + 1))
    j_hi = int(np.searchsorted(cum, min(k_lo + 2, total)))
    return float((1.0 - w) * r[j_lo] + w * r[j_hi])


def good_count(counts, thr: float, lo: float, hi: float) -> float:
    """Estimated number of samples <= ``thr`` from a histogram.

    Buckets entirely below the threshold count in full; the bucket
    containing it contributes fractionally by log-interpolation (the
    within-bucket distribution is taken log-uniform, consistent with the
    geometric-mid representative).  Exact when ``thr`` lands on a bucket
    edge; off by at most one bucket's contents otherwise."""
    c = merge(counts).astype(float)
    if thr < 0:
        return 0.0
    e = edges(lo, hi, c.size)
    j = int(np.searchsorted(e, thr, side="right"))  # bucket holding thr
    full = c[:j].sum()                              # buckets entirely <= thr
    if j == 0:
        # thr inside the underflow bucket [0, lo): linear credit.
        return float(c[0] * min(thr / lo, 1.0))
    if j >= c.size - 1:
        return float(full + (c[-1] if thr >= hi else 0.0))
    frac = (math.log(thr) - math.log(e[j - 1])) / \
        (math.log(e[j]) - math.log(e[j - 1]))
    return float(full + c[j] * min(max(frac, 0.0), 1.0))
