"""Key-sharded Zipf traffic: the counter-pure key and read/write streams
and the bucketed key -> lock index, on tensors.

Every key draw is a pure function of ``(seed, core, epoch)`` through the
``STREAM_KEY`` stream (the read/write class through ``STREAM_RW``), so the
host can rebuild the whole table (:func:`key_table`).  The sampler is the
Gray et al. / YCSB inverse CDF built from three host constants
(:func:`zipf_consts`): exact for ranks 0 and 1, a power law for the tail.
Key ``k`` lands on lock ``k mod n_locks`` (rank-preserving: key 0, the
hottest, on lock 0).

The tail is ``floor(n * (eta u - eta + 1) ** alpha)`` in f32.  Compiled
(the simulator's draws), XLA makes ``eta u - eta`` one fused multiply-add
and calls glibc's ``powf``; op by op (the reference's host tables) it
rounds the product.  :func:`zipf_key` does either (``fused``), its
``powf`` is :func:`repro_torch.core.xla_math.powf`, and both are
bit-identical to the JAX package (``tests/test_torch_keys.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import xla_math as xm
from repro_torch.workloads.generators import (STREAM_KEY, STREAM_RW,
                                              counter_uniform, fold_in,
                                              stream_key, uniform)

#: Exponents within this distance of the theta=1 pole are nudged off it
#: (the Gray/YCSB constants divide by ``1 - theta``).
_POLE_EPS = 1e-4
_F32 = torch.float32


def zipf_consts(n_keys: int, theta: float):
    """Host-precomputed sampler constants ``(theta', zeta, eta, alpha)``.

    ``theta'`` is the pole-nudged exponent actually used.  ``zeta`` is the
    generalized harmonic number ``H_{n,theta}``; ``eta``/``alpha`` are the
    Gray et al. rejection-free inverse-CDF constants.
    """
    n_keys = int(n_keys)
    theta = float(theta)
    if n_keys < 1:
        raise ValueError(f"zipf_consts: n_keys must be >= 1, got {n_keys}")
    if not np.isfinite(theta) or theta < 0.0:
        raise ValueError("zipf_consts: theta must be finite and >= 0, "
                         f"got {theta!r}")
    if abs(theta - 1.0) < _POLE_EPS:
        theta = 1.0 - _POLE_EPS if theta <= 1.0 else 1.0 + _POLE_EPS
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    zeta = float(np.sum(ranks ** -theta))
    zeta2 = float(1.0 + 0.5 ** theta) if n_keys >= 2 else zeta
    alpha = 1.0 / (1.0 - theta)
    denom = 1.0 - zeta2 / zeta
    # n_keys 1..2 degenerate: the tail branch is never taken; keep eta
    # finite so the constant stays well-defined.
    eta = (1.0 - (2.0 / n_keys) ** (1.0 - theta)) / denom \
        if n_keys > 2 and abs(denom) > 1e-12 else 1.0
    return theta, float(zeta), float(eta), float(alpha)


def _f32(x, device) -> torch.Tensor:
    return x.to(_F32) if isinstance(x, torch.Tensor) else \
        torch.tensor(x, dtype=_F32, device=device)


def zipf_zeta2(theta) -> torch.Tensor:
    """``1 + 0.5 ** theta`` in f32, through glibc's ``powf``: rank 1's
    upper edge in the scaled uniform."""
    t = _f32(theta, None)
    return 1.0 + xm.powf(torch.full_like(t, 0.5), t)


def zipf_key(u, n_keys, theta, zeta, eta, alpha, *, fused: bool = True,
             zeta2=None) -> torch.Tensor:
    """The Zipf(n_keys, theta) rank of uniform ``u``, int32 in ``[0,
    n_keys)``, in the reference's f32 operations (arguments broadcast;
    tensors or Python numbers, taken as f32).  ``fused``: ``eta u - eta``
    is one fused multiply-add, as in the compiled simulator; else rounded
    op by op, as in the reference's host tables.  ``zeta2`` may pass
    :func:`zipf_zeta2` of ``theta`` computed once."""
    u = _f32(u, None)
    dev = u.device
    n = _f32(n_keys, dev)
    zeta, eta, alpha = (_f32(v, dev) for v in (zeta, eta, alpha))
    if zeta2 is None:
        zeta2 = zipf_zeta2(_f32(theta, dev))
    uz = u * zeta
    base = xm.fma(eta, u, -eta) if fused else eta * u - eta
    tail = torch.floor(n * xm.powf(base + 1.0, alpha))
    k = torch.where(uz < 1.0, 0.0, torch.where(uz < zeta2, 1.0, tail))
    # clip, then XLA's saturating conversion (NaN -> 0).
    k = torch.minimum(torch.maximum(k, torch.zeros_like(k)), n - 1.0)
    return torch.nan_to_num(k, nan=0.0).to(torch.int32)


def key_to_lock(key, n_locks) -> torch.Tensor:
    """Bucketed key -> lock index: ``key mod max(n_locks, 1)``."""
    key = torch.as_tensor(key).to(torch.int32)
    n = torch.clamp_min(torch.as_tensor(n_locks, device=key.device)
                        .to(torch.int32), 1)
    return torch.remainder(key, n)


# --------------------------------------------------------------------------
# Per-(core, epoch) streams — the device-side contract
# --------------------------------------------------------------------------

def epoch_key_u(seed, core, epoch) -> torch.Tensor:
    """The key-stream uniform for (core, epoch) — pure counter draw."""
    return counter_uniform(stream_key(seed, STREAM_KEY), core, epoch)


def epoch_rw_u(seed, core, epoch) -> torch.Tensor:
    """The read/write-stream uniform for (core, epoch): CREW policies
    classify an epoch as a write when it falls below the write
    fraction."""
    return counter_uniform(stream_key(seed, STREAM_RW), core, epoch)


def epoch_lock(seed, core, epoch, n_keys, theta, zeta, eta, alpha,
               n_locks) -> torch.Tensor:
    """The lock a (core, epoch) contends: Zipf key -> bucket, counter-pure,
    as the compiled simulator draws it."""
    u = epoch_key_u(seed, core, epoch)
    return key_to_lock(zipf_key(u, n_keys, theta, zeta, eta, alpha),
                       n_locks)


# --------------------------------------------------------------------------
# Host reconstruction (tests / analysis)
# --------------------------------------------------------------------------

def _u_grid(seed, stream: int, n_cores: int, n_epochs: int) -> torch.Tensor:
    """``[c, e]``: ``counter_uniform(stream_key(seed, stream), c, e)``."""
    cs = torch.arange(n_cores, dtype=torch.int64)
    es = torch.arange(n_epochs, dtype=torch.int64)
    keys = fold_in(stream_key(seed, stream)[None, :].expand(n_cores, 2), cs)
    return uniform(fold_in(keys[:, None, :].expand(n_cores, n_epochs, 2),
                           es[None, :]))


def key_table(seed, n_cores: int, n_epochs: int, n_keys: int,
              theta: float) -> np.ndarray:
    """Host reconstruction of the key stream: ``[c, e]`` is the Zipf key
    core ``c`` draws for epoch ``e`` (the reference's host table, op by
    op; prefix-invariant in both dimensions)."""
    th, zeta, eta, alpha = zipf_consts(n_keys, theta)
    u = _u_grid(seed, STREAM_KEY, n_cores, n_epochs)
    return zipf_key(u, n_keys, th, zeta, eta, alpha, fused=False).numpy()


def lock_table(seed, n_cores: int, n_epochs: int, n_keys: int,
               theta: float, n_locks: int) -> np.ndarray:
    """Host reconstruction of the per-(core, epoch) lock ids
    (``key_table`` pushed through the bucket index)."""
    return key_to_lock(torch.from_numpy(
        key_table(seed, n_cores, n_epochs, n_keys, theta)), n_locks).numpy()


def rw_table(seed, n_cores: int, n_epochs: int,
             write_frac: float) -> np.ndarray:
    """Host reconstruction of the CREW write bits (1 = write epoch)."""
    u = _u_grid(seed, STREAM_RW, n_cores, n_epochs).numpy()
    return (u < write_frac).astype(np.int32)


def zipf_pmf(n_keys: int, theta: float) -> np.ndarray:
    """The exact target pmf ``P(key = k) ∝ 1/(k+1)^theta``."""
    th, zeta, _, _ = zipf_consts(n_keys, theta)
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    return ranks ** -th / zeta
