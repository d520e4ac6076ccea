"""Key-sharded Zipf traffic — only the host-side sampler constants so far.

``build_params`` always computes :func:`zipf_consts` (the values ride in
``SimParams`` even with the key-shard gate off), so the port keeps a copy
of it.  The device-side key draws wait for the key-sharded slice.
"""

from __future__ import annotations

import numpy as np

#: Exponents within this distance of the theta=1 pole are nudged off it
#: (the Gray/YCSB constants divide by ``1 - theta``).
_POLE_EPS = 1e-4


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
