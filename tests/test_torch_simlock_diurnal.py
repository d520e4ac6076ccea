"""The diurnal arrival ramp against the JAX package's compiled sweep at
the golden-digest scale, at summary level.  Its ``sin`` is libm's
``sinf`` on the reference side and an f64 sine rounded to f32 in the
port (``core/xla_math.py``): they differ by an ulp on about 1 % of draws
(``test_torch_draws.py``), so a tick may move (parity level 3).
Tolerance: throughput and each core class's P50 / P99 epoch latency,
averaged over 3 seeds, within 1 %."""

import numpy as np

import golden_digests as gd
from repro.core import simlock as rsl
from repro_torch.core import simlock as sl


def test_diurnal_matches_reference_at_summary_level():
    """Level 3: the diurnal gap divides by ``rate (1 + amp sin(2 pi
    t / period))``, and the sine differs from libm's ``sinf`` by an ulp
    on about 1 % of draws (``test_torch_draws.py``), so a tick may move.
    Throughput and each class's P50 / P99 within 1 % over 3 seeds."""
    kw = dict(policy="fifo", wl=True, wl_process="diurnal", wl_amp=0.8,
              wl_period_us=1000.0, wl_service="exp", sim_time_us=gd.SIM_US)
    axes = {"seed": [0, 1, 2]}
    cfg, rcfg = sl.SimConfig(**kw), rsl.SimConfig(**kw)
    st, grid = sl.sweep(cfg, axes, slo_us=gd.SLO_US, device="cpu")
    rst, rgrid = rsl.sweep(rcfg, axes, slo_us=gd.SLO_US)
    got = sl.sweep_summaries(cfg, st, grid)
    want = rsl.sweep_summaries(rcfg, rst, rgrid)
    keys = ["throughput_cs_per_s"] + [f"{m}_{c}_us" for m in (
        "ep_p50", "ep_p99") for c in ("big", "little")]
    for k in keys:
        g = np.mean([s[k] for s in got])
        w = np.mean([s[k] for s in want])
        assert abs(g - w) <= 0.01 * abs(w), (k, g, w)
