"""libasl end to end against the JAX package: the Bench-1 sweep, a zipped
SLO x initial-window x horizon grid that drives the AIMD window through
inexact f32 values, and a Bench-2 style window carry between runs.
Tolerance: exact equality."""

import numpy as np

import golden_digests as gd
from repro.core import simlock as rsl
from repro_torch.core import simlock as sl
from test_torch_simlock import compare_sweep
from test_torch_simlock_bench1 import BENCH1


def test_bench1_sweep_matches_reference_libasl():
    st = compare_sweep("libasl", dict(gd.SWEEP_AXES), **BENCH1)
    assert (st.events > 1000).all()


def test_zipped_slo_window_horizon_axes_match_reference():
    """A zipped (``product=False``) grid over the SLO, the initial window
    (LibASL-MAX style) and per-cell horizons."""
    compare_sweep("libasl", {"slo_us": [30.0, np.float64(75.5), 1e5],
                             "window0_us": [10.0, 10.0, 1e5],
                             "sim_time_us": [1_000.0, 2_500.0, 2_000.0]},
                  product=False)


def test_window_carry_matches_reference():
    """Bench-2 style: a second phase resumes from the first phase's AIMD
    windows (``windows0``)."""
    cfg = sl.SimConfig(policy="libasl", sim_time_us=1_500.0)
    rcfg = rsl.SimConfig(policy="libasl", sim_time_us=1_500.0)
    a = sl.run(cfg, 20.0, seed=1, device="cpu")
    ra = rsl.run(rcfg, 20.0, seed=1)
    b = sl.run(cfg, 200.0, seed=2, windows0=a.window.numpy(), device="cpu")
    rb = rsl.run(rcfg, 200.0, seed=2, windows0=np.asarray(ra.window).copy())
    assert gd.digest_state(sl.to_reference(b)) == gd.digest_state(rb)
