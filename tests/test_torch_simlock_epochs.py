"""Bench-3's long epochs and Bench-6's blocking-lock wakeup cost against
the JAX package at the golden-digest scale.  Long epochs split the key
on every release (before tas / libasl's pick) and scale the next epoch's
non-critical work; the wakeup is paid only by queue-pop handoffs.
Tolerance: exact equality."""

import pytest

import golden_digests as gd
from test_torch_simlock import compare_grid
from test_torch_simlock_bench1 import BENCH1


@pytest.mark.parametrize("policy", ["fifo", "libasl"])
def test_long_epoch_prob_axis_matches_reference(policy):
    """Bench-3's shape (``paper_figs.bench3_mixed``): the mix probability
    swept from a config whose gate is on, on the Bench-1 program."""
    st, _ = compare_grid({"long_epoch_prob": [1.0, 0.6, 0.2, 0.0]},
                         policy=policy, long_epoch_prob=1.0,
                         long_epoch_scale=10.0, **BENCH1)
    assert (st.events > 200).all()
    assert (st.scale != 1.0).any()


@pytest.mark.parametrize("policy", ["tas", "prop", "shfl"])
def test_long_epoch_scale_axis_matches_reference(policy):
    """A swept scale from a config whose gate is off: the axis of the
    probability turns it on (``sweep_config``)."""
    compare_grid({"long_epoch_prob": [0.3], "long_epoch_scale": [1.0, 7.5],
                  "n_cores": [5, 8]}, policy=policy)


@pytest.mark.parametrize("policy", ["fifo", "libasl"])
def test_wakeup_axis_matches_reference(policy):
    """Bench-6's shape (``paper_figs.bench6_blocking``): the wakeup cost
    swept on the Bench-1 program, 0 among the values."""
    st, _ = compare_grid({"wakeup_us": [0.0, 8.0, 20.0]}, policy=policy,
                         slo_us=1e5 if policy == "libasl" else gd.SLO_US,
                         wakeup_us=20.0, **BENCH1)
    assert st.events[0] > st.events[2]


@pytest.mark.parametrize("policy", ["prop", "edf", "dvfs_race"])
def test_wakeup_with_long_epochs_matches_reference(policy):
    compare_grid({"n_cores": [3, 8]}, policy=policy, wakeup_us=1.5,
                 long_epoch_prob=0.25, long_epoch_scale=4.0)
