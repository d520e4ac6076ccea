"""The closed loop (``wl``) with long epochs and the wakeup cost against
the JAX package's compiled sweep at the golden-digest scale: an epoch
end's think draw times its long-epoch draw sets the next epoch's scale,
and a queue-pop handoff adds the wakeup to the scaled critical section.
Every leaf and summary equal (level 1).  Tolerance: exact equality."""

import pytest

from test_torch_simlock import compare_grid


@pytest.mark.parametrize("policy", ["fifo", "libasl"])
def test_closed_loop_with_long_epochs_matches_reference(policy):
    st, _ = compare_grid({"long_epoch_prob": [0.3, 1.0]},
                         policy=policy, wl=True, wl_process="poisson",
                         wl_rate=1.2, wl_service="lognormal", wl_cv=1.0,
                         long_epoch_prob=0.3, long_epoch_scale=10.0,
                         wakeup_us=2.0)
    assert (st.scale > 10.0).any()
