"""Keyed traffic in the open loop (``wl_open``: the lock drawn at each
arrival) for each policy, against the JAX package's compiled sweep at the
golden seed: every leaf and summary (the merged read/write gate:
``test_torch_simlock_keyed_rw.py``).  Tolerance: exact equality."""

import pytest

from test_torch_simlock import compare_grid

KEYED = dict(n_keys=256, n_locks=8, zipf_theta=0.99)
OPEN = dict(wl_open=True, wl_process="poisson", wl_service="exp")


@pytest.mark.parametrize("policy", ["fifo", "ks_erew", "ks_crew",
                                    "ks_jbsq"])
def test_open_loop_matches_reference(policy):
    st, _ = compare_grid({"arrival_rate": [0.3, 0.7]}, policy=policy,
                         sim_time_us=500.0, **KEYED, **OPEN)
    assert (st.events > 100).all()
