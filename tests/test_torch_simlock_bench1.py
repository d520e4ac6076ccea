"""The port's sweep against the JAX package on the Bench-1 program
(4 critical sections over 2 locks, paper Fig 8a/8b): every state leaf and
summary key equal at the golden-digest scale (libasl's Bench-1 sweep is
in ``test_torch_simlock_libasl.py``).  Tolerance: exact equality."""

import pytest

import golden_digests as gd
from test_torch_simlock import compare_sweep

BENCH1 = dict(seg_noncrit_us=(1.0, 0.5, 0.5, 0.5),
              seg_cs_us=(2.0, 1.0, 3.0, 0.5), seg_lock=(0, 1, 0, 1),
              n_locks=2, inter_epoch_us=7.5)


@pytest.mark.parametrize("policy", ["fifo", "tas", "prop"])
def test_bench1_sweep_matches_reference(policy):
    st = compare_sweep(policy, dict(gd.SWEEP_AXES), **BENCH1)
    assert (st.events > 1000).all()
