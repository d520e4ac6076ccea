"""The port's ``fused_chunk`` against the JAX package's Pallas kernel on
the Bench-1 program (4 critical sections over 2 locks), and its chunk
invariance.  Shares the harness of ``test_torch_simstep.py``; tolerance:
exact equality."""

import numpy as np
import pytest

import golden_digests as gd
from repro_torch.core import simlock as sl
from repro_torch.kernels import simstep
from test_torch_simstep import _ref_start, check_against_pallas


@pytest.mark.parametrize("policy", ["fifo", "tas", "prop", "libasl"])
def test_fused_chunk_matches_pallas_kernel_bench1(policy):
    check_against_pallas(policy, "bench1")


@pytest.mark.parametrize("policy", ["tas", "libasl"])
def test_fused_chunk_is_chunk_invariant(policy):
    """4 x 32 events == 128 x 1 event == 1 x 128 events from one carried
    state (the live guard makes any chunk size safe)."""
    _, tb, pm, st, _ = _ref_start(policy)
    scfg = sl.SimConfig(policy=policy, sim_time_us=gd.SIM_US)
    runs = []
    for chunk, reps in ((128, 1), (32, 4), (1, 128)):
        ptb, ppm, pst = sl.from_reference(tb, pm, st, device="cpu")
        for _ in range(reps):
            simstep.fused_chunk(ptb, ppm, pst, chunk, scfg)
        runs.append(sl.to_reference(pst))
    for other in runs[1:]:
        for name in runs[0]._fields:
            if name != "pol":
                np.testing.assert_array_equal(getattr(runs[0], name),
                                              getattr(other, name), name)


