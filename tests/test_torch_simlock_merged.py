"""Merged policy sets (a ``policy`` axis, ``SimConfig.policy_set``)
against the JAX package at the golden-digest scale: both phases of the
paper's Bench-1 (``benchmarks/paper_figs.py::bench1_contended``, one
merged 4-policy set, pad lanes included) and the seven policies in one
set.  A merged cell must also equal its policy's own sweep: the other
members commit nothing, not even a key split.  Tolerance: exact
equality."""

import functools

import numpy as np
import pytest

import golden_digests as gd
from repro_torch.core import simlock as sl
from test_torch_simlock import compare_grid
from test_torch_simlock_bench1 import BENCH1

SET4 = ("fifo", "tas", "prop", "libasl")
ALL7 = ("fifo", "tas", "prop", "libasl", "edf", "shfl", "dvfs_race")


def bench1_phase(policies, w_big, slos, win0):
    return compare_grid(
        {"policy": list(policies), "w_big": list(w_big),
         "slo_us": list(slos), "window0_us": list(win0)},
        product=False, policy="fifo", policy_set=SET4, **BENCH1)


def test_bench1_merged_both_phases_match_reference():
    """Phase 1: the three baselines and three fifo pad lanes; phase 2:
    libasl at SLOs set from phase 1's fifo P99 (LibASL-MAX last)."""
    w0 = sl.SimConfig().default_window_us
    st, summ = bench1_phase(["fifo", "tas", "prop", "fifo", "fifo", "fifo"],
                            [1.0, 8.0, 1.0, 1.0, 1.0, 1.0], [1e9] * 6,
                            [w0] * 6)
    assert (st.events > 1000).all()
    p99 = summ[0]["ep_p99_all_us"]
    assert np.isfinite(p99)
    slos = [0.0, p99, 1.5 * p99, 2.5 * p99, 5 * p99, 1e5]
    bench1_phase(["libasl"] * 6, [1.0] * 6, slos, [w0] * 5 + [1e5])


def test_all_seven_in_one_set_match_reference():
    compare_grid({"policy": list(ALL7), "slo_us": [40.0] * 7,
                  "shfl_bound": [1] * 7, "race_bound": [2] * 7},
                 product=False, policy="fifo")


@functools.lru_cache(maxsize=None)
def _merged7():
    cfg = sl.SimConfig(sim_time_us=gd.SIM_US, **BENCH1)
    return sl.sweep(cfg, {"policy": list(ALL7), "seed": [gd.SEED]},
                    slo_us=gd.SLO_US, device="cpu")[0]


@pytest.mark.parametrize("member", ["fifo", "tas", "libasl", "shfl"])
def test_merged_cell_equals_its_own_policy(member):
    """A member's cell in a set with key-splitting members (tas, libasl)
    equals that policy's single-policy sweep, leaf for leaf."""
    merged = _merged7()
    alone, _ = sl.sweep(sl.SimConfig(policy=member, sim_time_us=gd.SIM_US,
                                     **BENCH1),
                        {"seed": [gd.SEED]}, slo_us=gd.SLO_US, device="cpu")
    got = sl.to_reference(sl._cell(merged, ALL7.index(member)))
    want = sl.to_reference(sl._cell(alone, 0))
    for name in want._fields:
        if name == "pol":
            for k, v in want.pol.items():
                np.testing.assert_array_equal(got.pol[k], v, k)
        else:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), name)
