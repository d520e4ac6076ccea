"""The port's single runs, window carries and the remaining sweep axes
against the JAX package (golden-digest scale).  Tolerance: exact
equality."""

import pytest

import golden_digests as gd
from repro.core import simlock as rsl
from repro_torch.core import simlock as sl
from test_torch_simlock import compare_sweep, summary_digests


@pytest.mark.parametrize("policy", ["tas", "libasl"])
def test_run_matches_reference(policy):
    """``run`` (a one-cell sweep, returned without the cell axis) equals
    the reference's single run, which takes its switch-dispatched step."""
    cfg = sl.SimConfig(policy=policy, sim_time_us=gd.SIM_US)
    rcfg = rsl.SimConfig(policy=policy, sim_time_us=gd.SIM_US)
    st = sl.run(cfg, gd.SLO_US, seed=gd.SEED, device="cpu")
    rst = rsl.run(rcfg, gd.SLO_US, seed=gd.SEED)
    assert st.t.ndim == 0 and st.ep_lat.shape == (8, cfg.epcap)
    assert gd.digest_state(sl.to_reference(st)) == gd.digest_state(rst)
    assert summary_digests([sl.summarize(cfg, st, slo_us=gd.SLO_US)]) == \
        summary_digests([rsl.summarize(rcfg, rst, slo_us=gd.SLO_US)])
    # ... and equals the one-cell sweep it is made of.
    sw, _ = sl.sweep(cfg, {"seed": [gd.SEED]}, slo_us=gd.SLO_US,
                     device="cpu")
    assert gd.digest_state(sl.to_reference(st)) == gd.digest_state(
        sl.to_reference(sl._cell(sw, 0)))


def test_w_big_axis_matches_reference():
    compare_sweep("tas", {"w_big": [0.15, 2.5, 8.0], "n_cores": [8]})


def test_prop_n_axis_matches_reference():
    compare_sweep("prop", {"prop_n": [1, 5, 50], "n_cores": [8]})
