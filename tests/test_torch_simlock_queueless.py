"""The queue-less policies, ``edf``, ``shfl`` and ``dvfs_race``, against
the JAX package at the golden-digest scale: on the fig1 and Bench-1
programs, with the ``shfl_bound`` and ``race_bound`` axes and their
``policy_kw`` knobs, and ``run`` with the pol state slots.  Tolerance:
exact equality."""

import pytest

import golden_digests as gd
from repro.core import simlock as rsl
from repro_torch.core import simlock as sl
from test_torch_simlock import compare_grid, summary_digests
from test_torch_simlock_bench1 import BENCH1


@pytest.mark.parametrize("program", ["fig1", "bench1"])
@pytest.mark.parametrize("policy", ["edf", "shfl", "dvfs_race"])
def test_queueless_sweep_matches_reference(policy, program):
    st, _ = compare_grid(dict(gd.SWEEP_AXES), policy=policy,
                         **(BENCH1 if program == "bench1" else {}))
    assert (st.events > 1000).all()


@pytest.mark.parametrize("policy, axis, values", [
    ("shfl", "shfl_bound", [0, 1, 16]),
    ("dvfs_race", "race_bound", [0, 3, 64]),
])
def test_bound_axes_match_reference(policy, axis, values):
    st, _ = compare_grid({axis: values, "n_cores": [8]}, policy=policy,
                         **BENCH1)
    assert sorted(st.pol) == [axis.replace("bound", "ctr")]


@pytest.mark.parametrize("policy, kw", [
    ("shfl", (("shfl_bound", 2),)),
    ("dvfs_race", (("race_bound", 1),)),
])
def test_policy_kw_and_run_match_reference(policy, kw):
    cfg = sl.SimConfig(policy=policy, sim_time_us=gd.SIM_US, policy_kw=kw)
    rcfg = rsl.SimConfig(policy=policy, sim_time_us=gd.SIM_US,
                         policy_kw=kw)
    st = sl.run(cfg, gd.SLO_US, seed=gd.SEED, device="cpu")
    rst = rsl.run(rcfg, gd.SLO_US, seed=gd.SEED)
    assert st.t.ndim == 0 and list(st.pol) == list(rst.pol)
    assert gd.digest_state(sl.to_reference(st)) == gd.digest_state(rst)
    assert summary_digests([sl.summarize(cfg, st)]) == \
        summary_digests([rsl.summarize(rcfg, rst)])
    with pytest.raises(ValueError, match="unknown policy_kw"):
        sl.build_params(sl.SimConfig(policy=policy,
                                     policy_kw=(("bound", 1),)),
                        gd.SLO_US, device="cpu")
