"""The key-sharded policies and axes at their edges, against the JAX
package at the golden seed: each ``ks_*`` policy with keys off (a
single-lock policy: the owner the first big core, every epoch a read) on
the fig1 and Bench-1 programs with its bound swept; padded locks (an
``n_locks`` axis under ``cfg.n_locks``) and padded cores; an ``n_keys``
axis turning the key gate on; the policies' knobs; and the reference's
config and sweep validation errors, message for message.  Tolerance:
exact equality."""

import math

import pytest

from repro.core import simlock as rsl
from repro_torch.core import simlock as sl
from test_torch_simlock import compare_grid
from test_torch_simlock_bench1 import BENCH1

KNOBS = {"ks_erew": "erew_bound", "ks_crew": "crew_bound",
         "ks_jbsq": "jbsq_k"}


@pytest.mark.parametrize("program", ["fig1", "bench1"])
@pytest.mark.parametrize("policy", sorted(KNOBS))
def test_keys_off_matches_reference(policy, program):
    kw = BENCH1 if program == "bench1" else {}
    st, _ = compare_grid({"n_cores": [4, 8], KNOBS[policy]: [1, 4]},
                         policy=policy, sim_time_us=600.0, **kw)
    assert (st.cur_lock == 0).all() and (st.cur_rw == 1.0).all()


def test_padded_locks_and_cores_match_reference():
    """Lock-count cells under the padded 8 locks, with padded cores and
    the crew write fraction swept."""
    axes = {"n_locks": [2, 5, 8], "n_cores": [5, 8],
            "crew_wfrac": [0.3, 0.7]}
    st, _ = compare_grid(axes, policy="ks_crew", n_keys=64, n_locks=8,
                         zipf_theta=1.2, sim_time_us=400.0)
    # The grid is the product in key order: each n_locks value 4 cells.
    for i, n in enumerate(n for n in axes["n_locks"] for _ in range(4)):
        assert int(st.cur_lock[i].max()) < n


def test_n_keys_axis_turns_the_gate_on():
    cfg = sl.SimConfig(policy="ks_erew", n_locks=4, sim_time_us=400.0)
    axes = {"n_keys": [4, 64], "zipf_theta": [0.0, 1.2]}
    assert sl.sweep_config(cfg, axes).n_keys == 64
    compare_grid(axes, policy="ks_erew", n_locks=4, sim_time_us=400.0)


def test_policy_knobs_match_reference():
    for policy, kw in (("ks_erew", (("erew_bound", 2),)),
                       ("ks_crew", (("crew_wfrac", 0.25),
                                    ("crew_bound", 1))),
                       ("ks_jbsq", (("jbsq_k", 7),))):
        pm = sl._param_values(sl.SimConfig(policy=policy, policy_kw=kw), 80.0)
        rpm = rsl.build_params(rsl.SimConfig(policy=policy, policy_kw=kw),
                               80.0)
        assert {k: float(v) for k, v in pm["pol"].items()} == \
            {k: float(v) for k, v in rpm.pol.items()}


def _raise_alike(call):
    """The same exception type and message from both packages."""
    errs = []
    for mod in (sl, rsl):
        with pytest.raises(Exception) as e:
            call(mod)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]
    return errs[0]


@pytest.mark.parametrize("kw", [
    dict(n_keys=4, n_locks=8),
    dict(n_keys=-1),
    dict(n_keys=16, zipf_theta=-0.5),
    dict(n_keys=16, zipf_theta=math.nan),
    dict(policy="ks_crew", policy_kw=(("erew_bound", 2),)),
    dict(policy="ks_jbsk"),
])
def test_config_errors_match_reference(kw):
    def build(mod):
        cfg = mod.SimConfig(**kw)
        return mod.build_params(cfg, 80.0) if mod is rsl else \
            sl._param_values(cfg, 80.0)
    assert _raise_alike(build)[0] is ValueError


@pytest.mark.parametrize("cfg_kw, axes", [
    (dict(), {"zipf_theta": [0.5]}),
    (dict(), {"n_locks": [1]}),
    (dict(n_keys=16, n_locks=4), {"n_locks": [5]}),
    (dict(n_keys=16, n_locks=4), {"n_locks": [0]}),
    (dict(), {"n_keys": [0]}),
    (dict(n_locks=4), {"n_keys": [2, 8]}),
    (dict(n_keys=16, n_locks=4), {"n_keys": [2], "n_locks": [3]}),
])
def test_sweep_errors_match_reference(cfg_kw, axes):
    def go(mod):
        return mod.sweep(mod.SimConfig(sim_time_us=50.0, **cfg_kw), axes,
                         **({"device": "cpu"} if mod is sl else {}))
    assert _raise_alike(go)[0] is ValueError
