"""The port's fleet dispatcher (``repro_torch.serving.dispatch``) and its
host fault schedules (``repro_torch.faults``) against the JAX package's:
every dispatch policy over 20-25 simulated seconds, with faults (churn,
straggler spikes, preemption stalls), with timeouts, retries and
admission control, on a replayed trace, with the keyed knobs, and on a
run too short for any arrival; ``spill_index``'s cases
(``tests/test_system.py``); ``FaultSpec``'s checks and the schedules
(``tests/test_chaos.py``).  Tolerance: exact equality of the whole
returned dict (every value's ``repr``, so NaN as NaN, and the types)."""

import numpy as np
import pytest

from repro.core import policies as jpol
from repro.faults import host as jhost
from repro.faults.model import FaultSpec as JFaultSpec
from repro.serving import dispatch as jd
from repro.workloads import generators as jgen
from repro.workloads import traces as jtr
from repro_torch.core import policies as tpol
from repro_torch.faults import host as thost
from repro_torch.faults.model import FaultSpec as TFaultSpec
from repro_torch.serving import dispatch as td
from repro_torch.workloads import generators as tgen
from repro_torch.workloads import traces as ttr

POLICIES = ("fair", "fast-only", "asl", "key-erew", "key-crew", "key-jbsq")
CHAOS = dict(churn_rate=0.3, churn_period=2.0, straggle_rate=0.1,
             straggle_scale=5.0, preempt_rate=0.05, preempt_scale=0.5)
CASES = {
    "plain": dict(rate_rps=28.0, slo=0.5, duration_s=25.0, seed=3),
    "faults": dict(slo=0.6, duration_s=20.0, seed=3, faults=CHAOS),
    "resilience": dict(rate_rps=60.0, slo=0.6, duration_s=20.0, seed=1,
                       timeout_s=0.4, max_retries=2, admit_cap=40),
}


def same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert repr(got[k]) == repr(want[k]), k


def both(policy, **kw):
    """(port, reference) result dicts of one run."""
    faults = kw.pop("faults", None)
    tk, jk = dict(kw), dict(kw)
    if faults is not None:
        tk["faults"], jk["faults"] = TFaultSpec(**faults), JFaultSpec(**faults)
    return (td.simulate_dispatch(policy, **tk),
            jd.simulate_dispatch(policy, **jk))


def test_policy_names_follow_the_registry():
    assert td.DISPATCH_POLICIES == jd.DISPATCH_POLICIES == POLICIES
    assert tpol.dispatch_names() == jpol.dispatch_names()
    assert tpol.host_schedulers() == jpol.host_schedulers()
    with pytest.raises(ValueError, match="unknown dispatch policy"):
        td.simulate_dispatch("round-robin")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_dispatch_matches_the_reference(policy, case):
    got, want = both(policy, **CASES[case])
    same(got, want)
    assert got["completed"] > 0
    if case == "resilience":
        assert got["drops"] > 0 and got["timeouts"] > 0


def test_faults_and_resilience_all_on():
    """Every fault, timeouts with retries and admission control at once
    (``tests/test_chaos.py``'s full-chaos run)."""
    f = dict(churn_rate=0.5, churn_period=1.0, preempt_rate=0.2,
             preempt_scale=1.0, straggle_rate=0.2, straggle_scale=8.0)
    got, want = both("asl", duration_s=20.0, slo=0.6, seed=0,
                     timeout_s=1.0, max_retries=3, admit_cap=100, faults=f)
    same(got, want)
    assert got["lost"] + got["retries"] > 0


@pytest.mark.parametrize("policy", ("asl", "key-crew"))
def test_replayed_trace_matches_the_reference(policy):
    """A recorded trace (MMPP arrivals, bimodal service) replayed: the
    same trace on both sides, and the same result."""
    args = ("mmpp", 30.0), dict(dist="bimodal", mean=0.08, mix=0.2,
                                mix_scale=6.0)
    tt = ttr.generate(tgen.ArrivalSpec(*args[0], burstiness=4.0),
                      tgen.ServiceSpec(**args[1]), 20.0, 5)
    tj = jtr.generate(jgen.ArrivalSpec(*args[0], burstiness=4.0),
                      jgen.ServiceSpec(**args[1]), 20.0, 5)
    assert tt.arrival_t.tobytes() == np.asarray(tj.arrival_t).tobytes()
    assert tt.service_s.tobytes() == np.asarray(tj.service_s).tobytes()
    got = td.simulate_dispatch(policy, slo=0.5, trace=tt)
    same(got, jd.simulate_dispatch(policy, slo=0.5, trace=tj))


@pytest.mark.parametrize("knobs", [
    dict(n_buckets=16, n_keys=4096, zipf_theta=1.2, write_frac=0.2),
    dict(n_buckets=5, n_keys=64, zipf_theta=0.0, write_frac=0.9),
    dict(n_buckets=64, n_keys=1, zipf_theta=0.5, write_frac=0.5)])
@pytest.mark.parametrize("policy", ("key-erew", "key-crew", "key-jbsq"))
def test_keyed_knobs_match_the_reference(policy, knobs):
    got, want = both(policy, rate_rps=24.0, slo=0.5, duration_s=20.0,
                     seed=4, **knobs)
    same(got, want)


@pytest.mark.parametrize("policy", ("fair", "fast-only", "asl"))
def test_unkeyed_policies_ignore_the_key_knobs(policy):
    kw = dict(rate_rps=24.0, slo=0.5, duration_s=20.0, seed=4)
    base = td.simulate_dispatch(policy, **kw)
    same(td.simulate_dispatch(policy, n_buckets=3, n_keys=7,
                              zipf_theta=1.5, write_frac=1.0, **kw), base)


@pytest.mark.parametrize("policy", POLICIES)
def test_a_run_with_no_arrival_reports_nan(policy):
    got, want = both(policy, duration_s=1e-9, rate_rps=1.0, slo=1.0,
                     seed=0)
    same(got, want)
    assert got["n"] == 0 and np.isnan(got["p50"]) and np.isnan(got["p99"])
    assert np.isnan(got["slo_violation"])


def test_spill_index_picks_the_earliest_deadline():
    queue = [(0.0, 0.1, 5.0), (0.1, 0.1, 2.0)]
    for clock, want in ((6.0, 1), (3.0, 1), (5.5, 1), (1.0, None)):
        assert td.spill_index(queue, clock) == want \
            == jd.spill_index(queue, clock)
    tie = [(0.0, 0.1, 2.0), (0.1, 0.1, 2.0)]
    assert td.spill_index(tie, 3.0) == jd.spill_index(tie, 3.0) == 0


@pytest.mark.parametrize("bad", [
    dict(preempt_rate=1.5), dict(churn_rate=-0.1),
    dict(straggle_rate=float("nan")), dict(preempt_scale=-1.0),
    dict(churn_period=0.0), dict(straggle_scale=0.5)])
def test_fault_spec_checks_match_the_reference(bad):
    with pytest.raises(ValueError) as jerr:
        JFaultSpec(**bad)
    with pytest.raises(ValueError) as terr:
        TFaultSpec(**bad)
    assert str(terr.value) == str(jerr.value)


def test_fault_schedules_match_the_reference_bit_for_bit():
    assert not TFaultSpec().active and TFaultSpec(churn_rate=0.1).active
    spec = dict(churn_rate=0.4, churn_period=1.0, preempt_rate=0.5,
                preempt_scale=0.1, straggle_rate=0.5, straggle_scale=2.0)
    t, j = TFaultSpec(**spec), JFaultSpec(**spec)
    for ts, js in ((t, j), (TFaultSpec(), JFaultSpec())):
        a, b = thost.outage_mask(ts, 4, 30.0, 7), \
            jhost.outage_mask(js, 4, 30.0, 7)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        for r in range(3):
            for name in ("spike_hits", "preempt_stalls"):
                a = getattr(thost, name)(ts, r, 256, 0)
                b = getattr(jhost, name)(js, r, 256, 0)
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    a = thost.outage_mask(t, 4, 30.0, 7)
    assert a.any() and not a.all()
    assert thost.preempt_stalls(t, 0, 256, 0).max() > 0
    assert tgen.LEGACY_LOGNORMAL_CV == jgen.LEGACY_LOGNORMAL_CV
    assert tgen.LEGACY_LOGNORMAL_MEAN == jgen.LEGACY_LOGNORMAL_MEAN
