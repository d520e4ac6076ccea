"""The port's closed-loop slice end to end against the JAX package: the
same ``sweep`` through ``repro_torch`` (plain PyTorch version, CPU) and
``repro.core.simlock`` must agree in every ``SimState`` leaf's bytes
(``tests/golden_digests.py::digest_state``) and in every ``summarize``
key, at the golden-digest scale (``SIM_US``, ``SLO_US``, ``SEED``,
``SWEEP_AXES``).  Tolerance: exact equality.

The Bench-1 program runs in ``test_torch_simlock_bench1.py`` and the
single runs, carries and extra axes in ``test_torch_simlock_run.py``;
this file also holds the checks that the port runs every feature and
axis of the reference (keyed traffic since it was ported:
``test_torch_simlock_keyed*.py``)."""

import numpy as np
import pytest
import torch

import golden_digests as gd
from repro.core import simlock as rsl
from repro_torch.core import simlock as sl


def _plain(v):
    """A summary value as JSON: numpy scalars as Python scalars, arrays
    (a table axis's per-cell value) as lists."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return [_plain(x) for x in v.tolist()]
    return v


def summary_digests(summaries) -> list:
    """NaN-safe digests of summaries (numpy grid values as floats)."""
    return [gd.digest_summary({k: _plain(v) for k, v in s.items()})
            for s in summaries]


def compare_grid(axes, product=True, slo_us=gd.SLO_US, **kw):
    """Sweep both packages over one config (``SimConfig`` kwargs ``kw``,
    the golden-digest horizon unless given); assert every leaf (the pol
    slots included), the grid and every summary are equal.  Returns the
    port's state and summaries."""
    kw.setdefault("sim_time_us", gd.SIM_US)
    cfg, rcfg = sl.SimConfig(**kw), rsl.SimConfig(**kw)
    st, grid = sl.sweep(cfg, axes, slo_us=slo_us, seed=gd.SEED,
                        product=product, device="cpu")
    rst, rgrid = rsl.sweep(rcfg, axes, slo_us=slo_us, seed=gd.SEED,
                           product=product)
    got, want = gd.digest_state(sl.to_reference(st)), gd.digest_state(rst)
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []
    assert sorted(grid) == sorted(rgrid)
    for k in grid:
        np.testing.assert_array_equal(grid[k], rgrid[k])
    summ = sl.sweep_summaries(cfg, st, grid, slo_us=slo_us)
    assert summary_digests(summ) == summary_digests(
        rsl.sweep_summaries(rcfg, rst, rgrid, slo_us=slo_us))
    return st, summ


def compare_sweep(policy, axes, product=True, **kw):
    """Sweep both packages; assert every leaf and summary is equal."""
    return compare_grid(axes, product, policy=policy, **kw)[0]


@pytest.mark.parametrize("policy", ["fifo", "tas", "prop", "libasl"])
def test_sweep_matches_reference(policy):
    st = compare_sweep(policy, dict(gd.SWEEP_AXES))
    assert (st.events > 1000).all()


def test_policy_ids_and_axes_match_reference():
    """All ten policy ids and every sweep axis are the reference's; nothing
    is refused any more."""
    assert sl.POLICIES == rsl.POLICIES
    assert len(sl.POLICIES) == 10
    assert set(sl.SWEEPABLE) == set(rsl.SWEEPABLE)
    assert not [k for k in vars(sl) if k.startswith("_LATER")]
    from repro.core import policies as rpol
    from repro_torch.core import policies as tpol
    for name in sl.POLICIES:
        mine, ref = tpol.get(name), rpol.get(name)
        for attr in ("host_scheduler", "host_dispatch", "uses_rw",
                     "uses_standby", "state_slots", "sweep_axes"):
            assert getattr(mine, attr) == getattr(ref, attr), (name, attr)
    assert set(sl.table_axes()) == set(rsl.table_axes())
    assert list(sl.SimState._fields) == list(rsl.SimState._fields)
    assert list(sl.SimParams._fields) == list(rsl.SimParams._fields)
    assert list(sl.SimTables._fields) == list(rsl.SimTables._fields)


def test_default_device_needs_cuda(monkeypatch):
    """``device=None`` means CUDA; without a card the entry points raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = sl.SimConfig(sim_time_us=100.0)
    for call in (lambda: sl.sweep(cfg, {"seed": [0]}),
                 lambda: sl.run(cfg, gd.SLO_US),
                 lambda: sl.build_tables(cfg),
                 lambda: sl.build_params(cfg, gd.SLO_US)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# Features the port refused until it ran them: they construct now.
PORTED = ("wl", "wl_open", "hist", "preempt_rate", "churn_rate",
          "straggle_rate")
KEYED = ("n_keys", "ks_erew", "ks_crew", "ks_jbsq")
FEATURE_CASES = [
    (dict(wl=True), "wl"),
    (dict(wl_open=True), "wl_open"),
    (dict(wl=True, wl_service="lognormal", long_epoch_prob=0.1), "wl"),
    (dict(hist=True, wakeup_us=2.0), "hist"),
    (dict(preempt_rate=0.1), "preempt_rate"),
    (dict(churn_rate=0.1), "churn_rate"),
    (dict(straggle_rate=0.1), "straggle_rate"),
    (dict(n_keys=16), "n_keys"),
    (dict(hist=True), "hist"),
    (dict(preempt_rate=0.1, p_cs=(1.0,)), "preempt_rate"),
    (dict(policy_set=("fifo", "ks_jbsq")), "ks_jbsq"),
    (dict(policy="ks_erew"), "ks_erew"),
    (dict(policy="ks_crew"), "ks_crew"),
]


@pytest.mark.parametrize("kw, feature", FEATURE_CASES)
def test_unsupported_features_raise(kw, feature):
    """Nothing raises any more: the stochastic workloads, histograms and
    faults construct and turn the kernel's stochastic instantiation on;
    keyed traffic and the ``ks_*`` policies construct, and a short sweep
    of them matches the reference in every leaf."""
    from repro_torch.kernels import simstep
    cfg = sl.SimConfig(**kw)
    if feature in PORTED:
        assert simstep.stochastic(cfg)
        return
    assert feature in KEYED
    compare_grid({"seed": [gd.SEED]}, sim_time_us=300.0, **kw)


@pytest.mark.parametrize("kw, feature", FEATURE_CASES)
def test_feature_gates(kw, feature):
    """Each feature's gates: the stochastic workloads, histograms, faults
    and keyed traffic run the kernel's stochastic instantiation; keyed
    traffic and the ``ks_*`` policies its keyed one."""
    from repro_torch.kernels import simstep
    cfg = sl.SimConfig(**kw)
    assert simstep.stochastic(cfg) == (feature in PORTED
                                       or feature == "n_keys")
    assert simstep.keyed(cfg) == (feature in KEYED)
    assert sl._ks_on(cfg) == (feature == "n_keys")


@pytest.mark.parametrize("axis, values", [
    ("policy", ["fifo", "ks_erew"]),
    ("preempt_rate", [0.1]),
    ("arrival_rate", [0.5]),
    ("n_keys", [4]),
    ("zipf_theta", [0.5]),
    ("straggle_scale", [2.0]),
])
def test_unsupported_axes_raise(axis, values):
    """Every axis sweeps: the workload and fault axes turn their gate on;
    the ``ks_*`` policies and the key-shard axes (an ``n_keys`` axis
    turning the key gate on) match the reference in every leaf, and
    ``zipf_theta`` without the gate raises as the reference does."""
    cfg = sl.SimConfig(sim_time_us=100.0)
    if axis in ("preempt_rate", "arrival_rate", "straggle_scale"):
        swept = sl.sweep_config(cfg, {axis: values})
        assert swept.preempt_rate == 0.1 if axis == "preempt_rate" else \
            swept.wl if axis == "arrival_rate" else swept == cfg
        st, grid = sl.sweep(cfg, {axis: values}, device="cpu")
        assert int(st.events[0]) > 0 and list(grid[axis]) == values
        return
    if axis == "zipf_theta":
        for mod in (sl, rsl):
            with pytest.raises(ValueError, match="key-shard gate"):
                mod.sweep(mod.SimConfig(sim_time_us=100.0), {axis: values})
    keys = {"zipf_theta": 8, "policy": 8}.get(axis, 0)
    if axis == "n_keys":
        assert sl.sweep_config(cfg, {axis: values}).n_keys == 4
    compare_grid({axis: values}, product=True, sim_time_us=300.0,
                 n_keys=keys)


def test_bad_sweeps_raise_like_reference():
    cfg = sl.SimConfig(sim_time_us=100.0)
    with pytest.raises(ValueError, match="unknown sweep axis"):
        sl.sweep(cfg, {"no_such_axis": [1]}, device="cpu")
    with pytest.raises(ValueError, match="empty sweep"):
        sl.sweep(cfg, {}, device="cpu")
    with pytest.raises(ValueError, match="n_cores"):
        sl.sweep(cfg, {"n_cores": [9]}, device="cpu")
    with pytest.raises(ValueError, match="equal-length"):
        sl.sweep(cfg, {"seed": [0, 1], "slo_us": [1.0]}, product=False,
                 device="cpu")
    with pytest.raises(ValueError, match="unknown lock policy"):
        sl.SimConfig(policy="fifoo")
    with pytest.raises(ValueError, match="pct"):
        sl.SimConfig(pct=0.0)
