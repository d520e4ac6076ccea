"""The port's sweep accounting: ``sweep_log`` (one record per ``sweep``
call, bounded at ``MAX_SWEEP_LOG``), ``executable_records`` and
``n_batch_executables`` over fig1's registered policies (the reference's
perf protocol: one executable each, a repeated sweep none), the bytes a
launch moves counted once (``simstep.launch_bytes``).  fig1's grids run
1,000 us: what loads an executable is the config and the shapes, not
the horizon."""

import pytest
import torch

from repro_torch.core import simlock as sl
from repro_torch.core.policies import REGISTRY
from repro_torch.kernels import simstep
from test_torch_simlock_resume import FIG1

FIG1_KW = {"tas": dict(w_big=0.15)}          # paper_figs' fig1 settings
FIG1_SLO = {"libasl": 1e9, "edf": 100.0}


def _fig1(policy):
    cfg = sl.SimConfig(**FIG1, policy=policy, sim_time_us=1000.0,
                       **FIG1_KW.get(policy, {}))
    return sl.sweep(cfg, {"n_cores": list(range(1, 9))},
                    slo_us=FIG1_SLO.get(policy, 1e9), device="cpu")[0]


def test_fig1_policies_load_one_executable_each():
    assert len(REGISTRY) == 10
    for policy in REGISTRY:
        n0, k0 = sl.n_batch_executables(), len(sl.sweep_log())
        st = _fig1(policy)
        assert sl.n_batch_executables() == n0 + 1, policy
        rec = sl.sweep_log()[k0]
        assert rec is sl.executable_records()[-1]
        keyed = policy.startswith("ks_")
        assert rec["instantiation"] == policy + (" keyed" if keyed else "")
        assert rec["n_cells"] == 8 and rec["devices"] == 1
        assert rec["events"] == int(st.events.sum()) > 0
        assert rec["launches"] >= -(-int(st.events.max()) // 128)
        assert rec["launch_bytes"] > 0
    # The same grid again runs a loaded executable: a record, no load.
    n0, k0 = sl.n_batch_executables(), len(sl.sweep_log())
    _fig1("libasl")
    assert sl.n_batch_executables() == n0
    assert len(sl.sweep_log()) == k0 + 1


def test_launch_bytes_counts_each_cell_once():
    """From the initial state (``before=None``) as from an explicit copy
    of it, and the sum of the per-cell reads and writes by hand."""
    cfg = sl.SimConfig(**FIG1, policy="fifo", sim_time_us=200.0)
    tb, pm, st, _ = sl.init_sweep(cfg, {"n_cores": [2, 8]}, device="cpu")
    before = sl.SimState(**{k: {n: x.clone() for n, x in v.items()}
                            if k == "pol" else v.clone()
                            for k, v in st._asdict().items()})
    sl.simulate(cfg, tb, pm, st)
    n = simstep.launch_bytes(tb, pm, None, st, cfg, 4)
    assert n == simstep.launch_bytes(tb, pm, before, st, cfg, 4)
    ts, _ = simstep._operands(tb, pm, st, cfg)
    state = set(sl.SimState._fields) - {"scale"}
    per_cell = sum((2 if k in state else 1) * x[0].numel() * 4 if k != "key"
                   else 2 * 16 for k, x in ts.items()
                   if k not in ("ep_lat", "cs_lat", "ep_hist", "cs_hist"))
    samples = int(st.ep_cnt.sum() + st.cs_cnt.sum())
    assert n == 2 * per_cell + 4 * samples / 4


def test_sweep_log_is_bounded(monkeypatch):
    monkeypatch.setattr(sl, "MAX_SWEEP_LOG", 3)
    monkeypatch.setattr(sl, "_SWEEP_LOG", [])
    cfg = sl.SimConfig(policy="fifo", sim_time_us=50.0)
    for n in range(1, 6):
        sl.sweep(cfg, {"seed": list(range(n))}, device="cpu")
        assert len(sl.sweep_log()) == min(n, 3)
    assert [r["n_cells"] for r in sl.sweep_log()] == [3, 4, 5]
    assert all(isinstance(r["events"], int) for r in sl.sweep_log())


def test_split_and_resumed_sweeps_are_recorded(tmp_path):
    cfg = sl.SimConfig(policy="fifo", sim_time_us=50.0)
    k0 = len(sl.sweep_log())
    st, _ = sl.sweep(cfg, {"seed": [0, 1, 2]}, devices=["cpu"] * 2)
    sl.sweep(cfg, {"seed": [0, 1, 2]}, device="cpu", resume_dir=tmp_path,
             resume_chunk=2)
    log = sl.sweep_log()[k0:]
    assert [(r["n_cells"], r["devices"]) for r in log] == \
        [(4, 2), (2, 1), (1, 1)]
    assert log[0]["events"] == int(st.events.sum()) + int(st.events[-1])
    assert torch.equal(st.events, _unsplit(cfg))


def _unsplit(cfg):
    return sl.sweep(cfg, {"seed": [0, 1, 2]}, device="cpu")[0].events


@pytest.mark.parametrize("name,want", [
    (dict(policy="libasl"), "libasl"),
    (dict(policy_set=("fifo", "libasl")), "merged"),
    (dict(policy="tas", wl=True), "tas stochastic"),
    (dict(policy="fifo", n_keys=64, n_locks=4), "fifo stochastic keyed"),
    (dict(policy="ks_crew"), "ks_crew keyed")])
def test_instantiation_names(name, want):
    assert simstep.instantiation_name(sl.SimConfig(**name)) == want
