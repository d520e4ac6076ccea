"""Table axes against the JAX package at the golden-digest scale: the
program axes (``seg_noncrit_us`` x ``n_cores``, as Bench-5 sweeps it, and
the others) and the registered column axes, each cell's tables rebuilt
from its values; and the column helpers ``table_columns`` /
``with_columns``.  Tolerance: exact equality."""

import numpy as np
import pytest

from repro.core import simlock as rsl
from repro_torch.core import simlock as sl
from test_torch_simlock import compare_grid

NC_AX = [(0.5,), (2.0,), (16.0,)]


@pytest.mark.parametrize("policy", ["fifo", "tas", "libasl"])
def test_seg_noncrit_by_n_cores_matches_reference(policy):
    """Bench-5's grid shape (``paper_figs.bench5_contention``)."""
    st, _ = compare_grid({"seg_noncrit_us": NC_AX, "n_cores": [8, 4]},
                         policy=policy, seg_cs_us=(2.0,), inter_epoch_us=0.5,
                         w_big=8.0 if policy == "tas" else 1.0)
    assert (st.events > 100).all()


def test_program_axes_zipped_match_reference():
    """Every program axis at once, zipped: the segment program, the lock
    map, the pacing, the big bits and both speed tables."""
    big = [(1, 1, 0, 0, 0, 0, 0, 0), (1, 1, 1, 1, 1, 1, 0, 0)]
    compare_grid({
        "seg_noncrit_us": [(1.0, 0.5), (0.25, 2.0)],
        "seg_cs_us": [(2.0, 1.0), (0.5, 3.0)],
        "seg_lock": [(0, 1), (1, 1)],
        "inter_epoch_us": [7.5, 1.0],
        "big": big,
        "speed_cs": [tuple(1.0 if b else 3.75 for b in x) for x in big],
        "speed_nc": [tuple(1.0 if b else 1.8 for b in x) for x in big]},
        product=False, policy="prop", seg_noncrit_us=(1.0, 0.5),
        seg_cs_us=(2.0, 1.0), seg_lock=(0, 1), n_locks=2)


@pytest.mark.parametrize("policy, axis, values", [
    ("libasl", "slo_scale", [(1.0,) * 4 + (2.5,) * 4, (0.5,) * 8]),
    ("edf", "slo_scale", [(1.0,) * 4 + (0.25,) * 4]),
    ("dvfs_race", "dvfs", [(1.0,) * 8, (2.0, 1.0, 1.0, 1.0, 1.5, 1.0, 0.5,
                                        1.0)]),
    ("dvfs_race", "race_w", [(1.0,) * 8, (0.0, 1.0, 2.0, 1.0, 3.0, 1.0,
                                          1.0, 0.0)]),
])
def test_column_axes_match_reference(policy, axis, values):
    compare_grid({axis: values, "n_cores": [8, 6]}, policy=policy)


def test_column_helpers_match_reference():
    kw = dict(slo_scale=(2.0, 1.0), race_w=(0.5,), dvfs=(1.0, 1.25),
              p_cs=(3.0,))
    cfg = sl.with_columns(sl.SimConfig(), **kw)
    rcfg = rsl.with_columns(rsl.SimConfig(), **kw)
    assert cfg.columns == rcfg.columns and cfg.dvfs == rcfg.dvfs
    got, want = sl.table_columns(cfg), rsl.table_columns(rcfg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    with pytest.raises(ValueError, match="did you mean 'race_w'"):
        sl.with_columns(sl.SimConfig(), race_ww=(1.0,))


def test_init_sweep_needs_the_sweep_config():
    """``init_sweep`` takes the config ``sweep_config`` derives, which
    ``simulate`` then runs under; another raises."""
    cfg = sl.SimConfig(sim_time_us=100.0)
    for axes in ({"policy": ["fifo", "tas"]}, {"wakeup_us": [1.0]},
                 {"p_cs": [(1.0,) * 8]}):
        with pytest.raises(ValueError, match="sweep_config"):
            sl.init_sweep(cfg, axes, device="cpu")
        scfg = sl.sweep_config(cfg, axes)
        tb, pm, st, _ = sl.init_sweep(scfg, axes, device="cpu")
        sl.simulate(scfg, tb, pm, st)
        assert int(st.events.min()) > 0
