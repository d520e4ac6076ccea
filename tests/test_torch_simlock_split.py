"""The port's split sweep (``sweep(devices=...)``, the counterpart of the
reference's ``mesh=`` / ``data_axis=``) and ``row_splits``: the cells
padded to a multiple of the split count by repeating the last cell, a
contiguous block a device, gathered and trimmed.  Held on ``cpu`` in 1-4
splits against the unsplit sweep and the JAX package's unsharded sweep,
leaf for leaf, at the golden-digest scale.  Tolerance: exact equality."""

import functools

import pytest

import golden_digests as gd
from repro.core import simlock as rsl
from repro.dist import sharding as rsh
from repro_torch.core import simlock as sl
from repro_torch.dist import sharding as tsh

# Five cells, so every split but 1 and 5 pads: 2 -> 6, 3 -> 6, 4 -> 8.
AXES = {"n_cores": [8, 6, 8, 7, 8], "seed": [0, 1, 2, 3, 4],
        "w_big": [0.15, 1.0, 4.0, 8.0, 0.5]}


@pytest.mark.parametrize("rows,shards", [(0, 1), (8, 1), (8, 2), (8, 4),
                                         (6, 3), (1024, 8), (5, 5)])
def test_row_splits_match_reference(rows, shards):
    assert tsh.row_splits(rows, shards) == rsh.row_splits(rows, shards)


@pytest.mark.parametrize("rows,shards", [(5, 2), (7, 4), (8, 0), (8, -2),
                                         (3, 6)])
def test_row_splits_refuse_what_does_not_tile(rows, shards):
    with pytest.raises(ValueError) as want:
        rsh.row_splits(rows, shards)
    with pytest.raises(ValueError) as got:
        tsh.row_splits(rows, shards)
    assert str(got.value) == str(want.value)


@functools.lru_cache(maxsize=None)
def _unsplit():
    cfg = sl.SimConfig(policy="tas", sim_time_us=gd.SIM_US)
    st, _ = sl.sweep(cfg, AXES, slo_us=gd.SLO_US, product=False,
                     device="cpu")
    return gd.digest_state(sl.to_reference(st))


def test_unsplit_sweep_matches_reference():
    rcfg = rsl.SimConfig(policy="tas", sim_time_us=gd.SIM_US)
    rst, _ = rsl.sweep(rcfg, AXES, slo_us=gd.SLO_US, product=False)
    assert _unsplit() == gd.digest_state(rst)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_split_sweep_is_bit_identical(splits):
    cfg = sl.SimConfig(policy="tas", sim_time_us=gd.SIM_US)
    n0 = len(sl.sweep_log())
    st, grid = sl.sweep(cfg, AXES, slo_us=gd.SLO_US, product=False,
                        devices=["cpu"] * splits)
    assert st.t.shape == (5,) and len(grid["seed"]) == 5
    assert gd.digest_state(sl.to_reference(st)) == _unsplit()
    rec = sl.sweep_log()[n0]
    assert rec["devices"] == splits
    assert rec["n_cells"] == 5 + (-5) % splits      # padded, as sharded


def test_split_does_not_compose_with_resume(tmp_path):
    cfg = sl.SimConfig(policy="fifo", sim_time_us=100.0)
    with pytest.raises(ValueError, match="resume_dir"):
        sl.sweep(cfg, {"seed": [0, 1]}, devices=["cpu"] * 2,
                 resume_dir=tmp_path)
    with pytest.raises(ValueError, match="resume_dir"):
        rsl.sweep(rsl.SimConfig(policy="fifo", sim_time_us=100.0),
                  {"seed": [0, 1]}, mesh=object(), resume_dir=tmp_path)
    with pytest.raises(ValueError, match="at least one device"):
        sl.sweep(cfg, {"seed": [0, 1]}, devices=[])
