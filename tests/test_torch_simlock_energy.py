"""The energy model against the JAX package at the golden-digest scale:
``paper_figs.energy_efficiency``'s big:little mix sweep (the ``big``,
speed and power table axes zipped) under each of the seven policies, and
``summarize``'s energy keys.  The compiled reference contracts the
update ``energy + dt * watts`` into one FMA; the port computes the same
single rounding (``simlock.fma_f32``), so the ``energy`` leaf is exact
too.  Tolerance: exact equality, every leaf and summary key."""

import numpy as np
import pytest
import torch

from repro.core import energy as renergy
from repro_torch.core import energy
from repro_torch.core import simlock as sl
from test_torch_simlock import compare_grid

POLICIES = ("fifo", "tas", "prop", "libasl", "edf", "shfl", "dvfs_race")
FIG1_KW = {"tas": dict(w_big=0.15)}
FIG1_SLO = {"libasl": 1e9, "edf": 100.0}


def mix_axes(mixes=(8, 4, 0)) -> dict:
    rows = []
    for n_big in mixes:
        big = (1,) * n_big + (0,) * (8 - n_big)
        rows.append(dict(big=big,
                         speed_cs=tuple(1.0 if b else 3.75 for b in big),
                         speed_nc=tuple(1.0 if b else 1.8 for b in big),
                         **energy.amp_power(big)))
    return {k: [r[k] for r in rows] for k in rows[0]}


@pytest.mark.parametrize("policy", POLICIES)
def test_energy_mix_sweep_matches_reference(policy):
    st, summ = compare_grid(mix_axes(), product=False,
                            slo_us=FIG1_SLO.get(policy, 1e9), policy=policy,
                            **FIG1_KW.get(policy, {}))
    assert (st.energy > 0).all()
    for s in summ:
        assert s["energy_j"] > 0 and np.isfinite(s["tput_per_watt"])
        assert s["power_w"] > 0 and "edp" in s


def test_amp_power_matches_reference():
    big = (1, 0, 1, 0, 0)
    assert energy.amp_power(big) == renergy.amp_power(big)
    assert energy.BIG_W == renergy.BIG_W
    assert energy.LITTLE_W == renergy.LITTLE_W


def test_energy_with_dvfs_and_zero_tables_matches_reference():
    """dvfs cubes into the active and spin draws; an all-zero power
    table turns the integration on and accumulates exact zeros."""
    st, summ = compare_grid(
        {"dvfs": [(1.0,) * 8, (2.0, 1.0, 1.5, 1.0, 0.5, 1.0, 1.0, 0.75)],
         "n_cores": [8, 5]},
        policy="tas", w_big=4.0, **energy.amp_power((1,) * 4 + (0,) * 4))
    # The inactive cores of an n_cores=5 cell all drew the same idle watts.
    assert len(set(st.energy[1, 5:].tolist())) == 1
    st0, summ0 = compare_grid({"n_cores": [8]}, policy="fifo",
                              p_park=(0.0,))
    assert bool((st0.energy == 0).all()) and "power_w" not in summ0[0]


def test_fma_f32_is_one_rounding():
    """``fma_f32`` against products and sums that one f32 rounding and
    two roundings tell apart."""
    g = np.random.default_rng(0)
    a = g.uniform(0, 2e4, 20000).astype(np.float32)
    b = g.uniform(0, 5, 20000).astype(np.float32)
    c = g.uniform(0, 1e7, 20000).astype(np.float32)
    got = sl.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    from fractions import Fraction
    want = np.asarray([np.float32(float(Fraction(float(x)) * Fraction(
        float(y)) + Fraction(float(z)))) for x, y, z in zip(a, b, c)],
        np.float32)
    np.testing.assert_array_equal(got, want)
    assert (got != a * b + c).any()          # two roundings differ
