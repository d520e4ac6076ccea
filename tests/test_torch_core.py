"""The port's leaf modules against the JAX package on the same inputs
(made with a seeded numpy generator): the AIMD window, the percentile
helper, the weighted pick on the simulator's weight sets, the column
registry and ``build_tables`` / ``build_params``.  Tolerance: exact
equality (bit for bit on f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aimd as ref_aimd
from repro.core import columns as ref_columns
from repro.core import simlock as rsl
from repro.core import stats as ref_stats
from repro.core.policies import base as ref_base
from repro.workloads import keys as ref_keys
from repro_torch.core import aimd, stats
from repro_torch.core import columns
from repro_torch.core import simlock as sl
from repro_torch.core.policies import base
from repro_torch.workloads import keys

RNG = np.random.default_rng(1107)


def _bits(x) -> bytes:
    return np.asarray(x, np.float32).tobytes()


@pytest.mark.parametrize("pct", [99.0, 95.0, 99.9])
def test_aimd_update_matches_reference(pct):
    """Against the reference compiled, as its simulator runs it (XLA
    turns the division by 100 into a multiply by a folded constant)."""
    n = 4096
    window = RNG.uniform(0, 2e5, n).astype(np.float32)
    unit = RNG.uniform(0, 2e3, n).astype(np.float32)
    latency = RNG.uniform(0, 4e4, n).astype(np.float32)
    slo = RNG.uniform(0, 4e4, n).astype(np.float32)
    for max_window in (1e7, 1e5):
        w_ref, u_ref = jax.jit(lambda *a: ref_aimd.aimd_update(
            *a, pct=pct, max_window=max_window))(window, unit, latency, slo)
        w, u = aimd.aimd_update(
            torch.from_numpy(window), torch.from_numpy(unit),
            torch.from_numpy(latency), torch.from_numpy(slo), pct=pct,
            max_window=max_window)
        assert _bits(w) == _bits(w_ref)
        assert _bits(u) == _bits(u_ref)


def test_unit_for_matches_reference():
    w = RNG.uniform(0, 1e6, 2048).astype(np.float32)
    for pct in (99.0, 90.0, 99.9):
        got = aimd.unit_for(torch.from_numpy(w), pct)
        want = jax.jit(lambda x: ref_aimd.unit_for(x, pct))(w)
        assert _bits(got) == _bits(want)
        assert aimd.unit_for(1000.0, pct) == ref_aimd.unit_for(1000.0, pct)


def test_aimd_window_host_form_matches_reference():
    a, b = aimd.AIMDWindow(), ref_aimd.AIMDWindow()
    for lat, slo in RNG.uniform(0, 3000, (500, 2)):
        assert a.update(lat, slo) == b.update(lat, slo)
    assert (a.window, a.unit) == (b.window, b.unit)


def test_percentile_matches_reference():
    for n in (0, 1, 7, 1000):
        v = RNG.exponential(50.0, n)
        for q in (50, 99, 99.9, [50, 99]):
            got, want = stats.percentile(v, q), ref_stats.percentile(v, q)
            np.testing.assert_array_equal(got, want)
    assert stats.layout(10.0, 1e8, 512) == ref_stats.layout(10.0, 1e8, 512)


@pytest.mark.parametrize("w_big", [0.15, 1.0, 2.5, 8.0])
def test_weighted_pick_on_the_simulator_weight_sets(w_big):
    """The tas / libasl pick: 8-core weights drawn from {0, 1, w_big}
    (spinning big cores weigh w_big, little ones 1, the rest 0), one
    fresh key each — the left-to-right prefix sum must round like
    ``jnp.cumsum``."""
    n_sets = 500
    choice = RNG.integers(0, 3, size=(n_sets, 8))
    weights = np.where(choice == 0, 0.0,
                       np.where(choice == 1, 1.0, w_big)).astype(np.float32)
    words = RNG.integers(0, 2**32, size=(n_sets, 2), dtype=np.int64)
    pick_ref, any_ref = jax.vmap(ref_base.weighted_pick)(
        jnp.asarray(words.astype(np.uint32)), jnp.asarray(weights))
    pick, anyw = base.weighted_pick(torch.from_numpy(words),
                                    torch.from_numpy(weights))
    np.testing.assert_array_equal(pick.numpy(), np.asarray(pick_ref))
    np.testing.assert_array_equal(anyw.numpy(), np.asarray(any_ref))


def test_weighted_pick_standby_masks():
    """libasl's pick: 0/1 standby masks over 1..32 cores."""
    for n in (1, 4, 8, 16, 32):
        mask = (RNG.random((200, n)) < 0.4).astype(np.float32)
        words = RNG.integers(0, 2**32, size=(200, 2), dtype=np.int64)
        pick_ref, any_ref = jax.vmap(ref_base.weighted_pick)(
            jnp.asarray(words.astype(np.uint32)), jnp.asarray(mask))
        pick, anyw = base.weighted_pick(torch.from_numpy(words),
                                        torch.from_numpy(mask))
        np.testing.assert_array_equal(pick.numpy(), np.asarray(pick_ref))
        np.testing.assert_array_equal(anyw.numpy(), np.asarray(any_ref))


def test_ticks_rounds_half_to_even_like_reference():
    for us in (0.005, 0.015, 0.025, 3.0 * 3.75, 1.0 * 1.8, 5.0 * 1.8, 1e9):
        assert base.ticks(us) == ref_base.ticks(us)


def test_column_registry_matches_reference():
    assert {k: (v.dtype, v.default, v.field, v.sweepable)
            for k, v in columns.COLUMNS.items()} == \
        {k: (v.dtype, v.default, v.field, v.sweepable)
         for k, v in ref_columns.COLUMNS.items()}


def test_zipf_consts_match_reference():
    for n, theta in ((1, 0.99), (2, 0.5), (100, 0.99), (1000, 1.0),
                     (50, 1.2)):
        assert keys.zipf_consts(n, theta) == ref_keys.zipf_consts(n, theta)


BENCH1 = dict(seg_noncrit_us=(1.0, 0.5, 0.5, 0.5),
              seg_cs_us=(2.0, 1.0, 3.0, 0.5), seg_lock=(0, 1, 0, 1),
              n_locks=2, inter_epoch_us=7.5)
CONFIGS = {
    "default": {},
    "bench1": BENCH1,
    "columns": dict(slo_scale=(1.0, 2.0, 0.5), dvfs=(1.0, 1.5, 0.7, 2.0),
                    fault_mask=(1, 0), seg_cs_us=(3.3,),
                    default_window_us=12.345, sim_time_us=1234.5),
    "six_cores": dict(n_cores=6, big=(1, 1, 0, 0, 0, 0, 1, 1), pct=95.0),
}


def _leaves_equal(port, ref):
    pd, rd = port._asdict(), ref._asdict()
    assert list(pd) == list(rd)
    for k, v in rd.items():
        if isinstance(v, dict):
            assert sorted(pd[k]) == sorted(v), k
            pairs = [(f"{k}.{c}", pd[k][c], v[c]) for c in v]
        else:
            pairs = [(k, pd[k], v)]
        for name, a, b in pairs:
            b = np.asarray(b)
            a = a.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_tables_and_params_match_reference(name):
    for policy in ("fifo", "tas", "prop", "libasl"):
        kw = CONFIGS[name]
        cfg = sl.SimConfig(policy=policy, **kw)
        rcfg = rsl.SimConfig(policy=policy, **kw)
        _leaves_equal(sl.build_tables(cfg, device="cpu"),
                      rsl.build_tables(rcfg))
        for slo, seed in ((80.0, 3), (np.float64(123.456), -5), (1e9, 0)):
            _leaves_equal(sl.build_params(cfg, slo, seed, device="cpu"),
                          rsl.build_params(rcfg, slo, seed))
