"""The port's ``fused_chunk`` (its plain version, on CPU tensors) against
the JAX package's Pallas ``fused_chunk`` run as ``tests/test_fused.py``
runs it (interpret mode): the same mid-run state, carried into the port
with ``from_reference``, advanced by 128 events on both sides, must agree
in every leaf.  Tolerance: exact equality.  The CUDA kernel itself is held
against this plain version on the card by ``chip_smoke.py``."""

import functools

import jax
import numpy as np
import pytest
import torch

import golden_digests as gd
from repro.core import simlock as rsl
from repro.kernels import simstep as ref_simstep
from repro_torch.core import simlock as sl
from repro_torch.kernels import simstep

BENCH1 = dict(seg_noncrit_us=(1.0, 0.5, 0.5, 0.5),
              seg_cs_us=(2.0, 1.0, 3.0, 0.5), seg_lock=(0, 1, 0, 1),
              n_locks=2, inter_epoch_us=7.5)


def _ref_start(policy, program="fig1"):
    return ref_start(policy=policy,
                     **(BENCH1 if program == "bench1" else {}))


@functools.lru_cache(maxsize=None)
def ref_start(**kw):
    """JAX tables, params and a state 256 events into a run of the config
    ``kw``, and the jitted Pallas chunk (cached: each compile takes
    seconds)."""
    cfg = rsl.SimConfig(sim_time_us=gd.SIM_US, use_pallas=True, **kw)
    ccfg = rsl._canon(cfg)
    tb = rsl.build_tables(cfg)
    pm = rsl.build_params(cfg, gd.SLO_US, gd.SEED)
    st = rsl._init_state(ccfg, tb, pm, rsl._default_windows(cfg))
    chunk = jax.jit(lambda t, p, s: ref_simstep.fused_chunk(
        lambda t_, p_, s_: rsl._step(ccfg, t_, p_, p_.horizon, s_, True),
        t, p, s, 128, interpret=True))
    st = chunk(tb, pm, chunk(tb, pm, st))
    return cfg, tb, pm, st, chunk


def _assert_same(port_st, ref_st, ctx):
    got = sl.to_reference(port_st)
    assert sorted(got.pol) == sorted(ref_st.pol), ctx
    for name, want in ref_st._asdict().items():
        pairs = ([(got.pol[k][0], want[k]) for k in want] if name == "pol"
                 else [(getattr(got, name)[0], want)])
        for a, w in pairs:
            w = np.asarray(w)
            assert a.dtype == w.dtype and a.shape == w.shape, (ctx, name)
            assert a.tobytes() == w.tobytes(), (ctx, name)


def check_config(**kw):
    """128 events of the Pallas kernel and of the port's ``fused_chunk``
    from the same mid-run state of the config ``kw``: every leaf."""
    cfg, tb, pm, st, chunk = ref_start(**kw)
    want = chunk(tb, pm, st)
    ptb, ppm, pst = sl.from_reference(tb, pm, st, device="cpu")
    n0 = simstep.fused_chunk.launches
    scfg = sl.SimConfig(sim_time_us=gd.SIM_US, **kw)
    out = simstep.fused_chunk(ptb, ppm, pst, 128, scfg)
    assert out is pst                      # updated in place
    assert simstep.fused_chunk.launches == n0   # CPU: no kernel launch
    assert int(pst.events[0]) == int(want.events) > 256
    _assert_same(pst, want, kw)


def check_against_pallas(policy, program):
    check_config(policy=policy, **(BENCH1 if program == "bench1" else {}))


@pytest.mark.parametrize("policy", ["fifo", "tas", "prop", "libasl"])
def test_fused_chunk_matches_pallas_kernel(policy):
    check_against_pallas(policy, "fig1")


def test_fused_chunk_past_the_horizon_is_a_no_op():
    _, tb, pm, st, _ = _ref_start("fifo")
    ptb, ppm, pst = sl.from_reference(tb, pm, st, device="cpu")
    ppm = ppm._replace(horizon=torch.zeros_like(ppm.horizon))
    before = sl.to_reference(pst)
    simstep.fused_chunk(ptb, ppm, pst, 16, sl.SimConfig())
    after = sl.to_reference(pst)
    for name in before._fields:
        if name != "pol":
            np.testing.assert_array_equal(getattr(before, name),
                                          getattr(after, name), name)


def test_fused_chunk_checks_its_operands():
    _, tb, pm, st, _ = _ref_start("fifo")
    cfg = sl.SimConfig()
    ptb, ppm, pst = sl.from_reference(tb, pm, st, device="cpu")
    with pytest.raises(TypeError, match="window"):
        simstep.fused_chunk(ptb, ppm, pst._replace(
            window=pst.window.double()), 1, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        simstep.fused_chunk(ptb, ppm, pst._replace(
            ep_lat=pst.ep_lat.transpose(1, 2).contiguous().transpose(1, 2)),
            1, cfg)
    with pytest.raises(ValueError, match="shape"):
        simstep.fused_chunk(ptb, ppm, pst._replace(
            holder=pst.holder[:, :0]), 1, cfg)
    with pytest.raises(ValueError, match="meta"):
        simstep.fused_chunk(ptb, ppm, pst._replace(
            t=pst.t.to("meta")), 1, cfg)


def test_carry_round_trip_is_exact():
    """from_reference -> to_reference gives back the reference's leaves
    (names, shapes, dtypes, bytes), with and without a cell axis."""
    _, tb, pm, st, _ = _ref_start("libasl")
    _, _, pst = sl.from_reference(tb, pm, st, device="cpu")
    _assert_same(pst, st, "single")
    batched = jax.tree.map(lambda x: np.stack([x, x]), (tb, pm, st))
    _, _, pst2 = sl.from_reference(*batched, device="cpu")
    back = sl.to_reference(pst2)
    assert gd.digest_state(back) == gd.digest_state(
        jax.tree.map(np.asarray, batched[2]))
